"""Scenario reports, per-cell metrics and JSON artifacts: the port's own
copy of ``repro.experiments.report``, with the token model's and
migration's fields of a token cell (``None``, and left out of the
artifact, for a request cell) and each cell's observability: its registry
snapshot, event counts, window samples, SLO burn summary and span count,
and the suite's merged snapshot.

Artifact schema (``schema: 1``), as the reference's::

    {"schema": 1, "suite": "...", "engine": "jax", "workers": 1,
     "wall_s": 1.2, "n_cells": 12,
     "cells": [{"policy": "spothedge", "trace": "aws-1",
                "workload": "poisson", "seed": 3, "n_requests": 4287, ...,
                "p50_s": 0.7, "p90_s": 1.1, "p99_s": 1.7, ...}, ...]}
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

from repro_torch.serving.result import ServingResult

__all__ = ["CellResult", "SCHEMA_VERSION", "ScenarioReport"]

SCHEMA_VERSION = 1


def _finite(v: float) -> Optional[float]:
    return float(v) if np.isfinite(v) else None


@dataclasses.dataclass
class CellResult:
    """One scenario's labels and headline metrics."""

    labels: Dict[str, Any]           # axis -> value (policy, trace, ...)
    n_requests: int
    n_completed: int
    n_failed: int
    failure_rate: float
    mean_s: float
    p50_s: float
    p90_s: float
    p99_s: float
    total_cost: float
    cost_vs_ondemand: float
    availability: float
    n_preemptions: int
    n_launch_failures: int
    wall_s: float
    # token-level metrics: token cells only
    ttft_p50_s: Optional[float] = None
    ttft_p99_s: Optional[float] = None
    tpot_p50_s: Optional[float] = None
    tpot_p99_s: Optional[float] = None
    goodput_rps: Optional[float] = None
    slo_attainment: Optional[float] = None
    # grace-period migration: token cells only, zero with migration off
    n_drained_seqs: Optional[int] = None
    n_migrated_seqs: Optional[int] = None
    migrated_kv_tokens: Optional[int] = None
    saved_prefill_tokens: Optional[int] = None
    n_retried_requests: Optional[int] = None
    lost_kv_tokens: Optional[int] = None
    # observability: picklable snapshots, left out when the cell ran at
    # detail "off" (or recorded nothing); the window samples, the burn
    # summary and the span count exist at detail "full" only
    metrics: Optional[Dict[str, Any]] = None
    obs_event_counts: Optional[Dict[str, int]] = None
    obs_windows: Optional[List[Dict[str, Any]]] = None
    slo_burn: Optional[Dict[str, Any]] = None
    n_spans: Optional[int] = None

    @staticmethod
    def from_result(labels: Mapping[str, Any], res: ServingResult,
                    wall_s: float) -> "CellResult":
        lat = res.latencies_s
        tok = res.token
        obs = res.obs
        return CellResult(
            labels=dict(labels),
            n_requests=res.n_requests,
            n_completed=res.n_completed,
            n_failed=res.n_failed,
            failure_rate=res.failure_rate,
            mean_s=float(lat.mean()) if len(lat) else float("nan"),
            p50_s=res.pct(50),
            p90_s=res.pct(90),
            p99_s=res.pct(99),
            total_cost=res.total_cost,
            cost_vs_ondemand=res.cost_vs_ondemand,
            availability=res.availability,
            n_preemptions=res.n_preemptions,
            n_launch_failures=res.n_launch_failures,
            wall_s=wall_s,
            # a token cell with no completion has NaN percentiles: None, so
            # the JSON artifact stays strict
            ttft_p50_s=_finite(tok.ttft_pct(50)) if tok else None,
            ttft_p99_s=_finite(tok.ttft_pct(99)) if tok else None,
            tpot_p50_s=_finite(tok.tpot_pct(50)) if tok else None,
            tpot_p99_s=_finite(tok.tpot_pct(99)) if tok else None,
            goodput_rps=tok.goodput_rps if tok else None,
            slo_attainment=tok.slo_attainment if tok else None,
            n_drained_seqs=tok.n_drained_seqs if tok else None,
            n_migrated_seqs=tok.n_migrated_seqs if tok else None,
            migrated_kv_tokens=tok.migrated_kv_tokens if tok else None,
            saved_prefill_tokens=tok.saved_prefill_tokens if tok else None,
            n_retried_requests=res.n_retried_requests if tok else None,
            lost_kv_tokens=res.lost_kv_tokens if tok else None,
            metrics=res.metrics,
            obs_event_counts=obs.event_counts() if obs is not None else None,
            obs_windows=(obs.window_records() or None
                         if obs is not None else None),
            slo_burn=obs.slo_burn_summary() if obs is not None else None,
            n_spans=(len(obs.span_records()) or None
                     if obs is not None else None),
        )

    @property
    def cell_id(self) -> str:
        return "/".join(str(v) for v in self.labels.values())

    def to_dict(self, round_to: Optional[int] = 6) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self.labels)
        for f in dataclasses.fields(self):
            if f.name == "labels":
                continue
            v = getattr(self, f.name)
            if v is None:
                continue
            if round_to is not None and isinstance(v, float) and np.isfinite(v):
                v = round(v, round_to)
            out[f.name] = v
        return out


@dataclasses.dataclass
class ScenarioReport:
    """All cell results of one suite run, JSON-serialisable."""

    suite: str
    engine: str
    workers: int
    cells: List[CellResult]
    wall_s: float
    # the matrix path's (engine jax) phase-B shape groups, one launch each,
    # the cells whose lane overflowed and was rerun on the oracle, and the
    # token cells, which have no phase B and ran on the host engine
    shape_groups: Optional[int] = None
    oracle_reruns: List[str] = dataclasses.field(default_factory=list)
    host_token_cells: List[str] = dataclasses.field(default_factory=list)
    # every cell's registry snapshot merged (None when no cell recorded any)
    metrics: Optional[Dict[str, Any]] = None

    def __len__(self) -> int:
        return len(self.cells)

    def select(self, **labels: Any) -> List[CellResult]:
        """Cells whose labels match every given ``axis=value``."""
        return [c for c in self.cells
                if all(c.labels.get(k) == v for k, v in labels.items())]

    def burn_ranking(self) -> List[CellResult]:
        """The cells with a burn summary, the worst error-budget burn first
        (minutes alerting, then alert windows); cells below detail ``full``
        have none and are left out."""
        burned = [c for c in self.cells if c.slo_burn]
        return sorted(burned, key=lambda c: (
            -float(c.slo_burn.get("alert_minutes", 0.0)),
            -int(c.slo_burn.get("alert_windows", 0))))

    def to_dict(self) -> Dict[str, Any]:
        out = {
            "schema": SCHEMA_VERSION,
            "suite": self.suite,
            "engine": self.engine,
            "workers": self.workers,
            "wall_s": round(self.wall_s, 3),
            "n_cells": len(self.cells),
            "cells": [c.to_dict() for c in self.cells],
        }
        if self.shape_groups is not None:
            out["shape_groups"] = self.shape_groups
            out["oracle_reruns"] = list(self.oracle_reruns)
            out["host_token_cells"] = list(self.host_token_cells)
        if self.metrics is not None:
            out["metrics"] = self.metrics
        return out

    def save(self, directory: str = os.path.join("artifacts", "bench"),
             stem: Optional[str] = None) -> str:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"{stem or 'scenario_' + self.suite}.json")
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, default=str)
        return path

    def summary(self) -> str:
        lines = [f"suite {self.suite}: {len(self.cells)} cells, "
                 f"engine={self.engine}, workers={self.workers}, "
                 f"wall={self.wall_s:.1f}s"]
        for c in self.cells:
            lines.append(
                f"  {c.cell_id:<44s} p50={c.p50_s:7.2f}s "
                f"p99={c.p99_s:8.2f}s fail={c.failure_rate:7.2%} "
                f"cost={c.cost_vs_ondemand:6.2%} "
                f"avail={c.availability:.2%} [{c.wall_s:.2f}s]")
        if self.shape_groups is not None:
            lines.append(f"  phase B: {self.shape_groups} shape group(s); "
                         f"{len(self.oracle_reruns)} lane(s) rerun on the "
                         f"oracle {self.oracle_reruns}; "
                         f"{len(self.host_token_cells)} token cell(s) on the "
                         f"host engine")
        burned = self.burn_ranking()
        if burned:
            lines.append("  SLO burn (worst first):")
            for c in burned:
                b = c.slo_burn
                lines.append(f"    {c.cell_id:<42s} "
                             f"alert={b['alert_minutes']:6.1f}min "
                             f"({b['alert_windows']}/{b['windows']} windows)")
        return "\n".join(lines)
