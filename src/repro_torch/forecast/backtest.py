"""Backtest a forecaster against a spot trace: the port's own copy of
``repro.forecast.backtest``.

The harness replays a ``SpotTrace`` step by step: at each step the
forecaster observes the realized availability row, then (past a warmup)
predicts every zone's availability and preemption risk at each horizon.
Predictions are scored against what the trace did: the Brier score of
``p_available`` and of ``p_preempt``, the hit rate of the thresholded call,
and a calibration curve.  Reports serialise to the reference's versioned
JSON (``schema: 1``), one file per (trace, forecaster).  CLI::

    PYTHONPATH=src python -m repro_torch.forecast.backtest \
        --trace aws-1 --forecasters persistence ewma markov

writes ``chiprun_out/forecast/backtest_<trace>_<forecaster>.json`` under
the working directory (``--out-dir`` to change it).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.cluster.traces import SpotTrace, load_trace
from repro_torch.forecast.base import (
    Forecaster,
    make_forecaster,
    registered_forecasters,
)

__all__ = [
    "HorizonScore",
    "BacktestReport",
    "run_backtest",
    "main",
]

SCHEMA_VERSION = 1
#: where the CLI writes its reports unless told otherwise
ART_DIR = os.path.join("chiprun_out", "forecast")

#: horizons scored by default, in trace steps (5 min / 15 min / 30 min at
#: the usual dt=60s) — the range over which a controller can actually act
#: (a cold start is ~3 min, so sub-5-minute forecasts change nothing)
DEFAULT_HORIZONS = (5, 15, 30)


@dataclasses.dataclass
class HorizonScore:
    """All metrics of one forecast horizon."""

    steps: int
    seconds: float
    n: int                         # scored (step, zone) pairs
    brier_avail: float             # MSE of p_available vs realized up
    brier_preempt: float           # MSE of p_preempt vs realized event
    hit_rate: float                # accuracy of p_available >= 0.5 call
    base_rate: float               # realized availability frequency
    calibration: List[Dict[str, float]]   # [{p_mean, freq, n}, ...]

    def to_dict(self) -> Dict[str, Any]:
        out = dataclasses.asdict(self)
        for k in ("brier_avail", "brier_preempt", "hit_rate", "base_rate"):
            out[k] = round(out[k], 6)
        return out


@dataclasses.dataclass
class BacktestReport:
    """One forecaster's scores over one trace, JSON-serializable."""

    trace: str
    forecaster: str
    dt_s: float
    n_steps: int
    n_zones: int
    warmup_steps: int
    horizons: List[HorizonScore]

    @property
    def mean_brier_avail(self) -> float:
        """Headline number: Brier of p_available averaged over horizons."""
        return float(np.mean([h.brier_avail for h in self.horizons]))

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema": SCHEMA_VERSION,
            "kind": "forecast-backtest",
            "trace": self.trace,
            "forecaster": self.forecaster,
            "dt_s": self.dt_s,
            "n_steps": self.n_steps,
            "n_zones": self.n_zones,
            "warmup_steps": self.warmup_steps,
            "mean_brier_avail": round(self.mean_brier_avail, 6),
            "horizons": [h.to_dict() for h in self.horizons],
        }

    def save(self, directory: str = ART_DIR,
             stem: Optional[str] = None) -> str:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(
            directory,
            f"{stem or f'backtest_{self.trace}_{self.forecaster}'}.json",
        )
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)
        return path

    @staticmethod
    def load(path: str) -> "BacktestReport":
        with open(path) as f:
            d = json.load(f)
        if d.get("schema") != SCHEMA_VERSION:
            raise ValueError(
                f"backtest artifact {path!r} has schema "
                f"{d.get('schema')!r}, expected {SCHEMA_VERSION}"
            )
        return BacktestReport(
            trace=d["trace"],
            forecaster=d["forecaster"],
            dt_s=d["dt_s"],
            n_steps=d["n_steps"],
            n_zones=d["n_zones"],
            warmup_steps=d["warmup_steps"],
            horizons=[HorizonScore(**h) for h in d["horizons"]],
        )

    def summary(self) -> str:
        lines = [
            f"{self.forecaster:>12s} @ {self.trace:<8s} "
            f"mean Brier(avail)={self.mean_brier_avail:.4f}"
        ]
        for h in self.horizons:
            lines.append(
                f"    h={h.seconds / 60.0:5.1f}min "
                f"brier={h.brier_avail:.4f} "
                f"preempt_brier={h.brier_preempt:.4f} "
                f"hit={h.hit_rate:6.2%} base={h.base_rate:6.2%}"
            )
        return "\n".join(lines)


def _calibration(
    preds: np.ndarray, realized: np.ndarray, bins: int = 10
) -> List[Dict[str, float]]:
    """Binned predicted probability vs. realized frequency."""
    out: List[Dict[str, float]] = []
    edges = np.linspace(0.0, 1.0, bins + 1)
    idx = np.clip(np.digitize(preds, edges[1:-1]), 0, bins - 1)
    for b in range(bins):
        mask = idx == b
        n = int(mask.sum())
        if n == 0:
            continue
        out.append(
            {
                "p_mean": round(float(preds[mask].mean()), 6),
                "freq": round(float(realized[mask].mean()), 6),
                "n": n,
            }
        )
    return out


def _zone_regions(trace: SpotTrace) -> Dict[str, str]:
    """Catalog regions where known, heuristic inference otherwise."""
    from repro_torch.cluster.catalog import default_catalog
    from repro_torch.forecast.base import infer_region

    catalog = default_catalog()
    out: Dict[str, str] = {}
    for z in trace.zones:
        try:
            out[z] = catalog.zone(z).region
        except KeyError:
            out[z] = infer_region(z)
    return out


def run_backtest(
    trace: "SpotTrace | str",
    forecaster: "Forecaster | str",
    *,
    horizons: Sequence[int] = DEFAULT_HORIZONS,
    warmup_steps: int = 120,
    max_steps: Optional[int] = None,
) -> BacktestReport:
    """Replay ``trace`` through ``forecaster`` and score every horizon.

    ``warmup_steps`` are observed but not scored (estimators need history
    before their probabilities mean anything).  ``max_steps`` truncates
    the replay — the CI smoke knob.
    """
    if isinstance(trace, str):
        trace = load_trace(trace)
    if isinstance(forecaster, str):
        forecaster = make_forecaster(forecaster)
    horizons = sorted(set(int(h) for h in horizons))
    if not horizons or horizons[0] <= 0:
        raise ValueError(f"horizons must be positive ints, got {horizons}")

    avail = trace.cap > 0                      # bool [T, Z]
    drops = trace.preemption_indicator()       # bool [T, Z]
    T = avail.shape[0] if max_steps is None else min(
        avail.shape[0], int(max_steps)
    )
    zones = list(trace.zones)
    warmup = min(int(warmup_steps), max(T - max(horizons) - 1, 0))
    forecaster.reset(zones, _zone_regions(trace), dt=trace.dt)

    # per horizon: predictions and realizations, accumulated as flat lists
    acc: Dict[int, Dict[str, List[float]]] = {
        h: {"pa": [], "ra": [], "pp": [], "rp": []} for h in horizons
    }
    # cumulative drop counts for O(1) "any preemption in (t, t+h]" queries
    drop_cum = np.cumsum(drops, axis=0)

    for t in range(T):
        now = t * trace.dt
        forecaster.observe(
            now, {z: bool(avail[t, j]) for j, z in enumerate(zones)}
        )
        for h in horizons:
            if t < warmup or t + h >= T:
                continue
            pred = forecaster.predict(now, h * trace.dt)
            for j, z in enumerate(zones):
                a = acc[h]
                a["pa"].append(pred[z].p_available)
                a["ra"].append(float(avail[t + h, j]))
                if avail[t, j]:
                    # preemption risk is only defined for a zone that
                    # could host a running instance now
                    a["pp"].append(pred[z].p_preempt)
                    a["rp"].append(
                        float(drop_cum[t + h, j] - drop_cum[t, j] > 0)
                    )

    scores: List[HorizonScore] = []
    for h in horizons:
        pa = np.asarray(acc[h]["pa"])
        ra = np.asarray(acc[h]["ra"])
        pp = np.asarray(acc[h]["pp"])
        rp = np.asarray(acc[h]["rp"])
        if len(pa) == 0:
            continue
        scores.append(
            HorizonScore(
                steps=h,
                seconds=h * trace.dt,
                n=len(pa),
                brier_avail=float(np.mean((pa - ra) ** 2)),
                brier_preempt=(
                    float(np.mean((pp - rp) ** 2)) if len(pp) else 0.0
                ),
                hit_rate=float(np.mean((pa >= 0.5) == (ra > 0.5))),
                base_rate=float(ra.mean()),
                calibration=_calibration(pa, ra),
            )
        )
    if not scores:
        raise ValueError(
            f"trace {trace.name!r} too short to score: {T} steps with "
            f"warmup {warmup} and horizons {horizons}"
        )
    return BacktestReport(
        trace=trace.name,
        forecaster=forecaster.name,
        dt_s=trace.dt,
        n_steps=T,
        n_zones=len(zones),
        warmup_steps=warmup,
        horizons=scores,
    )


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Backtest spot-availability forecasters on a trace"
    )
    ap.add_argument("--trace", default="aws-1",
                    help="named dataset or .json/.npz trace path")
    ap.add_argument("--forecasters", nargs="+", default=None,
                    help=f"default: all ({registered_forecasters()})")
    ap.add_argument("--horizons", nargs="+", type=int,
                    default=list(DEFAULT_HORIZONS),
                    help="forecast horizons in trace steps")
    ap.add_argument("--warmup", type=int, default=120,
                    help="steps observed before scoring starts")
    ap.add_argument("--max-steps", type=int, default=None,
                    help="truncate the replay (CI smoke)")
    ap.add_argument("--out-dir", default=ART_DIR)
    args = ap.parse_args(argv)

    trace = load_trace(args.trace)
    names = args.forecasters or registered_forecasters()
    for name in names:
        report = run_backtest(
            trace,
            name,
            horizons=args.horizons,
            warmup_steps=args.warmup,
            max_steps=args.max_steps,
        )
        path = report.save(args.out_dir)
        print(report.summary())
        print(f"  -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
