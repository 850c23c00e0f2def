"""Token-level serving metrics: the port's own copy of
``repro.serving.token.metrics``.

Per completed request:

* TTFT, time to first token: arrival to the end of its first decode
  iteration, queueing, chunked prefill, the per-request overhead and the
  client's RTT included;
* TPOT, time per output token: ``(finish - first_token) / (output_tokens -
  1)``, the decode pace alone.

A request attains the SLO when both are within their targets; goodput is
the rate of SLO-attaining requests, over the run and per window.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["TokenRecord", "TokenStats"]


@dataclasses.dataclass(frozen=True)
class TokenRecord:
    """The token-level timeline of one completed request."""

    req_id: int
    arrival_s: float
    first_token_s: float            # engine clock, overhead included
    finish_s: float                 # engine clock, overhead included
    output_tokens: int
    rtt_s: float

    @property
    def ttft_s(self) -> float:
        return self.first_token_s - self.arrival_s + self.rtt_s

    @property
    def tpot_s(self) -> float:
        return (self.finish_s - self.first_token_s) / max(
            self.output_tokens - 1, 1)

    @property
    def e2e_s(self) -> float:
        return self.finish_s - self.arrival_s + self.rtt_s


@dataclasses.dataclass
class TokenStats:
    """A serving run's token-level metrics."""

    slo_ttft_s: float
    slo_tpot_s: float
    n_requests: int                 # every request that arrived
    n_recorded: int                 # completions with token records
    ttft_s: np.ndarray
    tpot_s: np.ndarray
    n_slo_ok: int
    slo_attainment: float           # n_slo_ok / n_requests
    goodput_rps: float              # n_slo_ok / horizon
    window_s: float
    windows: List[Dict[str, float]]
    # what the preemptions destroyed
    n_kv_preempted_seqs: int = 0
    n_killed_queued: int = 0
    lost_prefill_tokens: int = 0
    lost_decode_tokens: int = 0
    # grace-period migration (zero with migration off)
    n_drained_seqs: int = 0         # finished in place in the window
    n_migrated_seqs: int = 0        # KV shipped to a surviving replica
    migrated_kv_tokens: int = 0     # resident tokens that moved
    saved_prefill_tokens: int = 0   # prefill work not done again
    saved_decode_tokens: int = 0
    migration_transfer_s: float = 0.0   # wire time, summed
    recompute_saved_s: float = 0.0  # engine seconds of recompute avoided

    @classmethod
    def from_records(
        cls,
        records: List[TokenRecord],
        *,
        slo_ttft_s: float,
        slo_tpot_s: float,
        horizon_s: float,
        window_s: float,
        n_requests: int,
        n_kv_preempted_seqs: int = 0,
        n_killed_queued: int = 0,
        lost_prefill_tokens: int = 0,
        lost_decode_tokens: int = 0,
        n_drained_seqs: int = 0,
        n_migrated_seqs: int = 0,
        migrated_kv_tokens: int = 0,
        saved_prefill_tokens: int = 0,
        saved_decode_tokens: int = 0,
        migration_transfer_s: float = 0.0,
        recompute_saved_s: float = 0.0,
    ) -> "TokenStats":
        n = len(records)
        ttft = np.fromiter((r.ttft_s for r in records), np.float64, count=n)
        tpot = np.fromiter((r.tpot_s for r in records), np.float64, count=n)
        ok = (ttft <= slo_ttft_s) & (tpot <= slo_tpot_s)
        n_ok = int(ok.sum())
        horizon = max(float(horizon_s), 1e-9)
        finish = np.fromiter((r.finish_s for r in records), np.float64,
                             count=n)
        windows: List[Dict[str, float]] = []
        n_windows = int(np.ceil(horizon / window_s)) if n else 0
        if n_windows:
            # finishes past the horizon (the drain) go to a flagged bucket
            # of their own, not into the last window
            bins = np.minimum(
                np.maximum((finish // window_s).astype(np.int64), 0),
                n_windows)
            total = np.bincount(bins, minlength=n_windows + 1)
            good = np.bincount(bins, weights=ok.astype(np.float64),
                               minlength=n_windows + 1)
            for k in range(n_windows):
                windows.append({
                    "t0_s": round(k * window_s, 6),
                    "n_completed": int(total[k]),
                    "n_slo_ok": int(good[k]),
                    "goodput_rps": round(float(good[k]) / window_s, 6),
                })
            if total[n_windows]:
                windows.append({
                    "t0_s": round(n_windows * window_s, 6),
                    "n_completed": int(total[n_windows]),
                    "n_slo_ok": int(good[n_windows]),
                    "goodput_rps": 0.0,
                    "post_horizon": True,
                })
        return cls(
            slo_ttft_s=slo_ttft_s,
            slo_tpot_s=slo_tpot_s,
            n_requests=n_requests,
            n_recorded=n,
            ttft_s=ttft,
            tpot_s=tpot,
            n_slo_ok=n_ok,
            slo_attainment=n_ok / max(n_requests, 1),
            goodput_rps=n_ok / horizon,
            window_s=window_s,
            windows=windows,
            n_kv_preempted_seqs=n_kv_preempted_seqs,
            n_killed_queued=n_killed_queued,
            lost_prefill_tokens=lost_prefill_tokens,
            lost_decode_tokens=lost_decode_tokens,
            n_drained_seqs=n_drained_seqs,
            n_migrated_seqs=n_migrated_seqs,
            migrated_kv_tokens=migrated_kv_tokens,
            saved_prefill_tokens=saved_prefill_tokens,
            saved_decode_tokens=saved_decode_tokens,
            migration_transfer_s=migration_transfer_s,
            recompute_saved_s=recompute_saved_s,
        )

    def ttft_pct(self, q: float) -> float:
        if len(self.ttft_s) == 0:
            return float("nan")
        return float(np.percentile(self.ttft_s, q))

    def tpot_pct(self, q: float) -> float:
        if len(self.tpot_s) == 0:
            return float("nan")
        return float(np.percentile(self.tpot_s, q))

    def to_dict(self, include_windows: bool = True) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "slo_ttft_s": self.slo_ttft_s,
            "slo_tpot_s": self.slo_tpot_s,
            "n_requests": self.n_requests,
            "n_recorded": self.n_recorded,
            "n_slo_ok": self.n_slo_ok,
            "slo_attainment": round(self.slo_attainment, 6),
            "goodput_rps": round(self.goodput_rps, 6),
            "ttft_p50_s": _r(self.ttft_pct(50)),
            "ttft_p90_s": _r(self.ttft_pct(90)),
            "ttft_p99_s": _r(self.ttft_pct(99)),
            "tpot_p50_s": _r(self.tpot_pct(50)),
            "tpot_p99_s": _r(self.tpot_pct(99)),
            "n_kv_preempted_seqs": self.n_kv_preempted_seqs,
            "n_killed_queued": self.n_killed_queued,
            "lost_prefill_tokens": self.lost_prefill_tokens,
            "lost_decode_tokens": self.lost_decode_tokens,
            "n_drained_seqs": self.n_drained_seqs,
            "n_migrated_seqs": self.n_migrated_seqs,
            "migrated_kv_tokens": self.migrated_kv_tokens,
            "saved_prefill_tokens": self.saved_prefill_tokens,
            "saved_decode_tokens": self.saved_decode_tokens,
            "migration_transfer_s": round(self.migration_transfer_s, 6),
            "recompute_saved_s": round(self.recompute_saved_s, 6),
            "window_s": self.window_s,
        }
        if include_windows:
            out["windows"] = self.windows
        return out


def _r(v: float, nd: int = 6) -> Optional[float]:
    return round(v, nd) if np.isfinite(v) else None
