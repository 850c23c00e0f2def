"""One cell's serving result: the port's own copy of ``ServingResult``
(``repro.serving.sim``), request-model fields only (the token-level stats
and the observability snapshots stay in the reference)."""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ServingResult"]


@dataclasses.dataclass
class ServingResult:
    policy: str
    trace: str
    workload: str
    n_requests: int
    n_completed: int
    n_failed: int
    latencies_s: np.ndarray
    total_cost: float
    spot_cost: float
    od_cost: float
    cost_vs_ondemand: float
    availability: float
    n_preemptions: int = 0
    n_launch_failures: int = 0
    # requests pushed back to the client for retry after a replica died
    n_retried_requests: int = 0

    @property
    def failure_rate(self) -> float:
        return self.n_failed / max(self.n_requests, 1)

    def pct(self, q: float) -> float:
        if len(self.latencies_s) == 0:
            return float("nan")
        return float(np.percentile(self.latencies_s, q))

    def summary(self) -> str:
        return (
            f"{self.policy:>16s} @ {self.trace}/{self.workload} "
            f"p50={self.pct(50):6.2f}s p90={self.pct(90):6.2f}s "
            f"p99={self.pct(99):7.2f}s fail={self.failure_rate:6.2%} "
            f"cost={self.cost_vs_ondemand:6.2%} avail={self.availability:.2%}"
        )
