"""One cell's serving result: the port's own copy of ``ServingResult``
(``repro.serving.sim``), with the token model's stats, the KV lost to
preemptions and the run's observability (the registry's snapshot and the
recorder)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.obs.recorder import ObsRecorder
from repro_torch.serving.token.metrics import TokenStats

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
    # token-level metrics (replica_model "token" only)
    token: Optional[TokenStats] = None
    # requests pushed back to the client for retry after a replica died,
    # and the KV tokens destroyed doing so (0 under the request model)
    n_retried_requests: int = 0
    lost_kv_tokens: int = 0
    # the run's metrics-registry snapshot, and the recorder holding its
    # event stream (None at detail "off")
    metrics: Optional[Dict[str, Any]] = None
    obs: Optional[ObsRecorder] = None

    @property
    def failure_rate(self) -> float:
        return self.n_failed / max(self.n_requests, 1)

    def pct(self, q: float) -> float:
        if len(self.latencies_s) == 0:
            return float("nan")
        return float(np.percentile(self.latencies_s, q))

    def summary(self) -> str:
        out = (
            f"{self.policy:>16s} @ {self.trace}/{self.workload} "
            f"p50={self.pct(50):6.2f}s p90={self.pct(90):6.2f}s "
            f"p99={self.pct(99):7.2f}s fail={self.failure_rate:6.2%} "
            f"cost={self.cost_vs_ondemand:6.2%} avail={self.availability:.2%}"
        )
        if self.token is not None:
            out += (
                f" ttft_p50={self.token.ttft_pct(50):5.2f}s "
                f"goodput={self.token.goodput_rps:.3f}req/s "
                f"slo={self.token.slo_attainment:.2%}"
            )
        return out
