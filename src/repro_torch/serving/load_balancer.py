"""Load balancers, round-robin and least-outstanding-requests: the port's
own copy of ``repro.serving.load_balancer``.

A balancer routes only to replicas whose readiness probe passed.  The RTT
from the request's client region to the replica's region counts into its
end-to-end latency.  ``VectorizedServingEngine`` simulates exactly these
two classes; a subclass runs on the legacy ``ServingSimulator`` only.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.cluster.catalog import region_rtt_ms
from repro_torch.serving.replica import Replica, ReplicaState
from repro_torch.workloads.arrivals import Request

__all__ = ["LeastLoadedBalancer", "LoadBalancer", "RoundRobinBalancer"]


class LoadBalancer:
    name = "lb"

    def __init__(self) -> None:
        self._ready: List[Replica] = []

    def update_ready(self, replicas: Sequence[Replica]) -> None:
        self._ready = [r for r in replicas if r.state is ReplicaState.READY]

    def pick(self, req: Request, now: float) -> Optional[Replica]:
        raise NotImplementedError

    def route(self, req: Request, now: float) -> Optional[Replica]:
        r = self.pick(req, now)
        if r is not None:
            r.submit(req, now)
        return r

    @staticmethod
    def rtt_s(req: Request, replica: Replica) -> float:
        return region_rtt_ms(req.client_region, replica.region) / 1e3


class RoundRobinBalancer(LoadBalancer):
    name = "round_robin"

    def __init__(self) -> None:
        super().__init__()
        self._cursor = 0

    def pick(self, req: Request, now: float) -> Optional[Replica]:
        if not self._ready:
            return None
        r = self._ready[self._cursor % len(self._ready)]
        self._cursor += 1
        return r


class LeastLoadedBalancer(LoadBalancer):
    """The replica with the fewest outstanding requests; ties go to the
    lower RTT, then the lower id."""

    name = "least_loaded"

    def pick(self, req: Request, now: float) -> Optional[Replica]:
        if not self._ready:
            return None
        return min(self._ready,
                   key=lambda r: (r.load, self.rtt_s(req, r), r.id))
