"""A replica, an inference endpoint bound to a cloud instance: the port's
own copy of ``repro.serving.replica``, the object the legacy
``ServingSimulator`` serves through.

The instance provisions (the cold start covers boot, image and model load),
then the readiness probe flips the replica READY and the balancer may route
to it.  A preemption kills the replica; its in-flight and queued requests
go back to the client for retry.  A replica is an M/G/c server:
``concurrency`` slots, a FIFO queue, service times from the latency model
and a ``1 + 0.15 x running`` interference factor at a start.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple

from repro_torch.cluster.catalog import region_rtt_ms
from repro_torch.cluster.instance import Instance
from repro_torch.serving.latency import LatencyModel
from repro_torch.workloads.arrivals import Request

__all__ = ["InFlight", "Replica", "ReplicaState"]


class ReplicaState(enum.Enum):
    PROVISIONING = "provisioning"
    READY = "ready"
    DEAD = "dead"


@dataclasses.dataclass
class InFlight:
    request: Request
    started_s: float
    finish_s: float


class Replica:
    """One model replica on one instance."""

    def __init__(
        self,
        instance: Instance,
        latency: LatencyModel,
        *,
        concurrency: Optional[int] = None,
        concurrency_cap: int = 16,   # cap on the model-derived default
        timeout_s: float = 0.0,      # 0: queued requests never expire
        span_tap=None,               # the run's SpanCollector
        span_ord: int = -1,          # this replica's dense run ordinal
    ) -> None:
        self.instance = instance
        self.latency = latency
        self.concurrency = concurrency or min(latency.max_concurrency(),
                                             concurrency_cap)
        self.timeout_s = timeout_s
        self.span_tap = span_tap
        self.span_ord = span_ord
        self.state = ReplicaState.PROVISIONING
        self.queue: List[Request] = []
        self.running: List[InFlight] = []
        self.completed = 0

    # -- lifecycle ------------------------------------------------------
    @property
    def id(self) -> int:
        return self.instance.id

    @property
    def zone(self) -> str:
        return self.instance.zone

    @property
    def region(self) -> str:
        return self.instance.region

    def readiness_probe(self, now: float) -> bool:
        """Flip PROVISIONING to READY once the instance is ready."""
        if (self.state is ReplicaState.PROVISIONING
                and self.instance.is_ready()):
            self.state = ReplicaState.READY
        return self.state is ReplicaState.READY

    def kill(self) -> List[Request]:
        """Preemption or termination: the in-flight and queued requests,
        for the client to retry."""
        self.state = ReplicaState.DEAD
        failed = [f.request for f in self.running] + self.queue
        self.running, self.queue = [], []
        return failed

    # -- request path ---------------------------------------------------
    @property
    def load(self) -> int:
        return len(self.running) + len(self.queue)

    def submit(self, req: Request, now: float) -> None:
        self.queue.append(req)

    def step(self, now: float) -> Tuple[List[Tuple[Request, float]],
                                        List[Request]]:
        """Advance to ``now``: finish the work due, expire queue entries
        whose client gave up, start queued work.  Returns (completions as
        ``(request, finish time)``, expired)."""
        done: List[Tuple[Request, float]] = []
        still: List[InFlight] = []
        for f in self.running:
            if f.finish_s <= now:
                done.append((f.request, f.finish_s))
                self.completed += 1
            else:
                still.append(f)
        self.running = still
        expired: List[Request] = []
        if self.timeout_s > 0:
            fresh = []
            for q in self.queue:
                # the RTT-inclusive deadline of a completed response
                rtt = region_rtt_ms(q.client_region, self.region) / 1e3
                if now - q.arrival_s + rtt > self.timeout_s:
                    expired.append(q)
                else:
                    fresh.append(q)
            self.queue = fresh
        tap = self.span_tap
        while self.queue and len(self.running) < self.concurrency:
            req = self.queue.pop(0)
            svc = self.latency.service_s(req.prompt_tokens, req.output_tokens)
            # concurrent decode shares the HBM rate
            factor = 1.0 + 0.15 * len(self.running)
            self.running.append(InFlight(req, now, now + svc * factor))
            if tap is not None:
                o = tap.want_ids.get(req.id)
                if o is not None:
                    tap.start(o, now)
        return done, expired

    def eta_if_submitted(self, req: Request, now: float) -> float:
        """A completion estimate for latency-aware balancers: the queued
        work and the residual of the running work, over the slots."""
        svc = self.latency.service_s(req.prompt_tokens, req.output_tokens)
        residual = sum(max(0.0, f.finish_s - now) for f in self.running)
        backlog = (residual + sum(
            self.latency.service_s(q.prompt_tokens, q.output_tokens)
            for q in self.queue)) / max(self.concurrency, 1)
        return now + backlog + svc
