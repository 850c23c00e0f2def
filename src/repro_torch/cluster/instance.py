"""Instance lifecycle FSM: the port's own copy of ``repro.cluster.instance``.

A replica is one or more cloud instances running an inference engine.  The
lifecycle is the one the controller observes (§2.3, §4):

    REQUESTED --launch ok--> PROVISIONING --cold start d--> READY
        |                        |                             |
        +--capacity miss--> FAILED                             |
                                 +------- preempted ----------+--> PREEMPTED
                                               (spot only)
                                 +------ terminate (policy) ------> TERMINATED

Billing runs from a successful launch, cold start included (§2.3); a failed
launch costs nothing.  Ids come from a process-global counter, as in the
reference: two runs in one process give different ids, in the same order.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Optional


class InstanceKind(enum.Enum):
    SPOT = "spot"
    ON_DEMAND = "on_demand"


class InstanceState(enum.Enum):
    REQUESTED = "requested"
    PROVISIONING = "provisioning"
    READY = "ready"
    PREEMPTED = "preempted"
    TERMINATED = "terminated"
    FAILED = "failed"          # launch failed (no capacity)


_ACTIVE = (InstanceState.PROVISIONING, InstanceState.READY)

_id_counter = itertools.count()


def _next_id() -> int:
    return next(_id_counter)


@dataclasses.dataclass
class Instance:
    """One cloud instance and its billing record."""

    zone: str
    region: str
    cloud: str
    kind: InstanceKind
    itype: str                     # instance type name
    hourly_price: float            # $ / hour at launch time
    launched_at: float             # sim time of successful launch
    cold_start_s: float            # provisioning + model load delay d
    state: InstanceState = InstanceState.PROVISIONING
    ended_at: Optional[float] = None
    id: int = dataclasses.field(default_factory=_next_id)
    # preemption warning delivered at this sim time (None: not warned)
    warned_at: Optional[float] = None

    # ------------------------------------------------------------------
    @property
    def ready_at(self) -> float:
        return self.launched_at + self.cold_start_s

    def is_active(self) -> bool:
        return self.state in _ACTIVE

    def is_ready(self) -> bool:
        return self.state is InstanceState.READY

    def is_spot(self) -> bool:
        return self.kind is InstanceKind.SPOT

    # ------------------------------------------------------------------
    def step_to(self, now: float) -> None:
        """Advance PROVISIONING -> READY when the cold start has elapsed."""
        if self.state is InstanceState.PROVISIONING and now >= self.ready_at:
            self.state = InstanceState.READY

    def preempt(self, now: float) -> None:
        if not self.is_active():
            raise ValueError(f"preempting non-active instance {self.id}")
        if not self.is_spot():
            raise ValueError("on-demand instances are never preempted")
        self.state = InstanceState.PREEMPTED
        self.ended_at = now

    def terminate(self, now: float) -> None:
        if not self.is_active():
            raise ValueError(f"terminating non-active instance {self.id}")
        self.state = InstanceState.TERMINATED
        self.ended_at = now

    # ------------------------------------------------------------------
    def billed_hours(self, now: float) -> float:
        """Hours billed so far (per-second granularity, incl. cold start)."""
        end = self.ended_at if self.ended_at is not None else now
        return max(0.0, end - self.launched_at) / 3600.0

    def cost(self, now: float) -> float:
        return self.billed_hours(now) * self.hourly_price
