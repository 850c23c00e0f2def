"""Policy interface shared by the cluster simulator and the controller: the
port's own copy of ``repro.core.policy``.

The controller shows the policy the observable cluster state once per
control interval; the policy returns actions (launch spot in zone z, launch
on-demand, terminate instance i).  Event hooks deliver preemption / ready /
launch-failure / warning transitions between ticks, which is what Alg. 1
keys off.  A policy never sees the future of the trace.

The registry holds SpotHedge, its risk-aware variant, the seven baselines
and the Omniscient oracle (the one policy that sees the whole trace,
through its offline ILP); an unknown name raises the reference's
``KeyError``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, TYPE_CHECKING, Union

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.cluster.catalog import Catalog, Zone
    from repro_torch.cluster.instance import Instance


# ---------------------------------------------------------------------------
# Actions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LaunchSpot:
    zone: str


@dataclasses.dataclass(frozen=True)
class LaunchOnDemand:
    zone: str


@dataclasses.dataclass(frozen=True)
class Terminate:
    instance_id: int


#: The controller contract: a policy's ``decide`` returns a list of these.
Action = Union[LaunchSpot, LaunchOnDemand, Terminate]


# ---------------------------------------------------------------------------
# Controller events
# ---------------------------------------------------------------------------


class EventKind(enum.Enum):
    """Cluster transitions delivered to the policy between control ticks."""

    PREEMPTION = "preemption"
    LAUNCH_FAILURE = "launch_failure"
    READY = "ready"
    WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class ControllerEvent:
    """A structured cluster transition (preempt / launch-fail / ready /
    preemption-warning) as the controller observed it.

    ``instance_id`` is set when the event concerns a specific instance
    (preemption, ready); zone-level events (launch failure, warning) leave
    it ``None``.
    """

    kind: EventKind
    zone: str
    now: float
    instance_id: Optional[int] = None


# ---------------------------------------------------------------------------
# Observation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Observation:
    """What the controller can see at time ``now`` (no future knowledge)."""

    now: float
    n_target: int                     # N_Tar(t) — from the autoscaler
    spot_ready: List["Instance"]
    spot_provisioning: List["Instance"]
    od_ready: List["Instance"]
    od_provisioning: List["Instance"]

    # -- derived -----------------------------------------------------------
    @property
    def s_r(self) -> int:
        """S_r(t): number of ready spot replicas."""
        return len(self.spot_ready)

    @property
    def s_launched(self) -> int:
        """S(t): launched (ready + provisioning) spot replicas."""
        return len(self.spot_ready) + len(self.spot_provisioning)

    @property
    def o_r(self) -> int:
        return len(self.od_ready)

    @property
    def o_launched(self) -> int:
        return len(self.od_ready) + len(self.od_provisioning)

    @property
    def ready_total(self) -> int:
        return self.s_r + self.o_r

    def spot_count_by_zone(self) -> Dict[str, int]:
        """Active (ready+provisioning) spot replicas per zone — the set C
        that SELECT-NEXT-ZONE avoids re-using (Alg. 1 line 18)."""
        counts: Dict[str, int] = {}
        for inst in self.spot_ready + self.spot_provisioning:
            counts[inst.zone] = counts.get(inst.zone, 0) + 1
        return counts


# ---------------------------------------------------------------------------
# Policy base class
# ---------------------------------------------------------------------------


class Policy:
    """Base class.  Subclasses implement ``decide`` and the event hooks."""

    name: str = "policy"

    #: after a failed spot launch, avoid retrying the same zone for this long
    #: (real controllers back off; probing still happens — see SpotHedge).
    launch_cooldown_s: float = 90.0

    def __init__(self) -> None:
        self._zones: List["Zone"] = []
        self._catalog: Optional["Catalog"] = None
        self._itype: str = ""
        self._fail_at: Dict[str, float] = {}
        # machine-readable decision reasons, one per action appended in
        # the current decide() call (an observability recorder pairs them by index)
        self._reasons: List[Optional[Dict[str, object]]] = []

    # -- lifecycle -----------------------------------------------------
    def reset(
        self, zones: Sequence["Zone"], catalog: "Catalog", itype: str
    ) -> None:
        """Called once before the run with the *enabled* zone set (the user's
        ``any_of`` filter from Listing 1 already applied)."""
        self._zones = list(zones)
        self._catalog = catalog
        self._itype = itype
        self._fail_at = {}

    # -- event hooks (between control ticks) ----------------------------
    def on_event(self, event: ControllerEvent) -> None:
        """Structured event entry point: the controller delivers every
        cluster transition through here.  Dispatches to the per-kind hooks,
        which remain the subclass override points."""
        if event.kind is EventKind.PREEMPTION:
            self.on_preemption(event.zone, event.now)
        elif event.kind is EventKind.LAUNCH_FAILURE:
            self.on_launch_failure(event.zone, event.now)
        elif event.kind is EventKind.READY:
            self.on_ready(event.zone, event.now)
        elif event.kind is EventKind.WARNING:
            self.on_warning(event.zone, event.now)
        else:  # pragma: no cover - exhaustive over EventKind
            raise TypeError(f"unknown controller event {event!r}")

    def on_preemption(self, zone: str, now: float) -> None:
        """A spot replica in ``zone`` was preempted."""

    def on_launch_failure(self, zone: str, now: float) -> None:
        """A spot launch in ``zone`` failed (no capacity)."""
        self._fail_at[zone] = now

    def _cooled(self, zone: str, now: float) -> bool:
        """True if the zone is past its launch-failure cooldown."""
        return now - self._fail_at.get(zone, -1e18) >= self.launch_cooldown_s

    def on_ready(self, zone: str, now: float) -> None:
        """A spot replica in ``zone`` finished cold start and is ready."""

    def on_warning(self, zone: str, now: float) -> None:
        """Best-effort preemption warning received for an instance in zone."""

    # -- the decision --------------------------------------------------
    def decide(self, obs: Observation) -> List[Action]:
        raise NotImplementedError

    # -- decision reasons (observability) ------------------------------
    def _note(self, **reason: object) -> None:
        """Record the machine-readable *reason* for the action the policy
        is about to (or just did) append in ``decide``.

        Reasons pair with actions by position: call ``_note`` exactly
        once per appended action, in the same order.  Noting is pure
        bookkeeping — it must never draw RNG or change decisions, so
        golden metrics are identical whether or not anyone reads the
        reasons.
        """
        reasons = getattr(self, "_reasons", None)
        if reasons is None:  # subclass skipped Policy.__init__
            reasons = self._reasons = []
        reasons.append(dict(reason))

    def take_reasons(self) -> List[Optional[Dict[str, object]]]:
        """Drain the reasons noted during the last ``decide`` call.

        The controller calls this after every ``decide``; policies that
        never ``_note`` yield an empty list (reasons default to None).
        """
        reasons = getattr(self, "_reasons", None)
        if not reasons:
            return []
        out = list(reasons)
        reasons.clear()
        return out

    # -- shared helpers ---------------------------------------------------
    def _zone_names(self) -> List[str]:
        return [z.name for z in self._zones]

    def _spot_price(self, zone: str) -> float:
        assert self._catalog is not None
        return self._catalog.spot_price(self._itype, zone)

    def _od_price(self, zone: str) -> float:
        assert self._catalog is not None
        return self._catalog.od_price(self._itype, zone)

    def _cheapest_od_zone(self) -> str:
        """On-demand fallback zone: cheapest enabled zone (OD is assumed
        obtainable across regions — §5.1 Discussion)."""
        return min(self._zone_names(), key=lambda z: (self._od_price(z), z))

    @staticmethod
    def _scale_down_od(
        obs: Observation, od_needed: int
    ) -> List[Action]:
        """Terminate surplus on-demand replicas, provisioning-first (they
        have served no traffic yet), then newest-ready-first."""
        actions: List[Action] = []
        surplus = obs.o_launched - od_needed
        if surplus <= 0:
            return actions
        pool = sorted(
            obs.od_provisioning, key=lambda i: -i.launched_at
        ) + sorted(obs.od_ready, key=lambda i: -i.launched_at)
        for inst in pool[:surplus]:
            actions.append(Terminate(inst.id))
        return actions


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, type] = {}


def register_policy(cls: type) -> type:
    _REGISTRY[cls.name] = cls
    return cls


def _load_builtin() -> None:
    # Import for registration side effects.
    from repro_torch.core import baselines as _b  # noqa: F401
    from repro_torch.core import omniscient as _o  # noqa: F401
    from repro_torch.core import risk_aware as _r  # noqa: F401
    from repro_torch.core import spothedge as _s  # noqa: F401


def _lookup(name: str) -> type:
    _load_builtin()
    if name not in _REGISTRY:
        raise KeyError(f"unknown policy {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def make_policy(name: str, **kwargs) -> Policy:
    """Instantiate a policy by its registered name (CLI / config entry)."""
    return _lookup(name)(**kwargs)


def policy_class(name: str) -> type:
    """The registered class for ``name`` (builders peek at class flags
    like ``uses_forecast`` before instantiating)."""
    return _lookup(name)


def registered_policies() -> List[str]:
    _load_builtin()
    return sorted(_REGISTRY)
