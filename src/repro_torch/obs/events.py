"""Typed, schema-versioned observability events.

Every event is a frozen dataclass with a ``KIND`` tag and a
``to_record()`` that renders a plain JSON-able dict (``None`` fields
omitted, ``schema`` and ``event`` keys added).  Records are the exchange
format: the JSONL exporter, the Chrome-trace converter, the attribution
report and the CLI all consume records, so a run can be analyzed either
live (event objects) or from its log file (dicts) with the same code.

Determinism contract: events carry *simulation* time only — no wall
clocks, no ids derived from memory addresses — so two decision-identical
engines produce byte-identical logs (the differential test in
tests/test_torch_obs.py holds legacy == vector on the serialized bytes).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

__all__ = [
    "SCHEMA_VERSION",
    "Event",
    "PolicyDecisionEvent",
    "ReplicaLifecycleEvent",
    "MigrationPlanEvent",
    "PreemptionWarningEvent",
    "LaunchFailureEvent",
    "WindowSampleEvent",
    "SLOBurnEvent",
    "AutoscalerTargetEvent",
    "LIFECYCLE_PHASES",
    "control_plane_records",
]

#: bump when a field changes meaning; consumers gate on this
SCHEMA_VERSION = 1

#: the replica lifecycle state machine the timeline renders
LIFECYCLE_PHASES = (
    "provision", "ready", "draining", "migrating", "dead",
)


@dataclasses.dataclass(frozen=True)
class Event:
    """Base event: a tagged record at simulation time ``t`` (seconds)."""

    t: float

    KIND = "event"

    def to_record(self) -> Dict[str, Any]:
        rec: Dict[str, Any] = {"schema": SCHEMA_VERSION, "event": self.KIND}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            if isinstance(v, Mapping):
                v = dict(v)
            rec[f.name] = v
        return rec


@dataclasses.dataclass(frozen=True)
class PolicyDecisionEvent(Event):
    """One executed policy action, with the policy's machine-readable
    *reason* (zone rank, forecast risk, buffer targets, ...) attached.

    ``instance_id`` links a launch decision to the replica it produced —
    the attribution report charges that replica's cost to this event.
    """

    action: str = ""                    # launch_spot|launch_ondemand|terminate
    zone: Optional[str] = None
    instance_id: Optional[int] = None
    reason: Optional[Dict[str, Any]] = None

    KIND = "decision"


@dataclasses.dataclass(frozen=True)
class ReplicaLifecycleEvent(Event):
    """A replica crossing a lifecycle phase boundary.

    ``provision`` carries the billing context (kind/zone/hourly price);
    ``dead`` carries the ``cause`` (``preemption`` | ``terminate``);
    ``draining``/``migrating`` come from the migration runtime during a
    grace window.
    """

    phase: str = ""                     # one of LIFECYCLE_PHASES
    instance_id: int = -1
    zone: Optional[str] = None
    kind: Optional[str] = None          # spot | ondemand
    hourly_price: Optional[float] = None
    cause: Optional[str] = None

    KIND = "lifecycle"


@dataclasses.dataclass(frozen=True)
class MigrationPlanEvent(Event):
    """The drain/migrate/kill plan executed for one warned preemption."""

    instance_id: int = -1
    n_drained: int = 0
    n_migrated: int = 0
    n_killed: int = 0
    migrated_kv_tokens: int = 0
    transfer_s: float = 0.0
    grace_s: float = 0.0

    KIND = "migration_plan"


@dataclasses.dataclass(frozen=True)
class PreemptionWarningEvent(Event):
    """An advance preemption warning delivered to a replica."""

    zone: str = ""
    instance_id: Optional[int] = None

    KIND = "warning"


@dataclasses.dataclass(frozen=True)
class LaunchFailureEvent(Event):
    """A launch attempt that found no spot capacity in the zone."""

    zone: str = ""
    kind: str = "spot"

    KIND = "launch_failure"


@dataclasses.dataclass(frozen=True)
class WindowSampleEvent(Event):
    """A windowed data-plane sample (detail level ``full`` only).

    Every field is defined order-independently (cumulative counters and
    instantaneous cluster state at the window boundary), so decision-
    identical engines emit identical samples even when their intra-tick
    processing order differs.
    """

    queue_depth: int = 0                # arrived − completed − failed
    n_ready: int = 0
    n_spot: int = 0                     # ready spot replicas
    n_od: int = 0                       # ready on-demand replicas
    cost_per_h: float = 0.0             # Σ hourly_price over live replicas
    n_completed: int = 0                # cumulative
    n_failed: int = 0                   # cumulative
    goodput_rps: float = 0.0            # completions this window / window_s
    ttft_p50_s: Optional[float] = None  # token mode: window TTFT median

    KIND = "window"


@dataclasses.dataclass(frozen=True)
class SLOBurnEvent(Event):
    """Multi-window SLO burn rates at one sample-window boundary.

    Burn = (trailing-window error fraction) / (1 − SLO target); one
    event per data-plane sample window (detail level ``full``).  A
    ``None`` burn means no traffic in that trailing window (omitted
    from the record); ``ttft``/``tpot`` exist only for token-model
    cells.  ``alerting`` lists SLOs whose fast *and* slow burns both
    exceed their thresholds (see :class:`repro_torch.obs.slo.SLOBurnConfig`).
    """

    availability_fast: Optional[float] = None
    availability_slow: Optional[float] = None
    ttft_fast: Optional[float] = None
    ttft_slow: Optional[float] = None
    tpot_fast: Optional[float] = None
    tpot_slow: Optional[float] = None
    alerting: Optional[Tuple[str, ...]] = None

    KIND = "slo_burn"

    def to_record(self) -> Dict[str, Any]:
        rec = super().to_record()
        if self.alerting is not None:
            rec["alerting"] = list(self.alerting)
        return rec


@dataclasses.dataclass(frozen=True)
class AutoscalerTargetEvent(Event):
    """The autoscaler target changed (includes the initial value)."""

    target: int = 0
    prev_target: Optional[int] = None

    KIND = "autoscaler_target"


def control_plane_records(
    records: Iterable[Mapping[str, Any]]
) -> List[Dict[str, Any]]:
    """The control-plane subset of a record stream.

    Window samples, burn-rate windows and migration activity are
    data-plane products; the card engine's phase-A replay reproduces
    everything else exactly, so this is the stream its parity is
    tested on.
    """
    out: List[Dict[str, Any]] = []
    for r in records:
        if r.get("event") in ("window", "migration_plan", "slo_burn"):
            continue
        if r.get("event") == "lifecycle" and r.get("phase") in (
            "draining", "migrating"
        ):
            continue
        out.append(dict(r))
    return out
