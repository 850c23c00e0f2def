"""The service spec, as far as the port reads it: its own copy of the part
of ``repro.service.spec`` / ``repro.service.loader`` that a scenario matrix
uses.

``spec_from_dict`` turns a spec dict into a ``ServiceSpec`` of frozen
sections whose defaults are the reference's dataclass defaults.  It reads:

* ``name``, ``model``, ``trace``, ``load_balancer`` (``least_loaded`` or
  ``round_robin``);
* ``resources.instance_type``;
* ``replica_policy``: ``name``, ``overprovision``, ``dynamic_fallback``,
  ``min_ondemand``, ``args``;
* ``autoscaler`` of kind ``constant`` or ``load``;
* ``workload`` of kind ``poisson`` (``rate_per_s``, ``seed``, and
  ``args.client_regions``);
* ``sim``: ``duration_hours``, ``timeout_s``, ``concurrency``, ``drain_s``,
  ``control_interval_s``, ``sub_step_s``, ``cold_start_s``, ``seed``,
  ``warning_enabled``;
* ``observability.trace_sample``;
* ``sweep``: ``policies``, ``traces``, ``seeds``.

Anything else (another key, kind or value) raises ``SpecError``, a
``ValueError``, naming it: the port refuses what it would not run as the
reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

__all__ = [
    "AutoscalerSpec", "ObservabilitySpec", "ReplicaPolicySpec",
    "ResourceSpec", "ServiceSpec", "SimSpec", "SpecError", "SweepSpec",
    "WorkloadSpec", "spec_from_dict",
]


class SpecError(ValueError):
    """A spec the port cannot run, with the offending field named."""


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise SpecError(msg)


@dataclasses.dataclass(frozen=True)
class ResourceSpec:
    instance_type: str = "p3.2xlarge"


@dataclasses.dataclass(frozen=True)
class ReplicaPolicySpec:
    """Which placement policy manages the fleet, and its knobs (the
    paper's N_Extra, Dynamic Fallback and on-demand floor; ``args`` goes
    verbatim to the policy's constructor)."""

    name: str = "spothedge"
    overprovision: Optional[int] = None
    dynamic_fallback: Optional[bool] = None
    min_ondemand: Optional[int] = None
    args: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def policy_kwargs(self) -> Dict[str, Any]:
        """Constructor kwargs for ``make_policy`` (set fields only)."""
        kw: Dict[str, Any] = dict(self.args)
        if self.overprovision is not None:
            kw["num_overprovision"] = self.overprovision
        if self.dynamic_fallback is not None:
            kw["dynamic_ondemand_fallback"] = self.dynamic_fallback
        if self.min_ondemand is not None:
            kw["min_ondemand"] = self.min_ondemand
        return kw


@dataclasses.dataclass(frozen=True)
class AutoscalerSpec:
    """``constant`` pins N_Tar to ``target``; ``load`` is the paper's QPS
    autoscaler with hysteresis, ``target`` its initial N_Tar."""

    kind: str = "constant"
    target: int = 4
    qps_per_replica: float = 0.8
    min_replicas: int = 1
    max_replicas: int = 12
    window_s: float = 60.0
    upscale_delay_s: float = 300.0
    downscale_delay_s: float = 1200.0

    def __post_init__(self) -> None:
        _require(self.kind in ("constant", "load"),
                 f"autoscaler.kind must be 'constant' or 'load', got "
                 f"{self.kind!r}")
        _require(self.target >= 0,
                 f"autoscaler.target must be >= 0, got {self.target}")
        _require(self.qps_per_replica > 0,
                 f"autoscaler.qps_per_replica must be positive, got "
                 f"{self.qps_per_replica}")
        _require(0 < self.min_replicas <= self.max_replicas,
                 f"autoscaler replica bounds invalid: need 0 < min_replicas "
                 f"<= max_replicas, got [{self.min_replicas}, "
                 f"{self.max_replicas}]")
        if self.kind == "load":
            _require(self.min_replicas <= self.target <= self.max_replicas,
                     f"autoscaler.target (initial N_Tar) must lie within "
                     f"[{self.min_replicas}, {self.max_replicas}] for "
                     f"kind='load', got {self.target}")


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    kind: str = "poisson"
    rate_per_s: float = 0.5
    seed: int = 0
    args: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        _require(self.kind == "poisson",
                 f"workload.kind {self.kind!r}: the port has 'poisson' only")
        _require(self.rate_per_s > 0, f"workload.rate_per_s must be "
                 f"positive, got {self.rate_per_s}")
        extra = set(self.args) - {"client_regions"}
        _require(not extra, f"workload.args has keys {sorted(extra)} the "
                 "port does not read; allowed: ['client_regions']")


@dataclasses.dataclass(frozen=True)
class SimSpec:
    """Horizon, cold start, control cadence and SLO of one run."""

    duration_hours: float = 4.0
    cold_start_s: float = 183.0
    control_interval_s: float = 15.0
    timeout_s: float = 100.0
    sub_step_s: float = 1.0
    concurrency: Optional[int] = 4
    drain_s: float = 600.0        # no arrivals this long before the horizon
    warning_enabled: bool = True
    seed: int = 0

    def __post_init__(self) -> None:
        for name in ("duration_hours", "control_interval_s", "timeout_s",
                     "sub_step_s"):
            v = getattr(self, name)
            _require(v > 0, f"sim.{name} must be positive, got {v}")
        for name in ("cold_start_s", "drain_s"):
            v = getattr(self, name)
            _require(v >= 0, f"sim.{name} must be >= 0, got {v}")
        _require(self.concurrency is None or self.concurrency > 0,
                 f"sim.concurrency must be positive, got {self.concurrency}")

    @property
    def duration_s(self) -> float:
        return self.duration_hours * 3600.0


@dataclasses.dataclass(frozen=True)
class ObservabilitySpec:
    #: share of requests whose spans are sampled; > 0 asks phase B for span
    #: timelines
    trace_sample: float = 0.01

    def __post_init__(self) -> None:
        _require(0.0 <= self.trace_sample <= 1.0,
                 f"observability.trace_sample must lie in [0, 1], got "
                 f"{self.trace_sample}")


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A scenario grid ``policies x traces x seeds``; an empty axis falls
    back to the base spec's single value, and a seed overrides
    ``workload.seed``."""

    policies: Tuple[ReplicaPolicySpec, ...] = ()
    traces: Tuple[str, ...] = ()
    seeds: Tuple[int, ...] = ()

    def __post_init__(self) -> None:
        names = [p.name for p in self.policies]
        _require(len(set(names)) == len(names),
                 f"sweep.policies names a policy twice: {names}")
        for s in self.seeds:
            _require(isinstance(s, int) and not isinstance(s, bool),
                     f"sweep.seeds entries must be ints, got {s!r}")


LB_NAMES = {"least_loaded": "ll", "round_robin": "rr"}


@dataclasses.dataclass(frozen=True)
class ServiceSpec:
    name: str = "service"
    model: str = "llama3.2-1b"
    trace: str = "aws-3"
    resources: ResourceSpec = dataclasses.field(default_factory=ResourceSpec)
    replica_policy: ReplicaPolicySpec = dataclasses.field(
        default_factory=ReplicaPolicySpec)
    autoscaler: AutoscalerSpec = dataclasses.field(
        default_factory=AutoscalerSpec)
    workload: WorkloadSpec = dataclasses.field(default_factory=WorkloadSpec)
    observability: ObservabilitySpec = dataclasses.field(
        default_factory=ObservabilitySpec)
    sim: SimSpec = dataclasses.field(default_factory=SimSpec)
    load_balancer: str = "least_loaded"
    sweep: Optional[SweepSpec] = None

    def __post_init__(self) -> None:
        _require(self.load_balancer in LB_NAMES,
                 f"load_balancer must be one of {sorted(LB_NAMES)}, got "
                 f"{self.load_balancer!r}")


def _section(d: Mapping[str, Any], key: str, cls, where: str = "") -> Any:
    """The dataclass ``cls`` from ``d[key]``, its keys checked."""
    sub = d.get(key, {})
    where = where or key
    if not isinstance(sub, Mapping):
        raise SpecError(f"{where} must be a mapping, got {type(sub).__name__}")
    allowed = {f.name for f in dataclasses.fields(cls)}
    unknown = set(sub) - allowed
    _require(not unknown, f"{where} has keys {sorted(unknown)} the port does "
             f"not read; allowed: {sorted(allowed)}")
    return cls(**sub)


def _sweep_policy(entry: Any) -> ReplicaPolicySpec:
    if isinstance(entry, str):
        return ReplicaPolicySpec(name=entry)
    if isinstance(entry, Mapping):
        return _section({"p": entry}, "p", ReplicaPolicySpec,
                        "sweep.policies entry")
    raise SpecError(f"sweep.policies entries must be policy names or "
                    f"mappings, got {entry!r}")


def spec_from_dict(d: Mapping[str, Any]) -> ServiceSpec:
    """A ``ServiceSpec`` from a spec dict (the top-level ``service:``
    wrapper is optional)."""
    if not isinstance(d, Mapping):
        raise SpecError(f"service spec must be a mapping, got "
                        f"{type(d).__name__}")
    if isinstance(d.get("service"), Mapping):
        d = d["service"]
    top = ("name", "model", "trace", "load_balancer")
    sections = {"resources": ResourceSpec, "replica_policy": ReplicaPolicySpec,
                "autoscaler": AutoscalerSpec, "workload": WorkloadSpec,
                "observability": ObservabilitySpec, "sim": SimSpec}
    unknown = set(d) - set(top) - set(sections) - {"sweep"}
    _require(not unknown, f"service spec has keys {sorted(unknown)} the port "
             f"does not read; allowed: "
             f"{sorted((*top, *sections, 'sweep'))}")
    try:
        kw: Dict[str, Any] = {k: d[k] for k in top if k in d}
        for key, cls in sections.items():
            kw[key] = _section(d, key, cls)
        if d.get("sweep") is not None:
            sw = d["sweep"]
            _require(isinstance(sw, Mapping), "sweep must be a mapping")
            unknown = set(sw) - {"policies", "traces", "seeds"}
            _require(not unknown, f"sweep has keys {sorted(unknown)} the "
                     "port does not read; allowed: ['policies', 'seeds', "
                     "'traces']")
            kw["sweep"] = SweepSpec(
                policies=tuple(_sweep_policy(e) for e in sw.get("policies", ())),
                traces=tuple(sw.get("traces", ())),
                seeds=tuple(sw.get("seeds", ())),
            )
        return ServiceSpec(**kw)
    except TypeError as e:
        raise SpecError(f"malformed service spec: {e}") from e
