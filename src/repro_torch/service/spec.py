"""The declarative service spec: the port's own copy of
``repro.service.spec``.

A ``ServiceSpec`` names the model, the spot trace, the ``any_of``
resource filter, the replica policy and its knobs, the autoscaler, the
request workload, the latency source and the simulation horizon.  Every
section is a frozen dataclass with the reference's fields, defaults,
checks and ``to_dict``, so a spec serialises to the reference's dict and
loads in either package; a malformed one raises ``SpecError`` (a
``ValueError``) naming the field.  The ``forecast:`` section is a
``ForecastSpec`` that configures the forecast-consuming policies
(``risk_spothedge``); the ``observability:`` section runs whole
(``repro_torch.obs``).

``sim.engine`` takes the reference's names: ``vector`` is the host engine
(the port's oracle, ``repro_torch.serving.engine``), ``legacy`` the
per-request ``ServingSimulator`` (``repro_torch.serving.sim``), ``jax`` the
batched array engine (``TorchServingEngine``, phase B on the card; a
token-model cell runs on the host engine, as in the reference).
``sim.replica_model`` picks the request model or the token-level
continuous-batching model, tuned by the ``serving:`` section; the
``migration:`` section is a ``MigrationSpec`` (grace-period KV migration,
token cells only).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple, Union

from repro_torch.migration.config import MigrationSpec
from repro_torch.obs.recorder import DETAIL_LEVELS
from repro_torch.serving.engine import REPLICA_MODELS
from repro_torch.serving.latency import LATENCY_SOURCES

__all__ = [
    "AutoscalerSpec", "ForecastSpec", "LatencySpec", "MigrationSpec",
    "ObservabilitySpec", "PlacementFilter", "ReplicaPolicySpec",
    "ResourceSpec", "SLOBurnSpec", "SLOSpec", "ServiceSpec", "ServingSpec",
    "SimSpec", "SpecError", "SweepSpec", "WorkloadSpec",
]


class SpecError(ValueError):
    """A malformed spec; the message names the field."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise SpecError(msg)


def _clean(d: Dict[str, Any]) -> Dict[str, Any]:
    """Drop ``None`` values so to_dict output stays minimal and re-loadable."""
    return {k: v for k, v in d.items() if v is not None}


# ---------------------------------------------------------------------------
# resources (Listing 1: resources + any_of)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlacementFilter:
    """One ``any_of`` entry: a zone matches if every set field matches."""

    cloud: Optional[str] = None
    region: Optional[str] = None
    zone: Optional[str] = None

    def matches(self, cloud: str, region: str, zone: str) -> bool:
        return (
            (self.cloud is None or self.cloud == cloud)
            and (self.region is None or self.region == region)
            and (self.zone is None or self.zone == zone)
        )

    def to_dict(self) -> Dict[str, Any]:
        return _clean(dataclasses.asdict(self))

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "PlacementFilter":
        unknown = set(d) - {"cloud", "region", "zone"}
        _require(not unknown, f"any_of entry has unknown keys "
                 f"{sorted(unknown)}; allowed: cloud, region, zone")
        return PlacementFilter(cloud=d.get("cloud"), region=d.get("region"),
                               zone=d.get("zone"))


@dataclasses.dataclass(frozen=True)
class ResourceSpec:
    """What to run on, and where placement is allowed (``any_of=None``:
    every zone of the trace)."""

    instance_type: str = "p3.2xlarge"
    any_of: Optional[Tuple[PlacementFilter, ...]] = None
    exclude_zones: Tuple[str, ...] = ()

    def __post_init__(self) -> None:
        _require(bool(self.instance_type),
                 "resources.instance_type must be a non-empty string")
        if self.any_of is not None:
            _require(len(self.any_of) > 0,
                     "resources.any_of is empty — it would match no zones; "
                     "omit the field to allow every zone of the trace, or "
                     "add at least one {cloud|region|zone} filter")

    def allows(self, cloud: str, region: str, zone: str) -> bool:
        if zone in self.exclude_zones:
            return False
        if self.any_of is None:
            return True
        return any(f.matches(cloud, region, zone) for f in self.any_of)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"instance_type": self.instance_type}
        if self.any_of is not None:
            out["any_of"] = [f.to_dict() for f in self.any_of]
        if self.exclude_zones:
            out["exclude_zones"] = list(self.exclude_zones)
        return out


# ---------------------------------------------------------------------------
# replica policy, autoscaler, workload, latency
# ---------------------------------------------------------------------------


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

    def __post_init__(self) -> None:
        _require(bool(self.name), "replica_policy.name must be set")
        for name in ("overprovision", "min_ondemand"):
            v = getattr(self, name)
            _require(v is None or v >= 0,
                     f"replica_policy.{name} must be >= 0, got {v}")

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

    def to_dict(self) -> Dict[str, Any]:
        out = _clean({"name": self.name, "overprovision": self.overprovision,
                      "dynamic_fallback": self.dynamic_fallback,
                      "min_ondemand": self.min_ondemand})
        if self.args:
            out["args"] = dict(self.args)
        return out


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
                     f"[min_replicas, max_replicas] = [{self.min_replicas}, "
                     f"{self.max_replicas}] for kind='load', got {self.target}")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


WORKLOAD_KINDS = ("poisson", "arena", "maf", "none")


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Request arrivals; ``kind="none"`` runs the control plane alone (no
    request path: availability and cost only)."""

    kind: str = "poisson"
    rate_per_s: float = 0.5
    seed: int = 0
    args: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        _require(self.kind in WORKLOAD_KINDS,
                 f"workload.kind must be one of {list(WORKLOAD_KINDS)}, got "
                 f"{self.kind!r}")
        _require(self.rate_per_s > 0, f"workload.rate_per_s must be "
                 f"positive, got {self.rate_per_s}")

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"kind": self.kind, "rate_per_s": self.rate_per_s,
                               "seed": self.seed}
        if self.args:
            out["args"] = dict(self.args)
        return out


@dataclasses.dataclass(frozen=True)
class LatencySpec:
    """Where replica service times come from: ``roofline`` (the analytic
    model) or ``profile`` (a step-time table of ``repro_torch.profiles`` at
    ``profile``, a file or a directory; default ``artifacts/profiles/``)."""

    source: str = "roofline"
    profile: Optional[str] = None

    def __post_init__(self) -> None:
        _require(self.source in LATENCY_SOURCES,
                 f"latency.source must be one of {list(LATENCY_SOURCES)}, "
                 f"got {self.source!r}")
        _require(self.profile is None or bool(self.profile),
                 "latency.profile must be a non-empty path when set")

    def to_dict(self) -> Dict[str, Any]:
        return _clean({"source": self.source, "profile": self.profile})


# ---------------------------------------------------------------------------
# the serving data plane, and observability
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """The token-level model's TTFT / TPOT targets: a request attains the
    SLO when both are within them, and goodput counts those requests."""

    ttft_s: float = 10.0
    tpot_s: float = 0.2

    def __post_init__(self) -> None:
        _require(self.ttft_s > 0,
                 f"serving.slo.ttft_s must be positive, got {self.ttft_s}")
        _require(self.tpot_s > 0,
                 f"serving.slo.tpot_s must be positive, got {self.tpot_s}")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ServingSpec:
    """Replica data-plane knobs.  ``concurrency_cap`` bounds the request
    model's model-derived concurrency (when ``sim.concurrency`` is null);
    the other fields configure the token-level model: the SLO, the prefill
    chunk an iteration takes, the batch and KV caps (the KV budget is
    otherwise the HBM left after the weights), a per-iteration overhead and
    the goodput window.  The loader also takes ``replica_model`` here, as
    another way to set ``sim.replica_model``."""

    slo: SLOSpec = dataclasses.field(default_factory=SLOSpec)
    concurrency_cap: int = 16
    prefill_chunk_tokens: int = 512
    max_batch: Optional[int] = None
    kv_budget_tokens: Optional[int] = None
    iter_overhead_s: float = 0.0
    goodput_window_s: float = 60.0

    def __post_init__(self) -> None:
        _require(self.concurrency_cap >= 1, f"serving.concurrency_cap must "
                 f"be >= 1, got {self.concurrency_cap}")
        _require(self.prefill_chunk_tokens >= 1, f"serving.prefill_chunk_"
                 f"tokens must be >= 1, got {self.prefill_chunk_tokens}")
        _require(self.max_batch is None or self.max_batch >= 1,
                 f"serving.max_batch must be >= 1, got {self.max_batch}")
        _require(self.kv_budget_tokens is None or self.kv_budget_tokens >= 1,
                 f"serving.kv_budget_tokens must be >= 1, got "
                 f"{self.kv_budget_tokens}")
        _require(self.iter_overhead_s >= 0, f"serving.iter_overhead_s must "
                 f"be >= 0, got {self.iter_overhead_s}")
        _require(self.goodput_window_s > 0, f"serving.goodput_window_s must "
                 f"be positive, got {self.goodput_window_s}")

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "slo": self.slo.to_dict(),
            "concurrency_cap": self.concurrency_cap,
            "prefill_chunk_tokens": self.prefill_chunk_tokens,
            "iter_overhead_s": self.iter_overhead_s,
            "goodput_window_s": self.goodput_window_s,
        }
        if self.max_batch is not None:
            out["max_batch"] = self.max_batch
        if self.kv_budget_tokens is not None:
            out["kv_budget_tokens"] = self.kv_budget_tokens
        return out


@dataclasses.dataclass(frozen=True)
class SLOBurnSpec:
    """Burn-rate alerting knobs (``observability.slo_burn``, detail
    ``full``): the SLO attainment ``target`` whose error budget the burn
    rates are measured against, the trailing ``fast_window_s`` /
    ``slow_window_s`` and their alert thresholds (5 min at 14.4x and 1 h at
    6x by default)."""

    target: float = 0.99
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    fast_threshold: float = 14.4
    slow_threshold: float = 6.0

    def __post_init__(self) -> None:
        _require(0.0 < self.target < 1.0, f"observability.slo_burn.target "
                 f"must be in (0, 1), got {self.target}")
        _require(0 < self.fast_window_s <= self.slow_window_s,
                 "observability.slo_burn windows must be positive with "
                 "fast_window_s <= slow_window_s")
        _require(self.fast_threshold > 0 and self.slow_threshold > 0,
                 "observability.slo_burn thresholds must be positive")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ObservabilitySpec:
    """What the run records and exports (``repro_torch.obs``).

    ``off`` records nothing; ``decisions`` (the default) records the control
    plane's events (policy decisions with their reasons, replica lifecycle,
    warnings, migration plans), the registry's metrics and the sampled
    request spans; ``full`` adds a window sample and an SLO burn event every
    ``window_s`` and has ``Service`` write the event log (``jsonl``), the
    span log and the Perfetto timeline (``chrome_trace``) under
    ``out_dir``.  ``trace_sample`` is the span sampling rate, keyed on the
    request's run ordinal (no RNG, the same set in every engine; phase B
    carries span timelines exactly when it samples), and ``slo_burn``
    configures the burn monitor.  Recording never changes a metric."""

    detail: str = "decisions"
    out_dir: str = "artifacts/obs"
    jsonl: bool = True
    chrome_trace: bool = True
    window_s: float = 60.0
    trace_sample: float = 0.01
    slo_burn: SLOBurnSpec = dataclasses.field(default_factory=SLOBurnSpec)

    def __post_init__(self) -> None:
        _require(self.detail in DETAIL_LEVELS, f"observability.detail must "
                 f"be one of {list(DETAIL_LEVELS)}, got {self.detail!r}")
        _require(bool(self.out_dir),
                 "observability.out_dir must be a non-empty path")
        _require(self.window_s > 0, f"observability.window_s must be "
                 f"positive, got {self.window_s}")
        _require(0.0 <= self.trace_sample <= 1.0, f"observability."
                 f"trace_sample must be in [0, 1], got {self.trace_sample}")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# simulation fabric and the sweep
# ---------------------------------------------------------------------------


ENGINE_NAMES = ("vector", "legacy", "jax")


@dataclasses.dataclass(frozen=True)
class SimSpec:
    """Horizon, cold start, control cadence, SLO and engine of one run."""

    duration_hours: float = 4.0
    cold_start_s: float = 183.0
    control_interval_s: float = 15.0
    timeout_s: float = 100.0
    sub_step_s: float = 1.0
    concurrency: Optional[int] = 4
    drain_s: float = 600.0        # no arrivals this long before the horizon
    warning_enabled: bool = True
    # the cloud's advance-warning lead (s) for this run's trace; None keeps
    # the catalog's per-cloud default
    preemption_warning_s: Optional[float] = None
    seed: int = 0
    record_series: bool = True
    engine: str = "vector"
    replica_model: str = "request"

    def __post_init__(self) -> None:
        _require(self.engine in ENGINE_NAMES, f"sim.engine must be one of "
                 f"{list(ENGINE_NAMES)}, got {self.engine!r}")
        _require(self.replica_model in REPLICA_MODELS, f"sim.replica_model "
                 f"must be one of {list(REPLICA_MODELS)}, got "
                 f"{self.replica_model!r}")
        for name in ("duration_hours", "control_interval_s", "timeout_s",
                     "sub_step_s"):
            v = getattr(self, name)
            _require(v > 0, f"sim.{name} must be positive, got {v}")
        for name in ("cold_start_s", "drain_s"):
            v = getattr(self, name)
            _require(v >= 0, f"sim.{name} must be >= 0, got {v}")
        _require(self.concurrency is None or self.concurrency > 0,
                 f"sim.concurrency must be positive, got {self.concurrency}")
        _require(self.preemption_warning_s is None
                 or self.preemption_warning_s >= 0,
                 f"sim.preemption_warning_s must be >= 0, got "
                 f"{self.preemption_warning_s}")

    @property
    def duration_s(self) -> float:
        return self.duration_hours * 3600.0

    def to_dict(self) -> Dict[str, Any]:
        # keeps an explicit None (concurrency: null is model-derived)
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# forecasting (spot-availability predictors, repro_torch.forecast)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ForecastSpec:
    """Which spot-availability forecaster a risk-aware policy consults.

    Only policies declaring ``uses_forecast`` (``risk_spothedge``) read the
    section; the others ignore it, so one sweep can mix risk-aware and
    vanilla cells.  ``name`` picks the estimator (``persistence`` /
    ``ewma`` / ``markov``), ``horizon_s`` is the look-ahead the policy
    prices risk over, ``risk_threshold`` / ``calm_threshold`` bound its
    surge and trim regimes, and ``args`` goes verbatim to the forecaster's
    constructor (``smoothing`` for ``markov``)."""

    name: str = "markov"
    horizon_s: Optional[float] = None
    risk_threshold: Optional[float] = None
    calm_threshold: Optional[float] = None
    args: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        _require(bool(self.name), "forecast.name must be set")
        _require(self.horizon_s is None or self.horizon_s > 0,
                 f"forecast.horizon_s must be positive, got {self.horizon_s}")
        for name in ("risk_threshold", "calm_threshold"):
            v = getattr(self, name)
            _require(v is None or 0.0 <= v <= 1.0,
                     f"forecast.{name} must be a probability, got {v}")

    def policy_kwargs(self) -> Dict[str, Any]:
        """Constructor kwargs for a forecast-consuming policy."""
        kw: Dict[str, Any] = {"forecaster": self.name}
        if self.args:
            kw["forecaster_args"] = dict(self.args)
        for name in ("horizon_s", "risk_threshold", "calm_threshold"):
            if getattr(self, name) is not None:
                kw[name] = getattr(self, name)
        return kw

    def to_dict(self) -> Dict[str, Any]:
        out = _clean({"name": self.name, "horizon_s": self.horizon_s,
                      "risk_threshold": self.risk_threshold,
                      "calm_threshold": self.calm_threshold})
        if self.args:
            out["args"] = dict(self.args)
        return out


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A scenario grid ``policies x traces x workloads x seeds x
    forecasters x replica_models x migration``; an empty axis falls back to
    the base spec's single value.  A seed overrides ``workload.seed``, a
    forecaster ``forecast.name`` (policies that ignore the forecast keep
    one cell), a replica model ``sim.replica_model`` (a request- against a
    token-model cell on one tape), and a migration entry, a bool or a
    ``MigrationSpec``, toggles or replaces the base spec's ``migration``
    section."""

    policies: Tuple[ReplicaPolicySpec, ...] = ()
    traces: Tuple[str, ...] = ()
    workloads: Tuple[WorkloadSpec, ...] = ()
    seeds: Tuple[int, ...] = ()
    forecasters: Tuple[str, ...] = ()
    replica_models: Tuple[str, ...] = ()
    migration: Tuple[Union[bool, MigrationSpec], ...] = ()

    def __post_init__(self) -> None:
        for m in self.migration:
            _require(isinstance(m, (bool, MigrationSpec)),
                     "sweep.migration entries must be booleans or migration "
                     f"mappings, got {m!r}")
        for tr in self.traces:
            _require(bool(tr), "sweep.traces entries must be non-empty strings")
        for s in self.seeds:
            _require(isinstance(s, int) and not isinstance(s, bool),
                     f"sweep.seeds entries must be ints, got {s!r}")
        for fc in self.forecasters:
            _require(bool(fc),
                     "sweep.forecasters entries must be non-empty strings")
        for rm in self.replica_models:
            _require(rm in REPLICA_MODELS, f"sweep.replica_models entries "
                     f"must be one of {list(REPLICA_MODELS)}, got {rm!r}")

    @property
    def size(self) -> int:
        """Number of scenarios the grid expands to (axes default to 1)."""
        n = 1
        for axis in (self.policies, self.traces, self.workloads, self.seeds,
                     self.forecasters, self.replica_models, self.migration):
            n *= max(len(axis), 1)
        return n

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.policies:
            out["policies"] = [p.to_dict() for p in self.policies]
        if self.traces:
            out["traces"] = list(self.traces)
        if self.workloads:
            out["workloads"] = [w.to_dict() for w in self.workloads]
        if self.seeds:
            out["seeds"] = list(self.seeds)
        if self.forecasters:
            out["forecasters"] = list(self.forecasters)
        if self.replica_models:
            out["replica_models"] = list(self.replica_models)
        if self.migration:
            out["migration"] = [m if isinstance(m, bool) else m.to_dict()
                                for m in self.migration]
        return out


# ---------------------------------------------------------------------------
# the service spec
# ---------------------------------------------------------------------------


LB_NAMES = ("least_loaded", "round_robin")


@dataclasses.dataclass(frozen=True)
class ServiceSpec:
    """The complete declarative description of one service run."""

    name: str = "service"
    model: str = "llama3.2-1b"
    trace: str = "aws-3"
    resources: ResourceSpec = dataclasses.field(default_factory=ResourceSpec)
    replica_policy: ReplicaPolicySpec = dataclasses.field(
        default_factory=ReplicaPolicySpec)
    autoscaler: AutoscalerSpec = dataclasses.field(
        default_factory=AutoscalerSpec)
    workload: WorkloadSpec = dataclasses.field(default_factory=WorkloadSpec)
    latency: LatencySpec = dataclasses.field(default_factory=LatencySpec)
    forecast: Optional[ForecastSpec] = None
    serving: ServingSpec = dataclasses.field(default_factory=ServingSpec)
    observability: ObservabilitySpec = dataclasses.field(
        default_factory=ObservabilitySpec)
    migration: Optional[MigrationSpec] = None
    sim: SimSpec = dataclasses.field(default_factory=SimSpec)
    load_balancer: str = "least_loaded"
    sweep: Optional[SweepSpec] = None

    def __post_init__(self) -> None:
        for name in ("name", "model", "trace"):
            _require(bool(getattr(self, name)), f"service.{name} must be set")
        _require(self.load_balancer in LB_NAMES, f"service.load_balancer "
                 f"must be one of {list(LB_NAMES)}, got {self.load_balancer!r}")
        if self.migration is not None and self.migration.enabled:
            _require(self.sim.replica_model == "token" or (
                self.sweep is not None
                and "token" in self.sweep.replica_models),
                "migration.enabled requires the token-level engine: set "
                "sim.replica_model: token (or sweep over replica_models "
                "including 'token'); the request-level model has no KV "
                "state to migrate")

    def validate(self) -> "ServiceSpec":
        """Check the fields against the port's registries (policies,
        forecasters, models, instance types, named traces).  Returns
        self."""
        from repro_torch.cluster.catalog import default_catalog
        from repro_torch.cluster.traces import TraceLibrary
        from repro_torch.configs import ARCH_IDS
        from repro_torch.core.policy import registered_policies
        from repro_torch.forecast.base import registered_forecasters

        policies = registered_policies()
        _require(self.replica_policy.name in policies,
                 f"unknown replica_policy.name {self.replica_policy.name!r}; "
                 f"registered policies: {policies}")
        forecasters = registered_forecasters()
        if self.forecast is not None:
            _require(self.forecast.name in forecasters,
                     f"unknown forecast.name {self.forecast.name!r}; "
                     f"registered forecasters: {forecasters}")
        names = TraceLibrary().names()
        if self.sweep is not None:
            for p in self.sweep.policies:
                _require(p.name in policies, f"unknown sweep policy "
                         f"{p.name!r}; registered policies: {policies}")
            for fc in self.sweep.forecasters:
                _require(fc in forecasters, f"unknown sweep forecaster "
                         f"{fc!r}; registered forecasters: {forecasters}")
            for tr in self.sweep.traces:
                _require(tr in names or tr.endswith((".json", ".npz")),
                         f"unknown sweep trace {tr!r}; named datasets: "
                         f"{names} (or pass a .json/.npz trace file path)")
        _require(self.model in ARCH_IDS,
                 f"unknown model {self.model!r}; available: {list(ARCH_IDS)}")
        catalog = default_catalog()
        try:
            catalog.instance_type(self.resources.instance_type)
        except KeyError:
            raise SpecError(
                f"unknown resources.instance_type "
                f"{self.resources.instance_type!r}; catalog has "
                f"{sorted(t.name for t in catalog.instance_types)}") from None
        _require(self.trace in names or self.trace.endswith((".json", ".npz")),
                 f"unknown trace {self.trace!r}; named datasets: {names} (or "
                 "pass a .json/.npz trace file path)")
        return self

    def to_dict(self) -> Dict[str, Any]:
        out = {
            "name": self.name,
            "model": self.model,
            "trace": self.trace,
            "resources": self.resources.to_dict(),
            "replica_policy": self.replica_policy.to_dict(),
            "autoscaler": self.autoscaler.to_dict(),
            "workload": self.workload.to_dict(),
            "latency": self.latency.to_dict(),
            "serving": self.serving.to_dict(),
            "observability": self.observability.to_dict(),
            "sim": self.sim.to_dict(),
            "load_balancer": self.load_balancer,
        }
        if self.forecast is not None:
            out["forecast"] = self.forecast.to_dict()
        if self.migration is not None:
            out["migration"] = self.migration.to_dict()
        if self.sweep is not None:
            out["sweep"] = self.sweep.to_dict()
        return out
