"""Compile a ``ServiceSpec`` into a runnable service: the port's own copy
of ``repro.service.builder``.

``build_service`` assembles trace x catalog x policy x autoscaler x
balancer x request tape x latency model into one engine, picked by
``sim.engine``: ``vector`` is the port's host engine (the oracle,
``VectorizedServingEngine``), ``legacy`` the per-request
``ServingSimulator``, ``jax`` the two-phase ``TorchServingEngine`` whose
data plane runs on the card (a token-model cell runs on the host engine).
``sim.replica_model: token`` gets the ``serving:`` section's
``TokenSchedulerConfig``, and the ``migration:`` section attaches to token
cells only.  The ``forecast:`` section goes to the forecast-consuming
policies (``risk_spothedge``), and the Omniscient oracle gets its plan
solved on the (filtered) trace before the run.  The ``observability:``
section becomes the run's ``ObsRecorder``, shared by the engine, its
cluster and its migration runtime, and the registry is scoped to the run
while the latency model is built.  A prepared trace, a catalog or a shared request tape may be passed
in.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import torch

from repro_torch.cluster.catalog import Catalog, default_catalog
from repro_torch.cluster.simulator import SimConfig
from repro_torch.cluster.traces import SpotTrace, load_trace
from repro_torch.configs import get_config
from repro_torch.core.autoscaler import Autoscaler, ConstantTarget, LoadAutoscaler
from repro_torch.core.omniscient import solve_omniscient
from repro_torch.core.policy import Policy, policy_class
from repro_torch.models.config import ModelConfig
from repro_torch.obs.recorder import ObsRecorder
from repro_torch.obs.registry import use_registry
from repro_torch.obs.slo import SLOBurnConfig
from repro_torch.serving.engine import VectorizedServingEngine
from repro_torch.serving.latency import make_latency_model
from repro_torch.serving.load_balancer import (
    LeastLoadedBalancer,
    LoadBalancer,
    RoundRobinBalancer,
)
from repro_torch.serving.result import ServingResult
from repro_torch.serving.sim import ServingSimulator
from repro_torch.serving.token.config import TokenSchedulerConfig
from repro_torch.serving.torchengine.engine import TorchServingEngine
from repro_torch.service.spec import ResourceSpec, ServiceSpec, SpecError
from repro_torch.workloads.arrivals import Request, make_workload

__all__ = ["ENTRY_ENGINE", "ResolvedService", "build_requests",
           "build_service", "check_host_device", "resolve_zones",
           "with_engine"]

#: the engine of the port's entry points (``Service``, ``ScenarioSuite.run``,
#: the serve CLI) unless the caller names another: phase B on the card
ENTRY_ENGINE = "jax"


def with_engine(spec: ServiceSpec, engine: Optional[str]) -> ServiceSpec:
    """``spec`` with ``sim.engine`` set to ``engine`` (``None``: as it is).
    ``vector`` and ``legacy`` are host engines, ``jax`` phase B on a device;
    the spec's own checks refuse any other name."""
    if engine is None or spec.sim.engine == engine:
        return spec
    return dataclasses.replace(
        spec, sim=dataclasses.replace(spec.sim, engine=engine))


def check_host_device(spec: ServiceSpec,
                      device: Union[str, torch.device, None]) -> None:
    """The host engine runs on the host: a device other than the CPU is
    refused, never ignored."""
    if (spec.sim.engine != "jax" and device is not None
            and torch.device(device).type != "cpu"):
        raise ValueError(
            f"device={str(device)!r} with sim.engine {spec.sim.engine!r}: "
            "the host engine runs on the CPU; use engine 'jax' for phase B "
            f"on {device}")


def resolve_zones(resources: ResourceSpec, trace: SpotTrace,
                  catalog: Catalog) -> List[str]:
    """The zones of ``trace`` that pass the ``any_of`` / ``exclude_zones``
    filter.  Zones the catalog does not know are skipped (a trace file may
    carry zones outside the default universe); none left is a spec
    error."""
    out: List[str] = []
    for name in trace.zones:
        try:
            z = catalog.zone(name)
        except KeyError:
            continue
        if resources.allows(z.cloud, z.region, z.name):
            out.append(name)
    if not out:
        raise SpecError(
            f"resources filter matches no zone of trace {trace.name!r} "
            f"(trace zones: {list(trace.zones)}); loosen any_of / "
            "exclude_zones")
    return out


def _build_policy(spec: ServiceSpec, trace: SpotTrace,
                  catalog: Catalog) -> Policy:
    name = spec.replica_policy.name
    try:
        cls = policy_class(name)
    except KeyError as e:
        raise SpecError(f"replica_policy.name: {e.args[0]}") from None
    kwargs = spec.replica_policy.policy_kwargs()
    # the forecast: section applies to forecast-consuming policies only;
    # the vanilla cells of a mixed sweep ignore it
    if spec.forecast is not None and getattr(cls, "uses_forecast", False):
        kwargs.update(spec.forecast.policy_kwargs())
    try:
        policy = cls(**kwargs)
    except (TypeError, ValueError) as e:
        raise SpecError(f"replica_policy {name!r} rejected its knobs "
                        f"{kwargs}: {e}") from e
    if name == "omniscient":
        # the oracle plans over the whole trace ahead of time (offline ILP)
        itype = spec.resources.instance_type
        k = (catalog.od_price(itype, trace.zones[0])
             / catalog.spot_price(itype, trace.zones[0]))
        policy.attach_schedule(solve_omniscient(
            trace, n_target=spec.autoscaler.target,
            cold_start_s=spec.sim.cold_start_s, k_ratio=k,
            avail_target=0.99))
    return policy


def _build_autoscaler(spec: ServiceSpec) -> Autoscaler:
    a = spec.autoscaler
    if a.kind == "constant":
        return ConstantTarget(a.target)
    return LoadAutoscaler(
        a.qps_per_replica,
        window_s=a.window_s,
        upscale_delay_s=a.upscale_delay_s,
        downscale_delay_s=a.downscale_delay_s,
        min_replicas=a.min_replicas,
        max_replicas=a.max_replicas,
        initial_target=a.target,
    )


def _build_lb(spec: ServiceSpec) -> LoadBalancer:
    if spec.load_balancer == "round_robin":
        return RoundRobinBalancer()
    return LeastLoadedBalancer()


def build_requests(spec: ServiceSpec) -> List[Request]:
    """The spec's request tape, arrivals over ``[0, duration - drain)``;
    empty for ``workload: none``.  The spec's rate is Poisson's
    ``rate_per_s`` and Arena's / MAF's ``base_rate_per_s``."""
    w = spec.workload
    if w.kind == "none":
        return []
    kw = dict(w.args)
    kw["seed"] = w.seed
    kw.setdefault("rate_per_s" if w.kind == "poisson" else "base_rate_per_s",
                  w.rate_per_s)
    horizon = spec.sim.duration_s - spec.sim.drain_s
    if horizon <= 0:
        raise SpecError(
            f"sim.duration_hours ({spec.sim.duration_hours:g}h = "
            f"{spec.sim.duration_s:g}s) must exceed sim.drain_s "
            f"({spec.sim.drain_s:g}s) to leave room for arrivals")
    try:
        workload = make_workload(w.kind, **kw)
    except (TypeError, ValueError) as e:
        raise SpecError(f"workload {w.kind!r} rejected its args "
                        f"{sorted(w.args)}: {e}") from e
    return workload.generate(horizon)


Engine = Union[VectorizedServingEngine, ServingSimulator, TorchServingEngine]


@dataclasses.dataclass
class ResolvedService:
    """Everything ``build_service`` wired together, inspectable."""

    spec: ServiceSpec
    trace: SpotTrace
    catalog: Catalog
    model_config: ModelConfig
    zones: List[str]
    policy: Policy
    autoscaler: Autoscaler
    load_balancer: LoadBalancer
    requests: List[Request]
    simulator: Engine             # per spec.sim.engine
    # the run's event recorder and metrics registry, from the spec's
    # observability: section
    obs: Optional[ObsRecorder] = None

    def run(self, duration_s: Optional[float] = None, *,
            device: Union[str, torch.device, None] = None) -> ServingResult:
        """Run the engine over ``duration_s`` (default the spec's horizon);
        ``device`` is phase B's under ``sim.engine: jax`` (default CUDA);
        the host engine takes none but the CPU."""
        check_host_device(self.spec, device)
        dur = self.spec.sim.duration_s if duration_s is None else duration_s
        if isinstance(self.simulator, TorchServingEngine):
            return self.simulator.run(dur, device=device)
        return self.simulator.run(dur)


def build_service(
    spec: ServiceSpec,
    *,
    trace: Optional[SpotTrace] = None,
    catalog: Optional[Catalog] = None,
    requests: Optional[Sequence[Request]] = None,
) -> ResolvedService:
    """Spec -> resolved, runnable service (a fresh engine each call)."""
    catalog = catalog or default_catalog()
    try:
        itype = catalog.instance_type(spec.resources.instance_type)
    except KeyError:
        raise SpecError(
            f"unknown resources.instance_type "
            f"{spec.resources.instance_type!r}; catalog has "
            f"{sorted(t.name for t in catalog.instance_types)}") from None
    if trace is None:
        try:
            trace = load_trace(spec.trace)
        except (KeyError, OSError) as e:
            raise SpecError(f"trace {spec.trace!r}: {e}") from e
    zones = resolve_zones(spec.resources, trace, catalog)
    if tuple(zones) != tuple(trace.zones):
        trace = trace.slice_zones(zones)
    sim = spec.sim
    if sim.preemption_warning_s is not None:
        # a copy: named traces are cached for the process
        trace = dataclasses.replace(
            trace, preemption_warning_s=sim.preemption_warning_s)
    policy = _build_policy(spec, trace, catalog)
    autoscaler = _build_autoscaler(spec)
    lb = _build_lb(spec)
    reqs = list(requests) if requests is not None else build_requests(spec)
    # with no request path there is nothing to do between control ticks:
    # step the request loop at the control cadence
    sub_step = (max(sim.sub_step_s, sim.control_interval_s)
                if spec.workload.kind == "none" and requests is None
                else sim.sub_step_s)
    try:
        cfg = get_config(spec.model)
    except KeyError as e:
        raise SpecError(f"model: {e.args[0]}") from None
    o = spec.observability
    obs = ObsRecorder(
        detail=o.detail, window_s=o.window_s, trace_sample=o.trace_sample,
        slo_burn=SLOBurnConfig(**dataclasses.asdict(o.slo_burn)))
    # the run's registry takes the factory's counters (the profile
    # fallback), not a process-wide one
    with use_registry(obs.registry):
        latency_model = make_latency_model(
            cfg, itype, model_id=spec.model, source=spec.latency.source,
            profile=spec.latency.profile)
    if sim.engine == "jax":
        engine_cls = TorchServingEngine
    elif sim.engine == "legacy":
        engine_cls = ServingSimulator
    else:
        engine_cls = VectorizedServingEngine
    token = sim.replica_model == "token"
    serving = spec.serving
    simulator = engine_cls(
        trace,
        policy,
        reqs,
        cfg,
        itype=spec.resources.instance_type,
        catalog=catalog,
        autoscaler=autoscaler,
        lb=lb,
        sim_config=SimConfig(
            itype=spec.resources.instance_type,
            cold_start_s=sim.cold_start_s,
            control_interval_s=sim.control_interval_s,
            warning_enabled=sim.warning_enabled,
            seed=sim.seed,
            record_series=sim.record_series,
        ),
        timeout_s=sim.timeout_s,
        sub_step_s=sub_step,
        workload_name=spec.workload.kind,
        concurrency=sim.concurrency,
        concurrency_cap=spec.serving.concurrency_cap,
        latency_model=latency_model,
        replica_model=sim.replica_model,
        token_scheduler=TokenSchedulerConfig(
            slo_ttft_s=serving.slo.ttft_s,
            slo_tpot_s=serving.slo.tpot_s,
            prefill_chunk_tokens=serving.prefill_chunk_tokens,
            max_batch=serving.max_batch,
            kv_budget_tokens=serving.kv_budget_tokens,
            iter_overhead_s=serving.iter_overhead_s,
            goodput_window_s=serving.goodput_window_s,
        ) if token else None,
        # a request-model cell of a mixed sweep has no KV to migrate
        migration=spec.migration if token else None,
        obs=obs,
    )
    return ResolvedService(
        spec=spec, trace=trace, catalog=catalog, model_config=cfg,
        zones=zones, policy=policy, autoscaler=autoscaler, load_balancer=lb,
        requests=reqs, simulator=simulator, obs=obs)
