"""Compile a ``ServiceSpec`` into a runnable scenario-engine cell: the port's
own copy of the part of ``repro.service.builder`` (``build_service``,
``build_requests``, ``resolve_zones``) that a scenario matrix uses.

``build_cell`` assembles trace x catalog x policy x autoscaler x balancer x
request tape into one ``TorchServingEngine``, as ``build_service`` does
with ``sim.engine: jax``: the same zones, the same policy knobs, the same
autoscaler, the same tape, the same ``SimConfig``.  A prepared trace or a
shared request tape may be passed in.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.cluster.catalog import Catalog, default_catalog
from repro_torch.cluster.simulator import SimConfig
from repro_torch.cluster.traces import SpotTrace, load_trace
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.autoscaler import Autoscaler, ConstantTarget, LoadAutoscaler
from repro_torch.core.policy import Policy, policy_class
from repro_torch.serving.torchengine.engine import TorchServingEngine
from repro_torch.service.spec import LB_NAMES, ServiceSpec, SpecError
from repro_torch.workloads.arrivals import Request, make_workload

__all__ = ["build_cell", "build_requests", "resolve_zones"]


def resolve_zones(trace: SpotTrace, catalog: Catalog) -> List[str]:
    """The zones of ``trace`` the catalog knows (a trace file may carry
    zones outside the default universe); none is a spec error."""
    known = {z.name for z in catalog.zones}
    out = [z for z in trace.zones if z in known]
    if not out:
        raise SpecError(f"no zone of trace {trace.name!r} is in the catalog "
                        f"(trace zones: {list(trace.zones)})")
    return out


def _build_policy(spec: ServiceSpec) -> Policy:
    name = spec.replica_policy.name
    try:
        cls = policy_class(name)
    except KeyError as e:
        raise SpecError(f"replica_policy.name: {e.args[0]}") from None
    kwargs = spec.replica_policy.policy_kwargs()
    try:
        return cls(**kwargs)
    except (TypeError, ValueError) as e:
        raise SpecError(f"replica_policy {name!r} rejected its knobs "
                        f"{kwargs}: {e}") from e


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


def build_requests(spec: ServiceSpec) -> List[Request]:
    """The spec's request tape, arrivals over ``[0, duration - drain)``."""
    w = spec.workload
    kw = dict(w.args)
    kw["seed"] = w.seed
    kw.setdefault("rate_per_s", w.rate_per_s)
    horizon = spec.sim.duration_s - spec.sim.drain_s
    if horizon <= 0:
        raise SpecError(
            f"sim.duration_hours ({spec.sim.duration_s:g}s) must exceed "
            f"sim.drain_s ({spec.sim.drain_s:g}s) to leave room for arrivals")
    return make_workload(w.kind, **kw).generate(horizon)


def build_cell(
    spec: ServiceSpec,
    *,
    trace: Optional[SpotTrace] = None,
    catalog: Optional[Catalog] = None,
    requests: Optional[Sequence[Request]] = None,
) -> TorchServingEngine:
    """One single-run spec -> a fresh ``TorchServingEngine``; run it over
    ``spec.sim.duration_s``."""
    if spec.sweep is not None:
        raise SpecError("build_cell takes a single-run spec; expand the "
                        "sweep with repro_torch.experiments.expand_sweep")
    if spec.model not in ARCH_IDS:
        raise SpecError(f"unknown model {spec.model!r}; available: "
                        f"{list(ARCH_IDS)}")
    catalog = catalog or default_catalog()
    try:
        catalog.instance_type(spec.resources.instance_type)
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
    zones = resolve_zones(trace, catalog)
    if tuple(zones) != tuple(trace.zones):
        trace = trace.slice_zones(zones)
    sim = spec.sim
    return TorchServingEngine(
        trace,
        _build_policy(spec),
        list(requests) if requests is not None else build_requests(spec),
        get_config(spec.model),
        itype=spec.resources.instance_type,
        catalog=catalog,
        autoscaler=_build_autoscaler(spec),
        lb=LB_NAMES[spec.load_balancer],
        sim_config=SimConfig(
            itype=spec.resources.instance_type,
            cold_start_s=sim.cold_start_s,
            control_interval_s=sim.control_interval_s,
            warning_enabled=sim.warning_enabled,
            seed=sim.seed,
        ),
        timeout_s=sim.timeout_s,
        sub_step_s=sim.sub_step_s,
        workload_name=spec.workload.kind,
        concurrency=sim.concurrency,
        trace_on=spec.observability.trace_sample > 0.0,
    )
