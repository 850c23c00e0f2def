"""The user-facing facade, a declared service to run and inspect: the
port's own copy of ``repro.service.service``.

    from repro_torch.service import Service

    svc = Service.from_json("service.json")
    result = svc.run()                  # ServingResult
    print(result.summary())
    print(svc.status())

``run()`` compiles the spec through ``build_service``, a fresh engine per
run.  The engine is the ``Service``'s ``engine`` argument, as the serve
CLI's ``--engine`` is: ``jax`` by default, whatever the spec's
``sim.engine`` says, so the data plane (phase B) runs on the card unless
the caller passes ``device="cpu"``; without CUDA the default raises
before phase A starts.  ``engine="vector"`` asks for the host engine (and
refuses a device other than the CPU); ``engine=None`` keeps the spec's
own ``sim.engine``; ``engine="legacy"`` is the per-request
``ServingSimulator``, a host engine as ``vector`` is.  Under ``jax`` a
token-model spec runs on the host engine, as in the reference (its
``status()`` says ``token_on_host``).  At observability detail ``full`` a
run writes its artifacts under ``observability.out_dir``:
``<name>.events.jsonl``, ``<name>.spans.jsonl`` and ``<name>.trace.json``
(read them with ``python -m repro_torch.obs``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Sequence, Union

import torch

from repro_torch import resolve_device
from repro_torch.cluster.catalog import Catalog
from repro_torch.cluster.traces import SpotTrace
from repro_torch.obs.export import write_chrome_trace, write_jsonl
from repro_torch.serving.result import ServingResult
from repro_torch.serving.torchengine.engine import TorchServingEngine
from repro_torch.service.builder import (
    ENTRY_ENGINE,
    ResolvedService,
    build_service,
    check_host_device,
    with_engine,
)
from repro_torch.service.loader import load_spec, spec_from_json, spec_from_yaml
from repro_torch.service.spec import ServiceSpec
from repro_torch.workloads.arrivals import Request

__all__ = ["Service"]


class Service:
    """One declared service: spec in, ``ServingResult`` out."""

    def __init__(
        self,
        spec: Union[ServiceSpec, Mapping[str, Any], str],
        *,
        trace: Optional[SpotTrace] = None,
        catalog: Optional[Catalog] = None,
        requests: Optional[Sequence[Request]] = None,
        engine: Optional[str] = ENTRY_ENGINE,
    ) -> None:
        self.spec = with_engine(load_spec(spec), engine)
        self._trace_override = trace
        self._catalog_override = catalog
        self._requests_override = requests
        self._resolved: Optional[ResolvedService] = None
        self._resolved_unused = False   # resolved but not yet run
        self.result: Optional[ServingResult] = None
        #: artifact kind -> path, written by the last run at detail "full"
        self.artifacts: Dict[str, str] = {}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any], **overrides: Any) -> "Service":
        return cls(dict(d), **overrides)

    @classmethod
    def from_yaml(cls, path_or_text: str, **overrides: Any) -> "Service":
        return cls(spec_from_yaml(path_or_text), **overrides)

    @classmethod
    def from_json(cls, path_or_text: str, **overrides: Any) -> "Service":
        return cls(spec_from_json(path_or_text), **overrides)

    def resolve(self) -> ResolvedService:
        """Compile the spec (a fresh policy, autoscaler and engine)."""
        self._resolved = build_service(
            self.spec,
            trace=self._trace_override,
            catalog=self._catalog_override,
            requests=self._requests_override,
        )
        self._resolved_unused = True
        return self._resolved

    def run(self, duration_s: Optional[float] = None, *,
            device: Union[str, torch.device, None] = None) -> ServingResult:
        """Run the service over its horizon.  ``device`` is phase B's under
        engine ``jax`` (default CUDA), and must be the CPU or ``None`` under
        ``vector``; a pending ``resolve()`` is reused, else a new engine is
        built (engines are single-shot)."""
        # the device is checked before phase A, not after it
        check_host_device(self.spec, device)
        dev = resolve_device(device) if self.spec.sim.engine == "jax" else None
        if self._resolved is not None and self._resolved_unused:
            resolved = self._resolved
        else:
            resolved = self.resolve()
        self._resolved_unused = False
        self.result = resolved.run(duration_s, device=dev)
        self._export_obs(resolved)
        return self.result

    def _export_obs(self, resolved: ResolvedService) -> None:
        """At observability detail ``full``, write the run's event log, span
        log and Chrome trace under ``out_dir``."""
        spec = self.spec.observability
        obs = resolved.obs
        if obs is None or obs.detail != "full":
            return
        if not (spec.jsonl or spec.chrome_trace):
            return
        os.makedirs(spec.out_dir, exist_ok=True)
        stem = os.path.join(spec.out_dir, self.spec.name)
        records = obs.records()
        spans = obs.span_records()
        tok = self.result.token
        self.artifacts = {}
        if spec.jsonl:
            self.artifacts["events"] = write_jsonl(records,
                                                   stem + ".events.jsonl")
            if spans:
                self.artifacts["spans"] = write_jsonl(spans,
                                                      stem + ".spans.jsonl")
        if spec.chrome_trace:
            self.artifacts["trace"] = write_chrome_trace(
                records, stem + ".trace.json", spans=spans or None,
                token_windows=tok.windows if tok is not None else None)

    def status(self) -> Dict[str, Any]:
        """Resolved state (and metrics after a run), JSON-friendly."""
        resolved = self._resolved
        out: Dict[str, Any] = {
            "name": self.spec.name,
            "model": self.spec.model,
            "trace": self.spec.trace,
            "policy": self.spec.replica_policy.name,
            "instance_type": self.spec.resources.instance_type,
            "state": "declared",
        }
        if resolved is not None:
            cluster = resolved.simulator.cluster
            out.update(
                state="resolved",
                zones=list(resolved.zones),
                n_requests=len(resolved.requests),
                duration_hours=self.spec.sim.duration_hours,
                n_events=len(cluster.events),
                n_preemptions=cluster.n_preemptions,
                n_launch_failures=cluster.n_launch_failures,
            )
        if self.result is not None:
            r = self.result
            out.update(
                state="finished",
                availability=r.availability,
                cost_vs_ondemand=r.cost_vs_ondemand,
                total_cost=r.total_cost,
                failure_rate=r.failure_rate,
                n_completed=r.n_completed,
                p50_s=r.pct(50),
                p99_s=r.pct(99),
            )
            if r.obs is not None:
                out["obs_event_counts"] = r.obs.event_counts()
            if self.artifacts:
                out["obs_artifacts"] = dict(self.artifacts)
            if isinstance(resolved.simulator, TorchServingEngine):
                # the lane's queue pool overflowed and the oracle reran it
                out["oracle_rerun"] = resolved.simulator.fell_back
                # a token-model cell: no phase B, the host engine ran it
                out["token_on_host"] = resolved.simulator.ran_on_host
        return out
