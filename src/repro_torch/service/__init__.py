"""The declarative service API, the port's front door (its own copy of
``repro.service``): ``spec`` (the typed schema) -> ``loader`` (dict / JSON /
YAML and validation) -> ``builder`` (spec -> trace, policy, autoscaler,
tape, latency model, engine) -> ``service`` (the run / status facade)."""

from repro_torch.service.builder import (
    ResolvedService,
    build_requests,
    build_service,
    resolve_zones,
)
from repro_torch.service.loader import (
    load_spec,
    spec_from_dict,
    spec_from_json,
    spec_from_yaml,
)
from repro_torch.service.service import Service
from repro_torch.service.spec import (
    AutoscalerSpec,
    ForecastSpec,
    LatencySpec,
    ObservabilitySpec,
    PlacementFilter,
    ReplicaPolicySpec,
    ResourceSpec,
    ServiceSpec,
    ServingSpec,
    SimSpec,
    SpecError,
    SweepSpec,
    WorkloadSpec,
)

__all__ = [
    "AutoscalerSpec", "ForecastSpec", "LatencySpec", "ObservabilitySpec",
    "PlacementFilter",
    "ReplicaPolicySpec", "ResolvedService", "ResourceSpec", "Service",
    "ServiceSpec", "ServingSpec", "SimSpec", "SpecError", "SweepSpec",
    "WorkloadSpec", "build_requests", "build_service",
    "load_spec", "resolve_zones", "spec_from_dict", "spec_from_json",
    "spec_from_yaml",
]
