"""The service spec and its builder, as far as a scenario matrix needs them
(the port's own copy of part of ``repro.service``)."""

from repro_torch.service.builder import build_cell, build_requests, resolve_zones
from repro_torch.service.spec import ServiceSpec, SpecError, spec_from_dict

__all__ = ["ServiceSpec", "SpecError", "build_cell", "build_requests",
           "resolve_zones", "spec_from_dict"]
