"""Lint passes. Importing this package registers every rule.

Each module calls :func:`repro_torch.analysis.core.register_rule` at import
time; the runner only ever consults the registry, so adding a pass is
adding a module here and importing it below.
"""

from repro_torch.analysis.passes import (  # noqa: F401
    determinism,
    engine_parity,
    silent_fallback,
    spec_drift,
    tracing,
)

__all__ = [
    "determinism",
    "engine_parity",
    "silent_fallback",
    "spec_drift",
    "tracing",
]
