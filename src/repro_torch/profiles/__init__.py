"""Kernel step-time profiles of the port: measured grounding for serving
latencies on an H100 (counterpart of ``repro.profiles``).

The serving layer's roofline latency model prices every request from two
efficiency fractions (prefill MFU, decode MBU).  This package measures
them on the port's own CUDA kernels — per model config, for the H100
instance — and persists versioned JSON step-time tables under
``artifacts/profiles/`` in the reference's schema, so the reference's
``ProfiledLatencyModel`` loads them.

* ``schema``   — the versioned artifact contract (``ProfileEntry`` /
  ``ProfileTable`` / ``load_profiles``),
* ``profiler`` — kernel micro-benchmarks (the CUDA kernels on the card,
  their plain versions on the CPU),
* ``run``      — the ``python -m repro_torch.profiles.run`` CLI.
"""

from repro_torch.profiles.profiler import profile_model, profile_models
from repro_torch.profiles.schema import (
    DEFAULT_PROFILE_DIR,
    SCHEMA_VERSION,
    ProfileEntry,
    ProfileSchemaError,
    ProfileTable,
    load_profiles,
)

__all__ = [
    "DEFAULT_PROFILE_DIR",
    "SCHEMA_VERSION",
    "ProfileEntry",
    "ProfileSchemaError",
    "ProfileTable",
    "load_profiles",
    "profile_model",
    "profile_models",
]
