"""``MigrationSpec``, the knobs of grace-period KV migration: the port's own
copy of ``repro.migration.config``.  Standard library only, so the serving
engines and the service spec share it."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

__all__ = ["COMPRESSION_MODES", "MigrationSpec"]

COMPRESSION_MODES = ("none", "int8")


@dataclasses.dataclass(frozen=True)
class MigrationSpec:
    """Knobs of the drain / migrate / kill planner.  ``enabled: False``
    (the default) kills the whole batch on a preemption; the other knobs
    act only when it is enabled."""

    enabled: bool = False
    # a flat link rate (Gbit/s) over the catalog's locality tiers
    bandwidth_gbps: Optional[float] = None
    compression: str = "none"          # "none" | "int8" (halves KV bytes)
    # a sequence whose remaining work fits this (and the grace window)
    # finishes in place
    drain_threshold_s: float = 30.0
    # a sequence with fewer resident KV tokens prefills again elsewhere
    migrate_threshold_tokens: int = 1
    # a transfer's connection set-up
    link_latency_s: float = 0.05

    def __post_init__(self) -> None:
        if self.compression not in COMPRESSION_MODES:
            raise ValueError(
                f"migration.compression must be one of {COMPRESSION_MODES},"
                f" got {self.compression!r}")
        if self.bandwidth_gbps is not None and self.bandwidth_gbps <= 0:
            raise ValueError(f"migration.bandwidth_gbps must be positive, "
                             f"got {self.bandwidth_gbps}")
        if self.drain_threshold_s < 0:
            raise ValueError(f"migration.drain_threshold_s must be >= 0, "
                             f"got {self.drain_threshold_s}")
        if self.migrate_threshold_tokens < 0:
            raise ValueError(f"migration.migrate_threshold_tokens must be "
                             f">= 0, got {self.migrate_threshold_tokens}")
        if self.link_latency_s < 0:
            raise ValueError(f"migration.link_latency_s must be >= 0, "
                             f"got {self.link_latency_s}")

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"enabled": self.enabled}
        if self.bandwidth_gbps is not None:
            out["bandwidth_gbps"] = self.bandwidth_gbps
        out["compression"] = self.compression
        out["drain_threshold_s"] = self.drain_threshold_s
        out["migrate_threshold_tokens"] = self.migrate_threshold_tokens
        out["link_latency_s"] = self.link_latency_s
        return out
