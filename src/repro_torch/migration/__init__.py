"""Grace-period KV migration on a warned preemption (the port's own copy of
``repro.migration``).

A cloud warns 30-120 s before it takes a spot instance
(``CloudSpec.preemption_warning_s``).  In that window a replica can drain
sequences near their end, ship the resident KV of others to a surviving
replica, and kill only the rest:

* ``config``: ``MigrationSpec``, the spec's knobs;
* ``cost``: KV transfer bytes and seconds (int8 halves the bytes) and
  elastic re-shard pricing;
* ``planner``: the pure drain / migrate / kill decision;
* ``runtime``: ``MigrationRuntime``, which carries a plan out on the
  engines' ``ContinuousBatch``es.
"""

from repro_torch.migration.config import MigrationSpec
from repro_torch.migration.cost import (
    INT8_KV_FACTOR,
    RemeshPlan,
    ReshardCost,
    compression_factor,
    kv_transfer_bytes,
    kv_transfer_s,
    plan_reshard,
)
from repro_torch.migration.planner import (
    SeqDecision,
    SeqState,
    TargetInfo,
    plan_preemption,
)
from repro_torch.migration.runtime import (
    MigratedSeq,
    MigrationRuntime,
    PreemptionOutcome,
)

__all__ = [
    "INT8_KV_FACTOR", "MigratedSeq", "MigrationRuntime", "MigrationSpec",
    "PreemptionOutcome", "RemeshPlan", "ReshardCost", "SeqDecision",
    "SeqState", "TargetInfo", "compression_factor", "kv_transfer_bytes",
    "kv_transfer_s", "plan_preemption", "plan_reshard",
]
