"""``MigrationRuntime``, what a serving engine calls on a warned
preemption: the port's own copy of ``repro.migration.runtime``, with the
reference's event taps (the plan, the draining / migrating lifecycle and
the migrated requests' span hops; no result depends on them).

It takes the dying replica's ``ContinuousBatch``, its ``Instance`` and the
surviving candidates, snapshots the batch, runs the planner, queues each
migrated sequence on its target (it joins after the transfer, its KV
intact, counted against the target's budget) and kills the rest.  Both
serving engines call this one code path with the same inputs, so they
make the same decisions.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.cluster.catalog import link_bandwidth_gbps
from repro_torch.migration.config import MigrationSpec
from repro_torch.migration.planner import SeqState, TargetInfo, plan_preemption
from repro_torch.obs.events import MigrationPlanEvent, ReplicaLifecycleEvent
from repro_torch.obs.recorder import ObsRecorder

__all__ = ["MigratedSeq", "MigrationRuntime", "PreemptionOutcome"]


@dataclasses.dataclass(frozen=True)
class MigratedSeq:
    """One sequence shipped to a surviving replica."""

    state: SeqState
    target_rid: int                 # instance id of the receiving replica
    transfer_s: float               # its own wire time
    resume_s: float                 # when it joins the target


@dataclasses.dataclass(frozen=True)
class PreemptionOutcome:
    """What an engine accounts for one preemption."""

    drained: Tuple[SeqState, ...]   # finish in place at the kill instant
    migrated: Tuple[MigratedSeq, ...]
    kill_report: Any                # the KillReport of the rest
    migrated_kv_tokens: int
    saved_prefill_tokens: int       # prefill work not done again
    saved_decode_tokens: int
    transfer_s_total: float
    recompute_saved_s: float        # engine seconds of recompute avoided

    @property
    def n_drained(self) -> int:
        return len(self.drained)

    @property
    def n_migrated(self) -> int:
        return len(self.migrated)


class MigrationRuntime:
    """Plans and carries out grace-period KV migration for one run."""

    def __init__(self, spec: MigrationSpec, engine_cfg,
                 obs: Optional[ObsRecorder] = None) -> None:
        if not spec.enabled:
            raise ValueError(
                "MigrationRuntime requires migration.enabled: true")
        self.spec = spec
        self.engine_cfg = engine_cfg    # a TokenEngineConfig
        # the events follow from the inputs and the planner's outcome only,
        # so both engines record the same stream here
        self.obs = obs if obs is not None else ObsRecorder(detail="off")

    def bandwidth_bytes_per_s(self, src_inst, dst_inst) -> float:
        """The link rate from the dying to a surviving instance: the spec's
        flat rate when set, else the catalog's locality tiers."""
        if self.spec.bandwidth_gbps is not None:
            gbps = self.spec.bandwidth_gbps
        else:
            gbps = link_bandwidth_gbps(src_inst.cloud, src_inst.region,
                                       src_inst.zone, dst_inst.cloud,
                                       dst_inst.region, dst_inst.zone)
        return gbps * 1e9 / 8.0

    def execute_preemption(
        self,
        src_batch,                  # the dying replica's ContinuousBatch
        src_inst,                   # its Instance
        candidates: Sequence[Tuple[int, Any, Any]],  # (rid, batch, inst)
        now: float,
        grace_s: float,
    ) -> PreemptionOutcome:
        states = [SeqState(*row) for row in src_batch.iter_states()]
        targets: List[TargetInfo] = []
        bmap: Dict[int, Any] = {}
        for rid, tb, inst in candidates:
            bmap[rid] = tb
            targets.append(TargetInfo(
                rid=rid,
                headroom_tokens=tb.cfg.kv_budget_tokens - tb.committed_tokens,
                bandwidth_bytes_per_s=self.bandwidth_bytes_per_s(src_inst,
                                                                 inst),
            ))
        decisions = plan_preemption(states, targets, grace_s, self.engine_cfg,
                                    self.spec)
        drained: List[SeqState] = []
        migrated: List[MigratedSeq] = []
        removed: List[int] = []
        # the span taps ride the source batch's sampled-key map: read it
        # before remove() and kill() evict its entries
        tord = getattr(src_batch, "_tord", None)
        for d in decisions:
            s = d.state
            if d.action == "drain":
                drained.append(s)
                removed.append(s.key)
            elif d.action == "migrate":
                resume = now + d.resume_offset_s
                if bmap[d.target_rid].enqueue_migrated(
                        s.key, s.prompt_tokens, s.output_tokens, s.arrival_s,
                        resume, s.prefilled, s.decoded, s.first_s):
                    migrated.append(MigratedSeq(
                        state=s, target_rid=d.target_rid,
                        transfer_s=d.transfer_s, resume_s=resume))
                    removed.append(s.key)
                    o = tord.get(s.key) if tord else None
                    if o is not None:
                        to_ord = self.obs.replica_ordinal(d.target_rid)
                        src_batch.tap.migrate(
                            o, now, to_replica=to_ord,
                            transfer_s=d.transfer_s, plan_t=now)
                        src_batch.tap.migrate_arrive(o, resume,
                                                     replica=to_ord)
                        bmap[d.target_rid].track(s.key, o)
                # else the target refused it (too large): it is killed
        if removed:
            src_batch.remove(removed)
        kr = src_batch.kill()
        saved_p = sum(s.prefilled for s in drained) + sum(
            m.state.prefilled for m in migrated)
        saved_d = sum(s.decoded for s in drained) + sum(
            m.state.decoded for m in migrated)
        if self.obs.enabled:
            # these precede the cluster's "dead" record: the engine runs
            # inside the preempt listener, and the cluster records the
            # death after every listener returns
            src_ord = self.obs.replica_ordinal(src_inst.id)
            if drained:
                self.obs.emit(ReplicaLifecycleEvent(
                    t=now, phase="draining",
                    instance_id=src_ord, zone=src_inst.zone))
            if migrated:
                self.obs.emit(ReplicaLifecycleEvent(
                    t=now, phase="migrating",
                    instance_id=src_ord, zone=src_inst.zone))
            self.obs.emit(MigrationPlanEvent(
                t=now,
                instance_id=src_ord,
                n_drained=len(drained),
                n_migrated=len(migrated),
                n_killed=kr.n_batch + kr.n_queued,
                migrated_kv_tokens=sum(m.state.resident_tokens
                                       for m in migrated),
                transfer_s=sum(m.transfer_s for m in migrated),
                grace_s=grace_s,
            ))
        cfg = self.engine_cfg
        return PreemptionOutcome(
            drained=tuple(drained),
            migrated=tuple(migrated),
            kill_report=kr,
            migrated_kv_tokens=sum(m.state.resident_tokens for m in migrated),
            saved_prefill_tokens=saved_p,
            saved_decode_tokens=saved_d,
            transfer_s_total=sum(m.transfer_s for m in migrated),
            recompute_saved_s=(saved_p * cfg.prefill_s_per_token
                               + saved_d * cfg.weight_read_s),
        )
