"""The drain / migrate / kill decision: the port's own copy of
``repro.migration.planner``.

Pure and deterministic: the dying batch's sequences and the surviving
targets' KV headroom in, one decision a sequence out.  The sequences go in
descending resident-KV order (ties by arrival, then key):

* drain: the remaining work (``(prompt - prefilled) prefill_s + (out -
  decoded) weight_read_s``) fits both ``drain_threshold_s`` and the grace
  window, so the sequence finishes in place;
* migrate: its resident KV reaches ``migrate_threshold_tokens``, a target
  has headroom for its whole ``prompt + out`` reservation, and the
  transfers so far plus this one (they queue on the dying instance's NIC)
  fit the grace window;
* kill: everything else prefills again elsewhere.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.migration.config import MigrationSpec
from repro_torch.migration.cost import kv_transfer_bytes, kv_transfer_s

__all__ = ["SeqDecision", "SeqState", "TargetInfo", "plan_preemption"]


@dataclasses.dataclass(frozen=True)
class SeqState:
    """One in-flight sequence of the dying batch."""

    key: int
    prompt_tokens: int
    output_tokens: int
    prefilled: int                  # prompt tokens prefilled so far
    decoded: int                    # output tokens produced so far
    arrival_s: float
    enqueued_s: float
    first_s: float                  # engine-clock first token (nan: none)

    @property
    def resident_tokens(self) -> int:
        return self.prefilled + self.decoded


@dataclasses.dataclass
class TargetInfo:
    """A surviving replica's room for migrations; the planner decrements
    ``headroom_tokens`` as it assigns sequences."""

    rid: int
    headroom_tokens: int            # kv_budget - committed tokens
    bandwidth_bytes_per_s: float    # the link from the dying instance


@dataclasses.dataclass(frozen=True)
class SeqDecision:
    state: SeqState
    action: str                     # "drain" | "migrate" | "kill"
    target_rid: Optional[int] = None
    transfer_s: float = 0.0         # this sequence's own wire time
    resume_offset_s: float = 0.0    # delay until it resumes, queue included


def plan_preemption(
    states: Sequence[SeqState],
    targets: Sequence[TargetInfo],
    grace_s: float,
    engine_cfg,                     # a TokenEngineConfig
    spec: MigrationSpec,
) -> List[SeqDecision]:
    """Drain, migrate or kill, for every sequence of a dying batch."""
    order = sorted(states,
                   key=lambda s: (-s.resident_tokens, s.arrival_s, s.key))
    drain_cap = min(spec.drain_threshold_s, grace_s)
    pf = engine_cfg.prefill_s_per_token
    w = engine_cfg.weight_read_s
    cum = 0.0                       # transfers queue on the source NIC
    out: List[SeqDecision] = []
    for s in order:
        remaining_s = ((s.prompt_tokens - s.prefilled) * pf
                       + (s.output_tokens - s.decoded) * w)
        if remaining_s <= drain_cap:
            out.append(SeqDecision(s, "drain"))
            continue
        decision: Optional[SeqDecision] = None
        resident = s.resident_tokens
        if resident >= spec.migrate_threshold_tokens:
            nbytes = kv_transfer_bytes(resident, engine_cfg.kv_bytes_per_token,
                                       spec.compression)
            need = s.prompt_tokens + s.output_tokens
            best = None             # (rank, target, transfer_s)
            for t in targets:
                if t.headroom_tokens < need:
                    continue
                tr = kv_transfer_s(nbytes, t.bandwidth_bytes_per_s,
                                   spec.link_latency_s)
                if cum + tr > grace_s:
                    continue
                rank = (-t.bandwidth_bytes_per_s, -t.headroom_tokens, t.rid)
                if best is None or rank < best[0]:
                    best = (rank, t, tr)
            if best is not None:
                _, tgt, tr = best
                cum += tr
                tgt.headroom_tokens -= need
                decision = SeqDecision(s, "migrate", target_rid=tgt.rid,
                                       transfer_s=tr, resume_offset_s=cum)
        out.append(decision or SeqDecision(s, "kill"))
    return out
