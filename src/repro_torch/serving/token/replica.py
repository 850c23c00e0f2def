"""``TokenReplica``, the continuous-batching engine behind the ``Replica``
interface: the port's own copy of ``repro.serving.token.replica``.

The legacy ``ServingSimulator`` drives it as it drives a ``Replica`` (the
readiness probe, ``submit`` / ``step``, the kill on a preemption), but its
requests run through a ``ContinuousBatch``: they join and leave at
iteration boundaries, queue while the KV cache is full and lose their KV
on a preemption.  ``step`` returns ``(completions, expired)`` as a
``Replica``'s does; the completions' token timelines come from
``take_completions()`` in the same order.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.cluster.catalog import region_rtt_ms
from repro_torch.cluster.instance import Instance
from repro_torch.serving.latency import LatencyModel
from repro_torch.serving.replica import Replica, ReplicaState
from repro_torch.serving.token.batch import (
    ContinuousBatch,
    KillReport,
    TokenCompletion,
)
from repro_torch.serving.token.config import TokenEngineConfig
from repro_torch.workloads.arrivals import Request

__all__ = ["TokenReplica"]


class TokenReplica(Replica):
    """One continuous-batching model replica on one instance."""

    def __init__(self, instance: Instance, latency: LatencyModel,
                 engine_cfg: TokenEngineConfig, *,
                 timeout_s: float = 0.0, span_tap=None,
                 span_ord: int = -1) -> None:
        # the batch admits by KV budget and max_batch: no M/G/c slots
        super().__init__(instance, latency, concurrency=1,
                         timeout_s=timeout_s, span_tap=span_tap,
                         span_ord=span_ord)
        self.batch = ContinuousBatch(engine_cfg, tap=span_tap)
        self.kill_report: Optional[KillReport] = None
        self._by_key: Dict[int, Request] = {}
        self._rejected: List[Request] = []
        self._completions: List[TokenCompletion] = []

    # -- request path ---------------------------------------------------
    @property
    def load(self) -> int:
        return self.batch.load

    def submit(self, req: Request, now: float) -> None:
        rtt = region_rtt_ms(req.client_region, self.region) / 1e3
        ok = self.batch.enqueue(req.id, req.prompt_tokens, req.output_tokens,
                                req.arrival_s, now, rtt_s=rtt)
        if ok:
            self._by_key[req.id] = req
        else:
            # prompt + output exceed the whole KV budget: unservable here
            self._rejected.append(req)
        tap = self.span_tap
        if tap is not None:
            o = tap.want_ids.get(req.id)
            if o is not None:
                tap.dispatch(o, now, self.span_ord, rtt, req.arrival_s,
                             token=True)
                if ok:
                    self.batch.track(req.id, o)
                else:
                    tap.reject(o, now)

    def step(self, now: float) -> Tuple[List[Tuple[Request, float]],
                                        List[Request]]:
        done: List[Tuple[Request, float]] = []
        for c in self.batch.advance(now):
            done.append((self._by_key.pop(c.key), c.finish_s))
            self._completions.append(c)
            self.completed += 1
        expired: List[Request] = []
        if self.timeout_s > 0:
            for key in self.batch.expire_queue(now, self.timeout_s):
                expired.append(self._by_key.pop(key))
        if self._rejected:
            expired.extend(self._rejected)
            self._rejected = []
        return done, expired

    def take_completions(self) -> List[TokenCompletion]:
        """The token timelines of the last ``step``'s completions."""
        out = self._completions
        self._completions = []
        return out

    def kill(self) -> List[Request]:
        self.state = ReplicaState.DEAD
        report = self.batch.kill()
        self.kill_report = report
        failed = [self._by_key.pop(k) for k in report.keys]
        failed.extend(self._rejected)
        self._rejected = []
        return failed

    def kill_migrating(self, runtime, targets: List["TokenReplica"],
                       now: float, grace_s: float):
        """A warned preemption: drain, migrate or kill each sequence through
        the ``MigrationRuntime`` instead of dropping them all.  Returns
        ``(outcome, drained, failed)``: the ``PreemptionOutcome``, the
        drained ``(request, SeqState)`` pairs (they complete at the kill
        instant) and the requests the client retries.  A migrated request
        moves to its target's key map and completes there."""
        self.state = ReplicaState.DEAD
        by_rid = {tr.instance.id: tr for tr in targets}
        outcome = runtime.execute_preemption(
            self.batch, self.instance,
            [(tr.instance.id, tr.batch, tr.instance) for tr in targets],
            now, grace_s)
        drained = [(self._by_key.pop(s.key), s) for s in outcome.drained]
        for m in outcome.migrated:
            by_rid[m.target_rid]._by_key[m.state.key] = self._by_key.pop(
                m.state.key)
        self.kill_report = outcome.kill_report
        failed = [self._by_key.pop(k) for k in outcome.kill_report.keys]
        failed.extend(self._rejected)
        self._rejected = []
        return outcome, drained, failed

    def eta_if_submitted(self, req: Request, now: float) -> float:
        cfg = self.batch.cfg
        svc = (cfg.overhead_s + req.prompt_tokens * cfg.prefill_s_per_token
               + req.output_tokens * cfg.weight_read_s)
        return now + self.batch.backlog_hint_s() + svc
