"""The legacy serving simulator, one object per replica and request: the
port's own copy of ``ServingSimulator`` (``repro.serving.sim``), the second
engine the reference holds ``VectorizedServingEngine`` against
(``sim.engine: legacy``).

It runs the cluster simulator (policy x spot trace x instances) and the
request path (workload -> balancer -> replica queues -> latency model):
requests arrive continuously, the balancer routes to ready replicas only, a
preemption kills a replica and its requests retry client-side (the time
lost counts into their end-to-end latency), and a request not done within
``timeout_s`` of its arrival fails.  ``replica_model="token"`` swaps the
M/G/c replicas for ``TokenReplica``s (KV-budget admission, chunked
prefill, batch-dependent decode) and attaches ``TokenStats``; with a
``MigrationSpec`` enabled, a warned preemption drains, migrates or kills
each sequence through the ``MigrationRuntime``.  Any balancer works here,
a ``LoadBalancer`` subclass included.

Every replica is probed and stepped every sub-step, which costs time
linear in the replicas ever created; the result is the vectorized
engine's, and so is the event log it records into its ``ObsRecorder``
(control plane, migration, window samples and burn rates at detail
``full``, sampled request spans), byte for byte.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.cluster.catalog import Catalog, default_catalog
from repro_torch.cluster.instance import Instance, InstanceState
from repro_torch.cluster.simulator import ClusterSimulator, SimConfig
from repro_torch.cluster.traces import SpotTrace
from repro_torch.core.autoscaler import Autoscaler, ConstantTarget
from repro_torch.core.policy import Policy
from repro_torch.migration.config import MigrationSpec
from repro_torch.migration.runtime import MigrationRuntime
from repro_torch.models.config import ModelConfig
from repro_torch.obs.recorder import ObsRecorder
from repro_torch.obs.registry import use_registry
from repro_torch.serving.engine import REPLICA_MODELS
from repro_torch.serving.latency import LatencyModel
from repro_torch.serving.load_balancer import LeastLoadedBalancer, LoadBalancer
from repro_torch.serving.replica import Replica, ReplicaState
from repro_torch.serving.result import ServingResult
from repro_torch.serving.token.config import (
    TokenEngineConfig,
    TokenSchedulerConfig,
)
from repro_torch.serving.token.metrics import TokenRecord, TokenStats
from repro_torch.serving.token.replica import TokenReplica
from repro_torch.serving.window import WindowSampler
from repro_torch.workloads.arrivals import Request

__all__ = ["REPLICA_MODELS", "ServingSimulator"]


class ServingSimulator:
    """One cell's serving run, replica by replica."""

    def __init__(
        self,
        trace: SpotTrace,
        policy: Policy,
        requests: Sequence[Request],
        cfg: ModelConfig,
        *,
        itype: str = "p3.2xlarge",
        catalog: Optional[Catalog] = None,
        autoscaler: Optional[Autoscaler] = None,
        lb: Optional[LoadBalancer] = None,
        sim_config: Optional[SimConfig] = None,
        timeout_s: float = 100.0,
        sub_step_s: float = 1.0,
        workload_name: str = "workload",
        concurrency: Optional[int] = None,
        concurrency_cap: int = 16,
        latency_model: Optional[LatencyModel] = None,
        replica_model: str = "request",
        token_scheduler: Optional[TokenSchedulerConfig] = None,
        migration: Optional[MigrationSpec] = None,
        obs: Optional[ObsRecorder] = None,
    ) -> None:
        self.catalog = catalog or default_catalog()
        self.obs = obs if obs is not None else ObsRecorder()
        self.cfg = cfg
        self.itype = self.catalog.instance_type(itype)
        self.latency_model = (
            latency_model
            if latency_model is not None
            else LatencyModel.for_model(cfg, self.itype)
        )
        self.lb = lb or LeastLoadedBalancer()
        self.timeout_s = timeout_s
        self.sub_step_s = sub_step_s
        self.workload_name = workload_name
        self.concurrency = concurrency
        self.concurrency_cap = concurrency_cap
        if replica_model not in REPLICA_MODELS:
            raise ValueError(f"replica_model must be one of "
                             f"{list(REPLICA_MODELS)}, got {replica_model!r}")
        self.replica_model = replica_model
        self._token_knobs = token_scheduler or TokenSchedulerConfig()
        self._token_cfg: Optional[TokenEngineConfig] = (
            TokenEngineConfig.from_latency(self.latency_model,
                                           self._token_knobs)
            if replica_model == "token" else None)
        # the burn monitor needs the token SLO targets
        token = self._token_cfg is not None
        self._win = WindowSampler(
            self.obs,
            slo_ttft_s=self._token_knobs.slo_ttft_s if token else None,
            slo_tpot_s=self._token_knobs.slo_tpot_s if token else None)
        self._token_records: List[TokenRecord] = []
        self._n_kv_preempted = 0
        self._n_killed_queued = 0
        self._lost_prefill_tokens = 0
        self._lost_decode_tokens = 0
        self._n_retried = 0
        if (migration is not None and migration.enabled
                and self._token_cfg is None):
            raise ValueError("migration.enabled requires replica_model='token'")
        self._mig_rt: Optional[MigrationRuntime] = (
            MigrationRuntime(migration, self._token_cfg, obs=self.obs)
            if migration is not None and migration.enabled else None)
        self._n_drained = 0
        self._n_migrated = 0
        self._migrated_kv_tokens = 0
        self._saved_prefill_tokens = 0
        self._saved_decode_tokens = 0
        self._migration_transfer_s = 0.0
        self._recompute_saved_s = 0.0

        self.requests = sorted(requests, key=lambda r: r.arrival_s)
        # the span collector (None when off): the taps fire for sampled
        # requests only, found through want_ids[req.id]
        self._spans = self.obs.span_collector(self.requests)
        self._next_arrival = 0
        self.pending: List[Request] = []       # waiting for a replica
        self._arrival: Dict[int, float] = {}
        self.latencies: List[float] = []
        self.failed = 0
        self.completed = 0
        self.replicas: Dict[int, Replica] = {}

        if sim_config is None:
            cfg_sim = SimConfig(itype=itype, control_interval_s=15.0)
        else:
            # never mutate the caller's (possibly shared) SimConfig
            cfg_sim = dataclasses.replace(sim_config, itype=itype)
        self.cluster = ClusterSimulator(
            trace,
            policy,
            catalog=self.catalog,
            autoscaler=autoscaler or ConstantTarget(4),
            config=cfg_sim,
            tick_hook=self._tick,
            obs=self.obs,
        )
        self.cluster.add_preempt_listener(self._on_dead)
        # a scale-down retires the instance from the cluster's scan list, so
        # the replica layer hears of it here
        self.cluster.add_terminate_listener(self._on_dead)

    # ------------------------------------------------------------------
    def _new_replica(self, inst: Instance) -> Replica:
        tap = self._spans
        ord_ = self.obs.replica_ordinal(inst.id) if tap is not None else -1
        if self._token_cfg is not None:
            return TokenReplica(inst, self.latency_model, self._token_cfg,
                                timeout_s=self.timeout_s, span_tap=tap,
                                span_ord=ord_)
        return Replica(inst, self.latency_model, concurrency=self.concurrency,
                       concurrency_cap=self.concurrency_cap,
                       timeout_s=self.timeout_s, span_tap=tap, span_ord=ord_)

    def _sync_replicas(self, now: float) -> None:
        for inst in self.cluster.instances:
            if inst.id not in self.replicas and inst.is_active():
                self.replicas[inst.id] = self._new_replica(inst)
            elif inst.id in self.replicas and not inst.is_active():
                self._kill_replica(inst.id, now)
        for r in self.replicas.values():
            r.readiness_probe(now)

    def _kill_replica(self, rid: int, now: float) -> None:
        rep = self.replicas.get(rid)
        if rep is None or rep.state is ReplicaState.DEAD:
            return
        if (self._mig_rt is not None and isinstance(rep, TokenReplica)
                and rep.instance.state is InstanceState.PREEMPTED
                and rep.instance.warned_at is not None):
            self._kill_with_migration(rep, now)
            return
        killed = rep.kill()
        self._n_retried += len(killed)
        # the client retries: back into the pending pool
        self.pending.extend(killed)
        self._tap_preempt(killed, now)
        if isinstance(rep, TokenReplica) and rep.kill_report is not None:
            self._count_kill(rep.kill_report)

    def _tap_preempt(self, reqs: Sequence[Request], now: float) -> None:
        tap = self._spans
        if tap is not None:
            for req in reqs:
                o = tap.want_ids.get(req.id)
                if o is not None:
                    tap.preempt(o, now)

    def _count_kill(self, kr) -> None:
        self._n_kv_preempted += kr.n_batch
        self._n_killed_queued += kr.n_queued
        self._lost_prefill_tokens += kr.lost_prefill_tokens
        self._lost_decode_tokens += kr.lost_decode_tokens

    def _kill_with_migration(self, rep: TokenReplica, now: float) -> None:
        """A warned preemption with migration on: drain, migrate or kill
        the dying batch's sequences instead of prefilling them all again
        elsewhere."""
        inst = rep.instance
        grace = now - inst.warned_at
        targets = sorted(
            (rp for rp in self.replicas.values()
             if rp is not rep and isinstance(rp, TokenReplica)
             and rp.state is not ReplicaState.DEAD and rp.instance.is_ready()),
            key=lambda rp: rp.instance.id)
        outcome, drained, failed = rep.kill_migrating(self._mig_rt, targets,
                                                      now, grace)
        cfg = self._token_cfg
        finish = now + cfg.overhead_s
        tap = self._spans
        for req, s in drained:
            # finished decoding inside the grace window: completes at the
            # kill instant, its first token (if any) already emitted
            rtt = LoadBalancer.rtt_s(req, rep)
            e2e = finish - self._arrival[req.id] + rtt
            ok = e2e <= self.timeout_s
            first = (s.first_s + cfg.overhead_s
                     if math.isfinite(s.first_s) else finish)
            if ok:
                self.latencies.append(e2e)
                self.completed += 1
                self._token_records.append(TokenRecord(
                    req_id=req.id, arrival_s=self._arrival[req.id],
                    first_token_s=first, finish_s=finish,
                    output_tokens=s.output_tokens, rtt_s=rtt))
            else:
                self.failed += 1
            o = tap.want_ids.get(req.id) if tap is not None else None
            if o is not None:
                tap.finish_token(o, first, finish, cfg.overhead_s,
                                 "ok" if ok else "timeout", e2e)
        self._n_retried += len(failed)
        self.pending.extend(failed)
        self._tap_preempt(failed, now)
        self._count_kill(outcome.kill_report)
        self._n_drained += outcome.n_drained
        self._n_migrated += outcome.n_migrated
        self._migrated_kv_tokens += outcome.migrated_kv_tokens
        self._saved_prefill_tokens += outcome.saved_prefill_tokens
        self._saved_decode_tokens += outcome.saved_decode_tokens
        self._migration_transfer_s += outcome.transfer_s_total
        self._recompute_saved_s += outcome.recompute_saved_s

    def _on_dead(self, inst: Instance, now: float) -> None:
        self._kill_replica(inst.id, now)

    # ------------------------------------------------------------------
    def _dispatch(self, now: float) -> None:
        ready = [r for r in self.replicas.values()
                 if r.state is ReplicaState.READY]
        self.lb.update_ready(ready)
        tap = self._spans
        token = self._token_cfg is not None
        still: List[Request] = []
        for req in self.pending:
            o = tap.want_ids.get(req.id) if tap is not None else None
            if now - self._arrival[req.id] > self.timeout_s:
                self.failed += 1
                if o is not None:
                    tap.expire(o, now, req.arrival_s)
                continue
            rep = self.lb.route(req, now)
            if rep is None:
                still.append(req)
            elif o is not None and not token:
                # a token replica taps in its submit (it knows whether the
                # batch admitted the request); the request model taps here
                tap.dispatch(o, now, rep.span_ord,
                             LoadBalancer.rtt_s(req, rep), req.arrival_s)
        self.pending = still

    def _step_replicas(self, now: float) -> None:
        token = self._token_cfg is not None
        tap = self._spans
        for rep in self.replicas.values():
            if rep.state is not ReplicaState.READY:
                continue
            done, expired = rep.step(now)
            self.failed += len(expired)
            if tap is not None:
                for req in expired:
                    o = tap.want_ids.get(req.id)
                    if o is not None:
                        # a rejected admission already has its outcome:
                        # expire() leaves it be
                        tap.expire(o, now, req.arrival_s)
            comps = rep.take_completions() if token else None
            for k, (req, finish) in enumerate(done):
                rtt = LoadBalancer.rtt_s(req, rep)
                e2e = finish - self._arrival[req.id] + rtt
                ok = e2e <= self.timeout_s
                if not ok:
                    self.failed += 1
                else:
                    self.latencies.append(e2e)
                    self.completed += 1
                    if comps is not None:
                        c = comps[k]
                        self._token_records.append(TokenRecord(
                            req_id=req.id, arrival_s=self._arrival[req.id],
                            first_token_s=c.first_token_s,
                            finish_s=c.finish_s,
                            output_tokens=c.output_tokens, rtt_s=rtt))
                o = tap.want_ids.get(req.id) if tap is not None else None
                if o is not None:
                    outcome = "ok" if ok else "timeout"
                    if comps is not None:
                        c = comps[k]
                        tap.finish_token(o, c.first_token_s, c.finish_s,
                                         self._token_cfg.overhead_s,
                                         outcome, e2e)
                    else:
                        tap.finish(o, finish, outcome, e2e)

    def _tick(self, now: float, cluster: ClusterSimulator) -> None:
        dt = cluster.config.control_interval_s
        t = now
        end = now + dt
        while t < end:
            self._sync_replicas(t)
            # deliver the arrivals up to t
            n_new = 0
            while (self._next_arrival < len(self.requests)
                   and self.requests[self._next_arrival].arrival_s <= t):
                req = self.requests[self._next_arrival]
                self._arrival[req.id] = req.arrival_s
                self.pending.append(req)
                self._next_arrival += 1
                n_new += 1
            if n_new:
                cluster.autoscaler.observe(t, n_new)
            self._dispatch(t)
            self._step_replicas(t)
            t += self.sub_step_s
        self._win.maybe_emit(
            now,
            delivered=self._next_arrival,
            completed=self.completed,
            failed=self.failed,
            instances=cluster.instances,
            token_records=(self._token_records
                           if self._token_cfg is not None else None),
        )

    # ------------------------------------------------------------------
    def run(self, duration_s: Optional[float] = None) -> ServingResult:
        # the run's registry takes the library's counters (the latency
        # model's fallback) in this scope
        with use_registry(self.obs.registry):
            base = self.cluster.run(duration_s)
        # drain: anything still pending or in flight past the horizon fails
        self.failed += len(self.pending)
        for rep in self.replicas.values():
            self.failed += rep.load
        if self._spans is not None:
            self._spans.finalize(base.duration_s)
        n_total = self._next_arrival
        token_stats = None
        if self._token_cfg is not None:
            knobs = self._token_knobs
            token_stats = TokenStats.from_records(
                self._token_records,
                slo_ttft_s=knobs.slo_ttft_s,
                slo_tpot_s=knobs.slo_tpot_s,
                horizon_s=base.duration_s,
                window_s=knobs.goodput_window_s,
                n_requests=n_total,
                n_kv_preempted_seqs=self._n_kv_preempted,
                n_killed_queued=self._n_killed_queued,
                lost_prefill_tokens=self._lost_prefill_tokens,
                lost_decode_tokens=self._lost_decode_tokens,
                n_drained_seqs=self._n_drained,
                n_migrated_seqs=self._n_migrated,
                migrated_kv_tokens=self._migrated_kv_tokens,
                saved_prefill_tokens=self._saved_prefill_tokens,
                saved_decode_tokens=self._saved_decode_tokens,
                migration_transfer_s=self._migration_transfer_s,
                recompute_saved_s=self._recompute_saved_s,
            )
        return ServingResult(
            policy=self.cluster.policy.name,
            trace=self.cluster.trace.name,
            workload=self.workload_name,
            n_requests=n_total,
            n_completed=self.completed,
            n_failed=self.failed,
            latencies_s=np.asarray(self.latencies),
            total_cost=base.total_cost,
            spot_cost=base.spot_cost,
            od_cost=base.od_cost,
            cost_vs_ondemand=base.cost_vs_ondemand,
            availability=base.availability,
            n_preemptions=base.n_preemptions,
            n_launch_failures=base.n_launch_failures,
            token=token_stats,
            n_retried_requests=self._n_retried,
            lost_kv_tokens=self._lost_prefill_tokens + self._lost_decode_tokens,
            metrics=self.obs.registry.snapshot() or None,
            obs=self.obs if self.obs.enabled else None,
        )
