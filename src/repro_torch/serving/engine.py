"""The vectorized serving engine's request model: the port's own copy of
``VectorizedServingEngine`` (``repro.serving.engine``), the NumPy oracle the
scenario engine's data plane is held against and falls back to.

It runs the §5.1 serving methodology over a cluster simulator: the control
plane (``ClusterSimulator``: trace, policy, autoscaler) calls ``_tick`` once
a control window, and the window walks its sub-step grid, where requests
arrive, are routed to ready replicas by the least-loaded ``(load, rtt, id)``
rule or round-robin, queue, start (a start is priced at its service time
times ``1 + 0.15 x`` the requests already running), finish or time out, and
go back to pending when their replica dies.  State is arrays and plain
lists:

* the request tape is compiled once into float64 arrays (arrivals, roofline
  service times, client-region codes);
* arrivals come in batches by ``searchsorted`` over the arrival array;
* timeout expiry over a deep pending backlog is a vectorised mask;
* each replica keeps its RTT per client-region code from its creation;
* completions sit in one min-heap of finish times, so a sub-step visits
  only the replicas with a finish due or new work, and sub-steps where
  nothing can happen are skipped.

Every decision is the reference's: the same grid points (the same float
accumulation), the same arrival batches to the autoscaler, the same picks,
the same failures at the same instants.

``replica_model="token"`` swaps the request path for the continuous-batching
model (``repro_torch.serving.token``): each replica slot carries a
``ContinuousBatch``, dispatch enqueues tape indices into the batches, and a
sub-step advances every busy batch (pure decode in closed form).  With a
``MigrationSpec`` enabled, a warned preemption drains, migrates or kills
each sequence of the dying batch through the ``MigrationRuntime``.  Token
mode is decision for decision the legacy ``ServingSimulator``'s
``TokenReplica`` path, and the reference's.

The balancer is a ``LeastLoadedBalancer`` or a ``RoundRobinBalancer``
(exactly those types; a subclass runs on the legacy simulator only), or
its name, ``"ll"`` or ``"rr"``.  The run records into its ``ObsRecorder``
(shared with the cluster and the migration runtime): the control plane,
window samples and burn rates at detail ``full``, and the sampled requests'
spans, whose ordinal is the tape index; the event log is the legacy
simulator's byte for byte.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np

from repro_torch.cluster.catalog import Catalog, default_catalog, region_rtt_ms
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
from repro_torch.serving.latency import LatencyModel
from repro_torch.serving.load_balancer import (
    LeastLoadedBalancer,
    LoadBalancer,
    RoundRobinBalancer,
)
from repro_torch.serving.result import ServingResult
from repro_torch.serving.token.batch import ContinuousBatch
from repro_torch.serving.token.config import (
    TokenEngineConfig,
    TokenSchedulerConfig,
)
from repro_torch.serving.token.metrics import TokenRecord, TokenStats
from repro_torch.serving.torchengine.schedule import tape_arrays
from repro_torch.serving.window import WindowSampler
from repro_torch.workloads.arrivals import Request

__all__ = ["LB_KINDS", "REPLICA_MODELS", "VectorizedServingEngine",
           "lb_kind"]

_INF = float("inf")
# below this size a plain Python scan beats numpy call overhead
_VEC_MIN = 24

#: the balancers the engine simulates: least-loaded and round-robin
LB_KINDS = ("ll", "rr")
#: how a replica prices work: frozen service times, or continuous batching
REPLICA_MODELS = ("request", "token")


def lb_kind(lb: Union[LoadBalancer, str, None]) -> str:
    """The balancer the engine simulates: ``"ll"`` for a
    ``LeastLoadedBalancer`` (the default), ``"rr"`` for a
    ``RoundRobinBalancer``, or either name.  Exactly those two types: a
    subclass may override ``pick()``, and simulating it as the plain
    balancer would be wrong."""
    if lb is None:
        return "ll"
    if isinstance(lb, str):
        if lb not in LB_KINDS:
            raise ValueError(f"lb must be one of {list(LB_KINDS)} "
                             f"(least-loaded, round-robin), got {lb!r}")
        return lb
    if type(lb) is RoundRobinBalancer:
        return "rr"
    if type(lb) is LeastLoadedBalancer:
        return "ll"
    raise TypeError(
        f"VectorizedServingEngine supports LeastLoadedBalancer and "
        f"RoundRobinBalancer, got {type(lb).__name__}; use the legacy "
        "ServingSimulator (sim.engine: legacy) for custom balancers")


class _Rep:
    """A replica slot: plain fields, no FSM object, no probes."""

    __slots__ = ("inst", "slot", "rid", "dead", "rtt",
                 "running", "queue", "qage", "qmin", "batch", "ord")

    def __init__(self, inst: Instance, slot: int,
                 rtt: List[float]) -> None:
        self.inst = inst
        self.slot = slot
        self.rid = inst.id
        self.ord = -1                        # dense run ordinal (spans)
        self.dead = False
        self.rtt = rtt                       # client-region code -> seconds
        self.running: List[Tuple[float, int]] = []   # (finish_s, req index)
        self.queue: List[int] = []                   # req indices, FIFO
        # parallel *effective* ages: arrival - client RTT, so the shared
        # `t - age > timeout` expiry predicate is RTT-inclusive, matching
        # the deadline applied to completed responses
        self.qage: List[float] = []
        self.qmin = _INF                     # lower bound on queued eff. ages
        self.batch: Optional[ContinuousBatch] = None   # token mode only

    @property
    def load(self) -> int:
        if self.batch is not None:
            return self.batch.load
        return len(self.running) + len(self.queue)


class VectorizedServingEngine:
    """One cell's serving run: the cluster simulator plus the request or
    the token model, on the host."""

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
        lb: Union[LoadBalancer, str, None] = None,
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
        # the run's recorder: the cluster, the migration runtime and the
        # window sampler record into it too
        self.obs = obs if obs is not None else ObsRecorder()
        self.catalog = catalog or default_catalog()
        self.cfg = cfg
        self.itype = self.catalog.instance_type(itype)
        self.latency_model = (
            latency_model
            if latency_model is not None
            else LatencyModel.for_model(cfg, self.itype)
        )
        self.timeout_s = timeout_s
        self.sub_step_s = sub_step_s
        self.workload_name = workload_name
        self.concurrency = concurrency or min(
            self.latency_model.max_concurrency(), concurrency_cap
        )
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
        self._busy: Set[int] = set()         # slots with live batch work
        self._n_kv_preempted = 0
        self._n_killed_queued = 0
        self._lost_prefill_tokens = 0
        self._lost_decode_tokens = 0
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
        self._lb_kind = lb_kind(lb)
        self._rr_cursor = 0
        self._n_retried = 0

        # ---- compile the request tape into arrays ---------------------
        # (stable-sorted by arrival; service times bit-identical to the
        # per-request computation; client regions as small int codes, each
        # replica precomputing its RTT per code on creation)
        self.requests = sorted(requests, key=lambda r: r.arrival_s)
        # the span collector (None when off): the tape is the stable sort
        # by arrival, so a tape index is its span ordinal and the hot loops
        # test want_l[i] directly
        self._spans = self.obs.span_collector(self.requests)
        self._n = len(self.requests)
        self._arr, self._svc, self._rcode, self._client_regions = tape_arrays(
            self.requests, self.latency_model)
        # Python-list mirrors for scalar access: list indexing and float
        # arithmetic beat numpy scalar indexing in the per-request loops,
        # and .tolist() round-trips exactly
        self._arr_l: List[float] = self._arr.tolist()
        self._svc_l: List[float] = self._svc.tolist()
        self._rcode_l: List[int] = self._rcode.tolist()
        if self._token_cfg is not None:
            # token mode prices work in tokens, not frozen service times
            self._ptok_l = [int(r.prompt_tokens) for r in self.requests]
            self._otok_l = [int(r.output_tokens) for r in self.requests]

        # ---- mutable serving state ------------------------------------
        self._ptr = 0                        # next arrival index
        self._pending: List[int] = []        # request indices, FIFO
        self._pmin = _INF                    # min arrival over pending
        self._qn = 0                         # total queued entries
        self._qmin = _INF                    # min arrival over queued
        self._heap: List[Tuple[float, int]] = []   # (finish_s, slot)
        self._reps: List[_Rep] = []          # insertion order
        self._live: List[_Rep] = []          # non-dead, insertion order
        self._live_dirty = False
        self._by_id: Dict[int, _Rep] = {}
        self._obs: List[Tuple[float, int]] = []   # autoscaler batch
        self._touched: Set[int] = set()      # slots enqueued at this point
        self._due: Set[int] = set()          # slots with finishes due
        # per-control-window LB state (the ready set is constant in a window)
        self._ready_slots: List[int] = []
        self._ready_reps: List[_Rep] = []
        self._pos: Dict[int, int] = {}       # slot -> index in ready lists
        self._loads: List[int] = []
        self._ids: List[int] = []
        self._cols: Dict[int, List[float]] = {}   # rcode -> rtt column

        self.latencies: List[float] = []
        self.failed = 0
        self.completed = 0

        if sim_config is None:
            cfg_sim = SimConfig(itype=itype, control_interval_s=15.0)
        else:
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
        self.cluster.add_terminate_listener(self._on_dead)
        self._observe_batch = self.cluster.autoscaler.observe_batch
        self._searchsorted = self._arr.searchsorted

    # ------------------------------------------------------------------
    # replica lifecycle
    # ------------------------------------------------------------------
    def _new_rep(self, inst: Instance) -> _Rep:
        rtt = [
            region_rtt_ms(creg, inst.region) / 1e3
            for creg in self._client_regions
        ]
        rep = _Rep(inst, len(self._reps), rtt)
        if self._spans is not None:
            rep.ord = self.obs.replica_ordinal(inst.id)
        if self._token_cfg is not None:
            rep.batch = ContinuousBatch(self._token_cfg, tap=self._spans)
        self._reps.append(rep)
        self._live.append(rep)
        self._by_id[inst.id] = rep
        return rep

    def _kill(self, rep: _Rep, now: Optional[float] = None) -> None:
        """Preemption/termination: in-flight then queued back to pending."""
        if rep.dead:
            return
        rep.dead = True
        self._live_dirty = True
        arr = self._arr_l
        pending = self._pending
        pmin = self._pmin
        spans = self._spans
        want = spans.want_l if spans is not None else None
        t_kill = now if now is not None else 0.0
        if rep.batch is not None:
            # token mode: the batch loses its KV and every request retries
            # client-side, unless migration is on and the preemption was
            # warned
            inst = rep.inst
            if (self._mig_rt is not None and now is not None
                    and inst.state is InstanceState.PREEMPTED
                    and inst.warned_at is not None):
                kr = self._kill_with_migration(rep, now)
            else:
                kr = rep.batch.kill()
            for i in kr.keys:
                pending.append(i)
                if arr[i] < pmin:
                    pmin = arr[i]
                if want is not None and want[i]:
                    spans.preempt(i, t_kill)
            self._pmin = pmin
            self._n_retried += len(kr.keys)
            self._busy.discard(rep.slot)
            self._n_kv_preempted += kr.n_batch
            self._n_killed_queued += kr.n_queued
            self._lost_prefill_tokens += kr.lost_prefill_tokens
            self._lost_decode_tokens += kr.lost_decode_tokens
            return
        for i in [i for _, i in rep.running] + rep.queue:
            pending.append(i)
            if arr[i] < pmin:
                pmin = arr[i]
            if want is not None and want[i]:
                spans.preempt(i, t_kill)
        self._pmin = pmin
        self._n_retried += len(rep.running) + len(rep.queue)
        self._qn -= len(rep.queue)
        rep.running = []
        rep.queue = []
        rep.qage = []
        rep.qmin = _INF

    def _kill_with_migration(self, rep: _Rep, now: float):
        """A warned preemption with migration on: drain, migrate or kill
        the dying batch's sequences (the legacy simulator's decisions).
        Returns the KillReport of the rest."""
        inst = rep.inst
        grace = now - inst.warned_at
        cands = sorted(
            (r for r in self._live
             if r is not rep and not r.dead and r.batch is not None
             and r.inst.is_ready()),
            key=lambda r: r.rid)
        outcome = self._mig_rt.execute_preemption(
            rep.batch, inst, [(r.rid, r.batch, r.inst) for r in cands],
            now, grace)
        cfg = self._token_cfg
        finish = now + cfg.overhead_s
        rcode = self._rcode_l
        arr = self._arr_l
        spans = self._spans
        want = spans.want_l if spans is not None else None
        for s in outcome.drained:
            # finished decoding inside the grace window: completes at the
            # kill instant, its first token (if any) already emitted
            i = s.key
            rtt = rep.rtt[rcode[i]]
            e2e = finish - arr[i] + rtt
            first = (s.first_s + cfg.overhead_s
                     if math.isfinite(s.first_s) else finish)
            ok = e2e <= self.timeout_s
            if ok:
                self.latencies.append(e2e)
                self.completed += 1
                self._token_records.append(TokenRecord(
                    req_id=i, arrival_s=arr[i], first_token_s=first,
                    finish_s=finish, output_tokens=s.output_tokens,
                    rtt_s=rtt))
            else:
                self.failed += 1
            if want is not None and want[i]:
                spans.finish_token(i, first, finish, cfg.overhead_s,
                                   "ok" if ok else "timeout", e2e)
        by_rid = {r.rid: r for r in cands}
        for m in outcome.migrated:
            # the target batch has queued work now: it must step
            self._busy.add(by_rid[m.target_rid].slot)
        self._n_drained += outcome.n_drained
        self._n_migrated += outcome.n_migrated
        self._migrated_kv_tokens += outcome.migrated_kv_tokens
        self._saved_prefill_tokens += outcome.saved_prefill_tokens
        self._saved_decode_tokens += outcome.saved_decode_tokens
        self._migration_transfer_s += outcome.transfer_s_total
        self._recompute_saved_s += outcome.recompute_saved_s
        return outcome.kill_report

    def _on_dead(self, inst: Instance, now: float) -> None:
        rep = self._by_id.get(inst.id)
        if rep is not None:
            self._kill(rep, now)

    def _sync(self, now: Optional[float] = None) -> None:
        """Reconcile the replica set with the cluster's active instances.

        Instance state only changes at control ticks, so one reconciliation
        per window is exact.  The window-constant LB state (ready order,
        loads, rtt columns) is rebuilt here.
        """
        for inst in self.cluster.instances:
            rep = self._by_id.get(inst.id)
            if rep is None:
                if inst.is_active():
                    self._new_rep(inst)
            elif not inst.is_active():
                self._kill(rep, now)
        if self._live_dirty:
            self._live = [r for r in self._live if not r.dead]
            self._live_dirty = False
        ready = [r for r in self._live if r.inst.is_ready()]
        self._ready_reps = ready
        self._ready_slots = [r.slot for r in ready]
        self._pos = {r.slot: j for j, r in enumerate(ready)}
        self._loads = [r.load for r in ready]
        self._ids = [r.rid for r in ready]
        self._cols = {}

    # ------------------------------------------------------------------
    # sub-step loop
    # ------------------------------------------------------------------
    def _active(self, t: float) -> bool:
        """Could anything at all happen at grid point ``t``?

        Conservative: a false positive costs one no-op pass, never
        correctness.
        """
        if self._ptr < self._n and self._arr_l[self._ptr] <= t:
            return True
        if self._heap and self._heap[0][0] <= t:
            return True
        if self._pending:
            if self._ready_slots:
                return True
            if t - self._pmin > self.timeout_s:
                return True
        if self._qn and t - self._qmin > self.timeout_s:
            return True
        return False

    def _tick(self, now: float, cluster: ClusterSimulator) -> None:
        self._sync(now)
        dt = cluster.config.control_interval_s
        t = now
        end = now + dt
        token = self._token_cfg is not None
        # the per-window float accumulation of every engine, so grid points,
        # arrival batches and timeout instants match bit for bit
        while t < end:
            if token:
                if self._active_token(t):
                    self._process_token(t)
            elif self._active(t):
                self._process(t)
            t += self.sub_step_s
        # flush arrival observations before the cluster reads target():
        # equal to per-sub-step observe() calls (eviction is idempotent)
        if self._obs:
            self._observe_batch(self._obs)
            self._obs.clear()
        self._win.maybe_emit(
            now,
            delivered=self._ptr,
            completed=self.completed,
            failed=self.failed,
            instances=cluster.instances,
            token_records=self._token_records if token else None,
        )

    def _process(self, t: float) -> None:
        # 1) arrivals
        ptr = self._ptr
        if ptr < self._n and self._arr_l[ptr] <= t:
            new_ptr = int(self._searchsorted(t, side="right"))
            self._pending.extend(range(ptr, new_ptr))
            m = self._arr_l[ptr]
            if m < self._pmin:
                self._pmin = m
            self._ptr = new_ptr
            self._obs.append((t, new_ptr - ptr))
        # 2) slots with completions due, from the finish-time heap.  Found
        #    BEFORE dispatch so the dispatch fast path knows which replicas
        #    may not start work until their completions are processed.
        due = self._due
        due.clear()
        heap = self._heap
        reps = self._reps
        while heap and heap[0][0] <= t:
            _, s = heapq.heappop(heap)
            if not reps[s].dead:
                due.add(s)
        # 3) dispatch (fills self._touched with slots that got new queued
        #    work; a replica with free capacity, an empty queue and no due
        #    completion starts the request at once, which equals
        #    queue-then-start within the same sub-step)
        touched = self._touched
        touched.clear()
        if self._pending:
            self._dispatch(t, due)
        # 4) step the affected replicas.  Untouched slots cannot change,
        #    except by queue expiry, which is wall-clock driven and handled
        #    by the guarded full pass (per-replica qmin bounds skip replicas
        #    that cannot hold an expired entry).
        if self._qn and self.timeout_s > 0 \
                and t - self._qmin > self.timeout_s:
            self._step(t, self._ready_slots, due, expire=True)
            qmin_g = _INF
            for r in self._ready_reps:
                if r.qmin < qmin_g:
                    qmin_g = r.qmin
            self._qmin = qmin_g
        elif due:
            slots = sorted(due | touched) if touched else sorted(due)
            self._step(t, slots, due, expire=False)
        elif touched:
            self._step(t, sorted(touched), due, expire=False)
        if self._qn == 0:
            self._qmin = _INF

    # ------------------------------------------------------------------
    def _expire_pending(self, t: float) -> None:
        """No ready replica: age out pending requests past their timeout."""
        pending = self._pending
        arr = self._arr_l
        timeout = self.timeout_s
        spans = self._spans
        want = spans.want_l if spans is not None else None
        if len(pending) >= _VEC_MIN:
            arr_v = self._arr
            pa = np.fromiter(pending, dtype=np.int64, count=len(pending))
            keep = (t - arr_v[pa]) <= timeout
            n_keep = int(keep.sum())
            if n_keep != len(pending):
                self.failed += len(pending) - n_keep
                if want is not None:
                    for i in pa[~keep].tolist():
                        if want[i]:
                            spans.expire(i, t, arr[i])
                pa = pa[keep]
                self._pending = pa.tolist()
                self._pmin = float(arr_v[pa].min()) if n_keep else _INF
            return
        kept: List[int] = []
        pmin = _INF
        for i in pending:
            if t - arr[i] > timeout:
                self.failed += 1
                if want is not None and want[i]:
                    spans.expire(i, t, arr[i])
            else:
                kept.append(i)
                if arr[i] < pmin:
                    pmin = arr[i]
        self._pending = kept
        self._pmin = pmin

    def _dispatch(self, t: float, due: Set[int]) -> None:
        ready = self._ready_slots
        if not ready:
            self._expire_pending(t)
            return
        pending = self._pending
        arr = self._arr_l
        timeout = self.timeout_s
        reps = self._reps
        touched = self._touched
        svc = self._svc_l
        rcode = self._rcode_l
        heap = self._heap
        conc = self.concurrency
        loads = self._loads
        nready = len(ready)
        spans = self._spans
        want = spans.want_l if spans is not None else None
        qn = 0
        qmin = self._qmin
        # pmin bounds every pending arrival from below, so when even the
        # oldest request is within the timeout the per-request check is
        # skipped
        check_to = t - self._pmin > timeout
        rr = self._lb_kind == "rr"
        if rr:
            cur = self._rr_cursor
        else:
            # least-loaded waterfill: assign each request in turn to the
            # argmin of (load, rtt, id)
            ready_reps = self._ready_reps
            ids = self._ids
            cols = self._cols
            rng = range(1, nready)
        for i in pending:
            if check_to and t - arr[i] > timeout:
                self.failed += 1
                if want is not None and want[i]:
                    spans.expire(i, t, arr[i])
                continue
            rc = rcode[i]
            if rr:
                best = cur % nready
                cur += 1
                rep = reps[ready[best]]
            else:
                col = cols.get(rc)
                if col is None:
                    col = cols[rc] = [r.rtt[rc] for r in ready_reps]
                best, bl, br, bi = 0, loads[0], col[0], ids[0]
                for j in rng:
                    lj = loads[j]
                    if lj > bl:
                        continue
                    if lj < bl or col[j] < br or (
                        col[j] == br and ids[j] < bi
                    ):
                        best, bl, br, bi = j, lj, col[j], ids[j]
                rep = ready_reps[best]
            # round-robin routing ignores loads, but _step's bookkeeping
            # decrements them, so both balancers keep the counts honest
            loads[best] += 1
            s = rep.slot
            tap = want is not None and want[i]
            if tap:
                spans.dispatch(i, t, rep.ord, rep.rtt[rc], arr[i])
            run = rep.running
            if not rep.queue and len(run) < conc and s not in due:
                # immediate start == queue-then-start this sub-step
                finish = t + svc[i] * (1.0 + 0.15 * len(run))
                run.append((finish, i))
                heapq.heappush(heap, (finish, s))
                if tap:
                    spans.start(i, t)
                continue
            a = arr[i] - rep.rtt[rc]
            rep.queue.append(i)
            rep.qage.append(a)
            touched.add(s)
            qn += 1
            if a < qmin:
                qmin = a
            if a < rep.qmin:
                rep.qmin = a
        if rr:
            self._rr_cursor = cur
        self._qn += qn
        self._qmin = qmin
        # with ready replicas, every non-expired request was routed
        self._pending = []
        self._pmin = _INF

    # ------------------------------------------------------------------
    def _step(self, t: float, slots: Sequence[int], due: Set[int],
              expire: bool) -> None:
        arr = self._arr_l
        svc = self._svc_l
        rcode = self._rcode_l
        timeout = self.timeout_s
        conc = self.concurrency
        heap = self._heap
        reps = self._reps
        loads = self._loads
        pos = self._pos
        spans = self._spans
        want = spans.want_l if spans is not None else None
        for s in slots:
            rep = reps[s]
            run = rep.running
            # completions (in start order)
            if s in due:
                still: List[Tuple[float, int]] = []
                n_done = 0
                for f, i in run:
                    if f <= t:
                        e2e = (f - arr[i]) + rep.rtt[rcode[i]]
                        ok = e2e <= timeout
                        if ok:
                            self.latencies.append(e2e)
                            self.completed += 1
                        else:
                            self.failed += 1
                        if want is not None and want[i]:
                            spans.finish(i, f, "ok" if ok else "timeout",
                                         e2e)
                        n_done += 1
                    else:
                        still.append((f, i))
                rep.running = run = still
                loads[pos[s]] -= n_done
            # queue expiry (client hung up past its timeout).  Expired
            # entries are almost always a FIFO prefix, so pop from the
            # front; the post-pop min detects the rare mid-queue stragglers
            # (retried requests carry their original arrival time).
            q = rep.queue
            if expire and q and t - rep.qmin > timeout:
                ages = rep.qage
                nq = len(q)
                k = 0
                while k < nq and t - ages[k] > timeout:
                    k += 1
                if k:
                    if want is not None:
                        for i in q[:k]:
                            if want[i]:
                                spans.expire(i, t, arr[i])
                    del q[:k]
                    del ages[:k]
                    self.failed += k
                    self._qn -= k
                    loads[pos[s]] -= k
                if ages:
                    qmin = min(ages)
                    if t - qmin > timeout:
                        kept: List[int] = []
                        kept_a: List[float] = []
                        for i, a in zip(q, ages):
                            if t - a <= timeout:
                                kept.append(i)
                                kept_a.append(a)
                            elif want is not None and want[i]:
                                spans.expire(i, t, arr[i])
                        n_exp = len(q) - len(kept)
                        rep.queue = q = kept
                        rep.qage = ages = kept_a
                        self.failed += n_exp
                        self._qn -= n_exp
                        loads[pos[s]] -= n_exp
                        qmin = min(ages) if ages else _INF
                    rep.qmin = qmin
                else:
                    rep.qmin = _INF
            # starts: pull queued work into free slots
            if q and len(run) < conc:
                j = 0
                nq = len(q)
                while j < nq and len(run) < conc:
                    i = q[j]
                    j += 1
                    finish = t + svc[i] * (1.0 + 0.15 * len(run))
                    run.append((finish, i))
                    heapq.heappush(heap, (finish, s))
                    if want is not None and want[i]:
                        spans.start(i, t)
                del q[:j]
                del rep.qage[:j]
                self._qn -= j

    # ------------------------------------------------------------------
    # token mode: the continuous-batching path
    # ------------------------------------------------------------------
    def _active_token(self, t: float) -> bool:
        """Arrivals due, pending work to route or expire, or a replica with
        live batch state."""
        if self._ptr < self._n and self._arr_l[self._ptr] <= t:
            return True
        if self._pending:
            if self._ready_slots:
                return True
            if t - self._pmin > self.timeout_s:
                return True
        return bool(self._busy)

    def _process_token(self, t: float) -> None:
        # 1) arrivals, batched as in the request path
        ptr = self._ptr
        if ptr < self._n and self._arr_l[ptr] <= t:
            new_ptr = int(self._searchsorted(t, side="right"))
            self._pending.extend(range(ptr, new_ptr))
            m = self._arr_l[ptr]
            if m < self._pmin:
                self._pmin = m
            self._ptr = new_ptr
            self._obs.append((t, new_ptr - ptr))
        # 2) route pending requests into the replicas' batches
        if self._pending:
            self._dispatch_token(t)
        # 3) run every busy batch's iterations up to t
        if self._busy:
            self._advance_batches(t)

    def _dispatch_token(self, t: float) -> None:
        pending = self._pending
        arr = self._arr_l
        timeout = self.timeout_s
        ready = self._ready_slots
        spans = self._spans
        want = spans.want_l if spans is not None else None
        if not ready:
            # nothing to route to: age out the requests past their timeout
            kept: List[int] = []
            pmin = _INF
            for i in pending:
                if t - arr[i] > timeout:
                    self.failed += 1
                    if want is not None and want[i]:
                        spans.expire(i, t, arr[i])
                else:
                    kept.append(i)
                    if arr[i] < pmin:
                        pmin = arr[i]
            self._pending = kept
            self._pmin = pmin
            return
        reps = self._reps
        busy = self._busy
        ptok = self._ptok_l
        otok = self._otok_l
        rcode = self._rcode_l
        loads = self._loads
        nready = len(ready)
        check_to = t - self._pmin > timeout
        rr = self._lb_kind == "rr"
        if rr:
            cur = self._rr_cursor
        else:
            # least-loaded waterfill over (load, rtt, id), the load a
            # batch's sequences plus its admission queue
            ready_reps = self._ready_reps
            ids = self._ids
            cols = self._cols
            rng = range(1, nready)
        for i in pending:
            if check_to and t - arr[i] > timeout:
                self.failed += 1
                if want is not None and want[i]:
                    spans.expire(i, t, arr[i])
                continue
            rc = rcode[i]
            if rr:
                best = cur % nready
                cur += 1
                rep = reps[ready[best]]
            else:
                col = cols.get(rc)
                if col is None:
                    col = cols[rc] = [r.rtt[rc] for r in ready_reps]
                best, bl, br, bi = 0, loads[0], col[0], ids[0]
                for j in rng:
                    lj = loads[j]
                    if lj > bl:
                        continue
                    if lj < bl or col[j] < br or (
                        col[j] == br and ids[j] < bi
                    ):
                        best, bl, br, bi = j, lj, col[j], ids[j]
                rep = ready_reps[best]
            ok = rep.batch.enqueue(i, ptok[i], otok[i], arr[i], t,
                                   rtt_s=rep.rtt[rc])
            if ok:
                loads[best] += 1
                busy.add(rep.slot)
            else:
                self.failed += 1         # can never fit the KV budget
            if want is not None and want[i]:
                # TokenReplica.submit's order: dispatch, then track (it
                # was admitted) or reject (it never fits)
                spans.dispatch(i, t, rep.ord, rep.rtt[rc], arr[i],
                               token=True)
                if ok:
                    rep.batch.track(i, i)
                else:
                    spans.reject(i, t)
        if rr:
            self._rr_cursor = cur
        self._pending = []
        self._pmin = _INF

    def _advance_batches(self, t: float) -> None:
        timeout = self.timeout_s
        loads = self._loads
        pos = self._pos
        rcode = self._rcode_l
        records = self._token_records
        spans = self._spans
        want = spans.want_l if spans is not None else None
        overhead = self._token_cfg.overhead_s
        arr = self._arr_l
        idle: List[int] = []
        for s in sorted(self._busy):
            rep = self._reps[s]
            batch = rep.batch
            n_removed = 0
            for c in batch.advance(t):
                i = c.key
                rtt = rep.rtt[rcode[i]]
                e2e = c.finish_s - c.arrival_s + rtt
                ok = e2e <= timeout
                if ok:
                    self.latencies.append(e2e)
                    self.completed += 1
                    records.append(TokenRecord(
                        req_id=i, arrival_s=c.arrival_s,
                        first_token_s=c.first_token_s, finish_s=c.finish_s,
                        output_tokens=c.output_tokens, rtt_s=rtt))
                else:
                    self.failed += 1
                if want is not None and want[i]:
                    spans.finish_token(i, c.first_token_s, c.finish_s,
                                       overhead, "ok" if ok else "timeout",
                                       e2e)
                n_removed += 1
            if timeout > 0 and batch.n_queued:
                expired = batch.expire_queue(t, timeout)
                self.failed += len(expired)
                if want is not None:
                    for i in expired:
                        if want[i]:
                            spans.expire(i, t, arr[i])
                n_removed += len(expired)
            if n_removed:
                loads[pos[s]] -= n_removed
            if batch.load == 0:
                idle.append(s)
        for s in idle:
            self._busy.discard(s)

    # ------------------------------------------------------------------
    def run(self, duration_s: Optional[float] = None) -> ServingResult:
        # the run's registry takes the library's counters (the latency
        # model's fallback) in this scope
        with use_registry(self.obs.registry):
            base = self.cluster.run(duration_s)
        # drain: anything still pending/in-flight past the horizon fails
        self.failed += len(self._pending)
        for rep in self._reps:
            self.failed += rep.load
        if self._spans is not None:
            self._spans.finalize(base.duration_s)
        token_stats = None
        if self._token_cfg is not None:
            knobs = self._token_knobs
            token_stats = TokenStats.from_records(
                self._token_records,
                slo_ttft_s=knobs.slo_ttft_s,
                slo_tpot_s=knobs.slo_tpot_s,
                horizon_s=base.duration_s,
                window_s=knobs.goodput_window_s,
                n_requests=self._ptr,
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
            n_requests=self._ptr,
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
