"""The two-phase scenario engine: phase A on the host, phase B on the card.

Own copies of ``JaxServingEngine``, ``run_cells``, ``run_schedules``,
``assemble_result`` and ``_empty_result`` from
``repro.serving.jaxengine.engine``.

``TorchServingEngine`` is the port's ``VectorizedServingEngine`` (the
NumPy oracle, ``repro_torch.serving.engine``) with its tick and kill hooks
overridden: its ``record_schedule`` runs the real control plane once
(phase A: cluster simulator, policy, autoscaler; exact costs, preemptions,
launch failures and draws by construction) and records what the data plane
needs as a ``CellSchedule``.

``run_schedules`` is phase B over many cells.  Cells that share
``(grid.signature, concurrency, lb_kind, timeout_s > 0, trace_on)`` form
one shape group, are padded to the group's largest tape, slot count, kill
count and region count (a padded arrival is +inf and never arrives, a
padded slot is never ready, a padded kill event lies past the horizon) and
run as one launch of ``scenario_scan``.  A lane whose queue pool
overflowed comes back as ``None``.

``run_cells`` runs a matrix end to end: phase A per cell, one
``run_schedules`` call, and every lane that came back ``None`` rerun on
the oracle from the cell's pristine control-plane state, as the reference
does, so the pool size never changes a result.  A token-model cell
(``replica_model="token"``) has no phase B: its continuous batches carry
per-sequence KV state of data-dependent shape, so, as in the reference, it
runs on the host engine (``VectorizedServingEngine.run``) beside the
matrix's launches, and ``record_schedule`` refuses it.

Observability follows the reference's engine: phase A runs the real control
plane, so the cluster's taps record the decision and lifecycle events of the
other engines (no window samples: phase A's tick never runs the sampler).
A cell carries span timelines through ``scenario_scan`` exactly when its
recorder samples request spans, and ``run_cells`` rebuilds the sampled
spans from the lane's ``disp_t``, ``start_t``, ``fin_t`` and ``rep``
outputs; the result carries the registry's snapshot and the recorder.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.obs.registry import use_registry
from repro_torch.serving.engine import VectorizedServingEngine, _Rep
from repro_torch.serving.result import ServingResult
from repro_torch.serving.torchengine.kernel import KernelKey, run_group
from repro_torch.serving.torchengine.schedule import (
    BaseMetrics,
    CellSchedule,
    ScheduleRecorder,
    build_grid,
)

__all__ = ["DEFAULT_QUEUE_CAPACITY", "TorchServingEngine", "assemble_result",
           "group_key", "pack_group", "reconstruct_spans", "run_cells",
           "run_schedules"]

#: per-replica queue pool size (static shape); overflow => oracle rerun
DEFAULT_QUEUE_CAPACITY = 256


class TorchServingEngine(VectorizedServingEngine):
    """The two-phase engine behind the ``VectorizedServingEngine`` API.

    Phase B carries span timelines (dispatch, start, finish and slot of
    every resolved request) exactly when the engine's recorder (``obs=``)
    samples request spans, as in the reference."""

    def __init__(self, trace, policy, requests, cfg, **kw) -> None:
        # pristine control-plane state for the overflow fallback (phase A
        # consumes the policy's and the autoscaler's state)
        self._pristine = {
            "trace": trace,
            "policy": copy.deepcopy(policy),
            "requests": requests,
            "cfg": cfg,
            "kw": {k: (copy.deepcopy(v) if k in ("autoscaler", "lb") else v)
                   for k, v in kw.items()},
        }
        super().__init__(trace, policy, requests, cfg, **kw)
        self._rec: Optional[ScheduleRecorder] = None
        self.schedule: Optional[CellSchedule] = None
        #: set by ``run_cells`` when the lane overflowed and the oracle ran
        self.fell_back = False
        #: set by ``run_cells`` when a token-model cell ran on the host
        self.ran_on_host = False

    # -- phase-A hooks ------------------------------------------------
    def _tick(self, now, cluster) -> None:
        rec = self._rec
        if rec is None:
            super()._tick(now, cluster)
            return
        self._sync(now)
        k = rec.record_tick(self._ready_slots)
        obs = rec.obs_for(k)
        if obs:
            self._observe_batch(list(obs))

    def _kill(self, rep: _Rep, now: Optional[float] = None) -> None:
        rec = self._rec
        if rec is None:
            super()._kill(rep, now)
            return
        if rep.dead:
            return
        rep.dead = True
        self._live_dirty = True
        rec.record_kill(rep.slot)

    # -- phase A ------------------------------------------------------
    def record_schedule(self, duration_s: Optional[float] = None
                        ) -> CellSchedule:
        """Run the control plane once; return the phase-B payload (with
        span timelines when the recorder samples request spans).  Consumes
        this engine (the cluster has run); callable once.  A token-model
        cell has no phase B and is refused."""
        if self._token_cfg is not None:
            raise RuntimeError("token-model cells run on the NumPy data "
                               "plane; call run() directly")
        if self._rec is not None or self.schedule is not None:
            raise RuntimeError("record_schedule runs once per engine")
        dt = self.cluster.config.control_interval_s
        dur = float(duration_s or self.cluster.trace.duration_s)
        grid = build_grid(dur, dt, self.sub_step_s)
        self._rec = ScheduleRecorder(grid, self._arr)
        # the library's counters in phase A land on this run's registry
        with use_registry(self.obs.registry):
            base = self.cluster.run(duration_s)
        ready, rtt, kill_slot, kill_g, post = self._rec.control_arrays(
            len(self._reps),
            [r.rtt for r in self._reps],
            len(self._client_regions),
        )
        self._rec = None
        self.schedule = CellSchedule(
            policy_name=self.cluster.policy.name,
            trace_name=self.cluster.trace.name,
            workload_name=self.workload_name,
            arr=self._arr,
            svc=self._svc,
            rcode=self._rcode,
            n_regions=max(len(self._client_regions), 1),
            timeout_s=self.timeout_s,
            concurrency=self.concurrency,
            lb_kind=self._lb_kind,
            grid=grid,
            ready_mask=ready,
            rtt=rtt,
            kill_slot=kill_slot,
            kill_g=kill_g,
            post_slots=post,
            base=BaseMetrics(**{f.name: getattr(base, f.name)
                                for f in dataclasses.fields(BaseMetrics)}),
            n_slots=len(self._reps),
            trace_on=self._spans is not None,
        )
        return self.schedule

    def _fallback_run(self, duration_s: Optional[float]) -> ServingResult:
        """Oracle rerun from pristine control-plane state (overflow)."""
        p = self._pristine
        kw = {k: (copy.deepcopy(v) if k in ("autoscaler", "lb") else v)
              for k, v in p["kw"].items()}
        # a fresh recorder: the rerun replays the whole control plane, and
        # this engine's recorder already holds phase A's events
        kw["obs"] = self.obs.fresh()
        eng = VectorizedServingEngine(
            p["trace"], copy.deepcopy(p["policy"]), p["requests"], p["cfg"],
            **kw,
        )
        return eng.run(duration_s)

    # -- public API ---------------------------------------------------
    def run(self, duration_s: Optional[float] = None, *,
            device: Union[str, torch.device, None] = None) -> ServingResult:
        return run_cells([self], [duration_s], device=device)[0]


def _result(sched: CellSchedule, **counts) -> ServingResult:
    base = sched.base
    return ServingResult(
        policy=sched.policy_name,
        trace=sched.trace_name,
        workload=sched.workload_name,
        total_cost=base.total_cost,
        spot_cost=base.spot_cost,
        od_cost=base.od_cost,
        cost_vs_ondemand=base.cost_vs_ondemand,
        availability=base.availability,
        n_preemptions=base.n_preemptions,
        n_launch_failures=base.n_launch_failures,
        **counts,
    )


def assemble_result(sched: CellSchedule, out: Dict) -> ServingResult:
    """A cell's ``ServingResult`` from its lane's kernel outputs."""
    n = sched.n
    status = np.asarray(out["status"][:n])
    e2e = np.asarray(out["e2e"][:n])
    n_req = int(out["a_ptr"])
    comp = status == 1
    # drain: arrived but unresolved (pending / in flight / queued, and work
    # on slots killed past the horizon) fails, as in the oracle
    n_failed = int((status == 2).sum()) + int((status[:n_req] == 0).sum())
    n_retried = int(out["n_retried"])
    for s in sched.post_slots:
        # a kill after the last control tick: the oracle re-pends the slot's
        # work before the drain, and the scan never saw the event, so the
        # slot's final occupancy is exactly what the oracle re-pended
        n_retried += int(out["run_n"][s]) + int(out["q_cnt"][s])
    return _result(sched, n_requests=n_req, n_completed=int(comp.sum()),
                   n_failed=n_failed, latencies_s=e2e[comp],
                   n_retried_requests=n_retried)


def _empty_result(sched: CellSchedule) -> ServingResult:
    """No control ticks, an empty tape or no replica: nothing to scan, every
    arrival fails at the drain."""
    n_req = (
        int(np.searchsorted(sched.arr, sched.grid.ts[-1], side="right"))
        if sched.grid.n_points and sched.n
        else 0
    )
    return _result(sched, n_requests=n_req, n_completed=0, n_failed=n_req,
                   latencies_s=np.empty(0), n_retried_requests=0)


def pack_group(
    cells: Sequence[CellSchedule], queue_capacity: int = DEFAULT_QUEUE_CAPACITY
) -> Tuple[KernelKey, Dict[str, np.ndarray], Tuple[np.ndarray, ...]]:
    """One shape group's launch inputs: its ``KernelKey``, the lanes padded
    to the group's largest tape, slot count, kill count and region count,
    and the shared grid arrays ``(ts, gs, wins)``.  The cells must share
    ``group_key``."""
    if len({group_key(c) for c in cells}) != 1:
        raise ValueError("the cells do not form one shape group")
    g = cells[0].grid
    N = max(c.n for c in cells)
    R = max(c.n_slots for c in cells)
    E = max(c.n_events for c in cells)
    NREG = max(c.n_regions for c in cells)
    L = len(cells)
    lanes = {
        "arr": np.full((L, N), np.inf),
        "svc": np.ones((L, N)),
        "rcode": np.zeros((L, N), dtype=np.int64),
        "rtt": np.zeros((L, R, NREG)),
        "ready": np.zeros((L, g.ticks, R), dtype=bool),
        "kill_slot": np.zeros((L, max(E, 1)), dtype=np.int64),
        "kill_g": np.full((L, max(E, 1)), g.n_points, dtype=np.int64),
        "timeout": np.zeros(L),
    }
    amax = 1
    for li, c in enumerate(cells):
        lanes["arr"][li, : c.n] = c.arr
        lanes["svc"][li, : c.n] = c.svc
        lanes["rcode"][li, : c.n] = c.rcode
        lanes["rtt"][li, : c.n_slots, : c.n_regions] = c.rtt
        lanes["ready"][li, :, : c.n_slots] = c.ready_mask
        lanes["kill_slot"][li, : c.n_events] = c.kill_slot
        lanes["kill_g"][li, : c.n_events] = c.kill_g
        lanes["timeout"][li] = c.timeout_s
        # the exact per-sub-step arrival bound (an overflow cause)
        counts = np.diff(np.searchsorted(c.arr, g.ts, side="right"), prepend=0)
        if counts.size:
            amax = max(amax, int(counts.max()))
    _, C, lb_kind, expire_on, trace_on = group_key(cells[0])
    key = KernelKey(
        G=g.n_points, W=g.ticks, N=N, R=R, Q=queue_capacity, C=C, NREG=NREG,
        E=E, AMAX=amax, lb_rr=(lb_kind == "rr"),
        expire_on=expire_on, trace_on=trace_on,
    )
    return key, lanes, (g.ts, np.arange(g.n_points, dtype=np.int64), g.win_of)


def group_key(sc: CellSchedule) -> tuple:
    """Cells with equal keys share one launch."""
    return (sc.grid.signature, sc.concurrency, sc.lb_kind, sc.timeout_s > 0,
            sc.trace_on)


def run_schedules(
    scheds: Sequence[CellSchedule],
    *,
    queue_capacity: int = DEFAULT_QUEUE_CAPACITY,
    outputs: Optional[List[Optional[dict]]] = None,
    groups: Optional[List[List[int]]] = None,
    device: Union[str, torch.device, None] = None,
) -> List[Optional[ServingResult]]:
    """Phase B over many cells, one launch per shape group, on CUDA unless
    ``device="cpu"`` (the plain version).  Results align with ``scheds``;
    ``None`` marks a lane whose queue pool overflowed.  Pass a list as
    ``outputs`` to also receive each lane's raw outputs (``None`` for
    overflowed and empty lanes), and one as ``groups`` to receive the
    indices of the cells each launch took."""
    dev = resolve_device(device)
    results: List[Optional[ServingResult]] = [None] * len(scheds)
    if outputs is not None:
        del outputs[:]
        outputs.extend([None] * len(scheds))
    by_key: Dict[tuple, List[int]] = {}
    for idx, sc in enumerate(scheds):
        if sc.grid.n_points == 0 or sc.n == 0 or sc.n_slots == 0:
            results[idx] = _empty_result(sc)
            continue
        by_key.setdefault(group_key(sc), []).append(idx)
    if groups is not None:
        groups[:] = by_key.values()

    for idxs in by_key.values():
        cells = [scheds[i] for i in idxs]
        key, lanes, grid = pack_group(cells, queue_capacity)
        out = run_group(key, lanes, *grid, device=dev)
        for li, i in enumerate(idxs):
            if bool(out["overflow"][li]):
                continue
            lane_out = {k: v[li] for k, v in out.items()}
            results[i] = assemble_result(cells[li], lane_out)
            if outputs is not None:
                outputs[i] = lane_out
    return results


def reconstruct_spans(eng: TorchServingEngine, sched: CellSchedule,
                      out: Dict) -> None:
    """Rebuild the sampled request spans of ``eng``'s recorder from its
    lane's span timelines (``disp_t``, ``start_t``, ``fin_t``, ``rep``).

    The kernel keeps one (dispatch, start, finish, slot) quadruple per
    resolved request: a request killed and retried records its last,
    resolving attempt (``attempts`` stays 1, no preempt cut), and a request
    failed at the drain or expired in a queue gets no span.  For a request
    never preempted the taps are the oracle's to the bit (float64 on the
    same grid), so the spans equal the oracle's after that filter.  A lane
    of a sampling cell without timelines raises: the spans are never
    dropped in silence."""
    spans = eng._spans
    if spans is None:
        return
    if "disp_t" not in out:
        raise RuntimeError(
            f"cell {sched.policy_name}/{sched.trace_name} samples request "
            "spans, but its phase-B outputs carry no span timelines")
    n = sched.n
    status = np.asarray(out["status"][:n])
    e2e = np.asarray(out["e2e"][:n])
    disp = np.asarray(out["disp_t"][:n])
    start = np.asarray(out["start_t"][:n])
    fin = np.asarray(out["fin_t"][:n])
    rep_slot = np.asarray(out["rep"][:n])
    rtt, rcode, arr = sched.rtt, sched.rcode, sched.arr
    ords = [r.ord for r in eng._reps]
    want = spans.want_l
    for o in np.flatnonzero(status[:len(want)] != 0).tolist():
        if not want[o]:
            continue
        slot = int(rep_slot[o])
        spans.dispatch(o, float(disp[o]), ords[slot],
                       float(rtt[slot, rcode[o]]), float(arr[o]))
        spans.start(o, float(start[o]))
        spans.finish(o, float(fin[o]),
                     "ok" if status[o] == 1 else "timeout", float(e2e[o]))


def run_cells(
    engines: Sequence[TorchServingEngine],
    durations: Optional[Sequence[Optional[float]]] = None,
    *,
    queue_capacity: int = DEFAULT_QUEUE_CAPACITY,
    outputs: Optional[List[Optional[dict]]] = None,
    groups: Optional[List[List[int]]] = None,
    device: Union[str, torch.device, None] = None,
) -> List[ServingResult]:
    """Run a batch of cells end to end: phase A per cell on the host (a
    cell whose schedule is already recorded keeps it), one
    ``run_schedules`` call (one launch per shape group, on CUDA unless
    ``device="cpu"``), and an oracle rerun for every lane whose queue pool
    overflowed (its engine's ``fell_back`` is set; the rerun records into a
    fresh recorder, which rides on its result).  A token-model cell runs on
    the host engine instead (its ``ran_on_host`` is set).  Every other cell
    has its sampled request spans rebuilt from its lane's span timelines
    and its registry's snapshot and recorder on its result.  Results align
    with ``engines``; ``outputs`` receives each lane's raw outputs and
    ``groups`` each launch's cells, as indices into ``engines``, as in
    ``run_schedules`` (``None`` in ``outputs`` for a rerun lane and a token
    cell, which is in no group)."""
    dev = resolve_device(device)        # before any cell runs
    if durations is None:
        durations = [None] * len(engines)
    results: List[Optional[ServingResult]] = [None] * len(engines)
    lane_of: List[int] = []             # schedule index -> engine index
    scheds: List[CellSchedule] = []
    for i, (eng, dur) in enumerate(zip(engines, durations)):
        if eng._token_cfg is not None:
            results[i] = VectorizedServingEngine.run(eng, dur)
            eng.ran_on_host = True
            continue
        scheds.append(eng.schedule if eng.schedule is not None
                      else eng.record_schedule(dur))
        lane_of.append(i)
    lane_outs_all: List[Optional[dict]] = []
    lane_groups: List[List[int]] = []
    lanes = run_schedules(scheds, queue_capacity=queue_capacity,
                          outputs=lane_outs_all, groups=lane_groups,
                          device=dev)
    for k, res in enumerate(lanes):
        i = lane_of[k]
        eng = engines[i]
        if res is None:     # queue pool overflow -> oracle rerun
            eng.fell_back = True
            res = eng._fallback_run(durations[i])
        else:
            if lane_outs_all[k] is not None:
                reconstruct_spans(eng, scheds[k], lane_outs_all[k])
            obs = eng.obs
            res = dataclasses.replace(
                res, metrics=obs.registry.snapshot() or None,
                obs=obs if obs.enabled else None)
        results[i] = res
    if outputs is not None:
        del outputs[:]
        outputs.extend([None] * len(engines))
        for k, out in enumerate(lane_outs_all):
            outputs[lane_of[k]] = out
    if groups is not None:
        groups[:] = [[lane_of[k] for k in g] for g in lane_groups]
    return results
