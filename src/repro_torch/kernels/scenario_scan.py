"""The scenario engine's data plane: the CUDA kernel
``csrc/scenario_scan.cu`` (one warp per lane walking the whole sub-step
grid, its state in shared memory, each replica slot worked by the thread
that owns it) and its plain PyTorch version ``plain``.

Counterpart of the reference's ``_build_kernel`` / ``lane`` in
``repro.serving.jaxengine.kernel``: one lane is one cell of a scenario
matrix, and every lane of a shape group runs in one launch.  Inputs, with a
leading lane dimension L: ``arr``/``svc`` [L, N] float64 (+inf / 1.0
padded), ``rcode`` [L, N], ``rtt`` [L, R, NREG] float64, ``ready``
[L, W, R] bool, ``kill_slot``/``kill_g`` [L, E] (``kill_g`` = G for a
padded event), ``timeout`` [L] float64; the grid ``ts`` [G] float64,
``gs``/``wins`` [G].  Outputs are the reference lane's: ``status`` int8,
``e2e`` float64 [L, N]; ``a_ptr``, ``n_retried`` int64 and ``overflow``
bool [L]; ``run_n``, ``q_cnt`` int64 [L, R]; with ``trace_on`` also
``disp_t``, ``start_t``, ``fin_t`` float64 and ``rep`` int64 [L, N].

The plain version computes what the reference's ``lane`` computes under
``vmap``, written over lanes as a leading tensor dimension in float64: one
Python loop over the G sub-steps of the grid, and inside each
step the stages of the request-model serving loop

1. kill events due at this grid index (in-flight work re-pends in start
   order, then the slot's queue in FIFO order);
2. arrivals up to ``t`` pushed onto the pending ring;
3. dispatch of every pending request, least-loaded (lexicographic
   (load, RTT, slot) minimum over the ready slots) or round-robin, with the
   immediate-start test against the ``due`` flags taken before the stage;
   an expired request is dropped;
4. completions (every running entry with finish <= t), resolved with the
   RTT-inclusive deadline and compacted in start order;
5. RTT-inclusive queue expiry (``timeout_s > 0`` only);
6. starts: queues drain into freed capacity, slot by slot, FIFO.

Where ``vmap`` runs a fixed number of masked pops and then a ``while``
remainder, this runs masked pops (the lanes whose condition holds, the rest
untouched) ``while`` any lane has one: the same pops in the same order.
Ties go to the first index (``argmin`` / ``argmax``), as in the reference.
Every float is computed one operation at a time (eager PyTorch fuses
nothing), in the oracle's order: ``t + svc * (1.0 + 0.15 * n)``,
``(fin - arr) + rtt``, ``t - arr > timeout``, ``arr - rtt``.

Overflow (a push into a slot that already holds ``Q`` queued requests, or
more than ``amax`` arrivals in one sub-step) sets the lane's flag, and the
lane's outputs are then meaningless: the caller discards it.

``repro_torch.kernels.ops.scenario_scan`` picks between the two by the
device of its inputs and counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

#: shared memory a block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448
#: entries of the pending ring and of the tape window that a lane keeps in
#: shared memory (powers of two), and the least they shrink to when a
#: lane's state leaves less room: the ring spills to device memory past its
#: share, the window streams the tape in 4 chunks of at least 32 entries
PEND_CAP, TAPE_CAP = 2048, 1024
MIN_PEND_CAP, MIN_TAPE_CAP = 32, 128

_BIG = torch.iinfo(torch.int64).max
_INF = float("inf")

_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load("scenario_scan").scenario_scan_fwd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def smem_bytes(R: int, C: int, Q: int, NREG: int, trace_on: bool,
               pend_cap: int, tape_cap: int) -> int:
    """Shared memory of one lane's block (``csrc`` ``carve`` counts the
    same): the counters of the slots past the first 32 (40 bytes each; a
    thread keeps its first slot's in registers), the queue rings [R, Q]
    (request, age and, with ``trace_on``, the dispatch time), the running
    rows [R, C] (finish, arrival, RTT, request; with ``trace_on`` dispatch
    and start), the window's ready list [R], the RTT table and the
    least-loaded ranks [NREG, R], the pending ring's ``pend_cap`` entries
    and the tape window's ``tape_cap`` (arrival, service time, region)."""
    doubles = (R * Q * (2 if trace_on else 1) + R * C * (5 if trace_on else 3)
               + NREG * R + 2 * tape_cap)
    ints = R * Q + R * C + R + NREG * R + pend_cap + tape_cap
    return 40 * max(R - 32, 0) + 8 * doubles + 4 * ints


def smem_plan(R: int, C: int, Q: int, NREG: int,
              trace_on: bool) -> Tuple[int, int, int]:
    """``(bytes, pend_cap, tape_cap)`` of one lane's block: ``PEND_CAP`` and
    ``TAPE_CAP``, both halved until the block fits in ``MAX_SMEM_BYTES`` or
    both are at their minimums (the launch then refuses the shape)."""
    pend, tape = PEND_CAP, TAPE_CAP
    while True:
        nbytes = smem_bytes(R, C, Q, NREG, trace_on, pend, tape)
        if nbytes <= MAX_SMEM_BYTES or (pend, tape) == (MIN_PEND_CAP,
                                                          MIN_TAPE_CAP):
            return nbytes, pend, tape
        pend, tape = max(pend // 2, MIN_PEND_CAP), max(tape // 2, MIN_TAPE_CAP)


def _lanes(mask: torch.Tensor) -> torch.Tensor:
    return mask.nonzero(as_tuple=True)[0]


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True of each row (0 for a row of False)."""
    return mask.to(torch.int8).argmax(1)


class _Lanes:
    """The per-lane serving state, leading dimension L."""

    def __init__(self, L: int, N: int, R: int, Q: int, C: int,
                 trace_on: bool, dev: torch.device) -> None:
        i64, f64 = torch.int64, torch.float64
        self.N = N
        self.pend = torch.zeros((L, N + 1), dtype=i64, device=dev)
        self.p_head = torch.zeros(L, dtype=i64, device=dev)
        self.p_cnt = torch.zeros(L, dtype=i64, device=dev)
        self.a_ptr = torch.zeros(L, dtype=i64, device=dev)
        self.run_fin = torch.full((L, R, C), _INF, dtype=f64, device=dev)
        self.run_idx = torch.zeros((L, R, C), dtype=i64, device=dev)
        self.run_n = torch.zeros((L, R), dtype=i64, device=dev)
        self.q_idx = torch.zeros((L, R, Q), dtype=i64, device=dev)
        self.q_age = torch.zeros((L, R, Q), dtype=f64, device=dev)
        self.q_seq = torch.zeros((L, R, Q), dtype=i64, device=dev)
        self.q_valid = torch.zeros((L, R, Q), dtype=torch.bool, device=dev)
        self.q_cnt = torch.zeros((L, R), dtype=i64, device=dev)
        self.qmin = torch.full((L, R), _INF, dtype=f64, device=dev)
        self.seq_ctr = torch.zeros(L, dtype=i64, device=dev)
        self.rr_cur = torch.zeros(L, dtype=i64, device=dev)
        self.kill_ptr = torch.zeros(L, dtype=i64, device=dev)
        self.n_retried = torch.zeros(L, dtype=i64, device=dev)
        self.overflow = torch.zeros(L, dtype=torch.bool, device=dev)
        self.status = torch.zeros((L, N + 1), dtype=torch.int8, device=dev)
        self.e2e = torch.zeros((L, N + 1), dtype=f64, device=dev)
        self.trace_on = trace_on
        if trace_on:
            self.run_disp = torch.zeros((L, R, C), dtype=f64, device=dev)
            self.run_start = torch.zeros((L, R, C), dtype=f64, device=dev)
            self.q_disp = torch.zeros((L, R, Q), dtype=f64, device=dev)
            self.disp_t = torch.full((L, N + 1), -_INF, dtype=f64, device=dev)
            self.start_t = torch.full((L, N + 1), -_INF, dtype=f64, device=dev)
            self.fin_t = torch.full((L, N + 1), -_INF, dtype=f64, device=dev)
            self.rep = torch.full((L, N + 1), -1, dtype=i64, device=dev)

    def push(self, lanes: torch.Tensor, vals: torch.Tensor) -> None:
        """Append one request index to each given lane's pending ring."""
        pos = (self.p_head[lanes] + self.p_cnt[lanes]) % self.N
        self.pend[lanes, pos] = vals
        self.p_cnt[lanes] += 1

    def fifo_head(self, lanes, slots) -> torch.Tensor:
        """The queue cell with the smallest sequence number."""
        seqs = torch.where(self.q_valid[lanes, slots],
                           self.q_seq[lanes, slots], _BIG)
        return seqs.argmin(1)

    def q_pop(self, lanes, slots, cells) -> None:
        """Remove a queue cell; refresh the slot's cached minimum age."""
        self.q_valid[lanes, slots, cells] = False
        self.q_cnt[lanes, slots] -= 1
        ages = torch.where(self.q_valid[lanes, slots],
                           self.q_age[lanes, slots], _INF)
        self.qmin[lanes, slots] = ages.min(1).values

    def start(self, lanes, slots, reqs, t: float, svc, disp) -> None:
        """Start requests on their slots at ``t`` (finish time
        ``t + svc * (1.0 + 0.15 * n_running)``)."""
        rn = self.run_n[lanes, slots]
        fin = t + svc[lanes, reqs] * (1.0 + 0.15 * rn.to(torch.float64))
        self.run_fin[lanes, slots, rn] = fin
        self.run_idx[lanes, slots, rn] = reqs
        self.run_n[lanes, slots] += 1
        if self.trace_on:
            self.run_disp[lanes, slots, rn] = disp
            self.run_start[lanes, slots, rn] = t


def plain(
    arr: torch.Tensor,        # [L, N] float64, sorted, +inf padded
    svc: torch.Tensor,        # [L, N] float64
    rcode: torch.Tensor,      # [L, N] int64
    rtt: torch.Tensor,        # [L, R, NREG] float64
    ready: torch.Tensor,      # [L, W, R] bool
    kill_slot: torch.Tensor,  # [L, E] int64
    kill_g: torch.Tensor,     # [L, E] int64, G for a padded event
    timeout: torch.Tensor,    # [L] float64
    ts: torch.Tensor,         # [G] float64
    gs: torch.Tensor,         # [G] int64
    wins: torch.Tensor,       # [G] int64
    *,
    Q: int,
    C: int,
    amax: int,
    lb_rr: bool,
    expire_on: bool,
    trace_on: bool,
) -> Dict[str, torch.Tensor]:
    """The plain version: every lane over the whole grid, the stages of each
    sub-step in the order listed above; returns the reference's lane
    outputs, each with a leading lane dimension."""
    L, N = arr.shape
    R = rtt.shape[1]
    E = kill_slot.shape[1]
    dev = arr.device
    s = _Lanes(L, N, R, Q, C, trace_on, dev)
    slot_ids = torch.arange(R, device=dev)
    ks = torch.arange(max(amax, 1), device=dev)
    # the arrival pointer after each sub-step, for every lane at once
    arrived = torch.searchsorted(
        arr, ts.to(arr.dtype).expand(L, -1).contiguous(), right=True)
    to = timeout[:, None]
    next_kill = -1           # recomputed whenever a kill pointer moves

    for k, (t, g, win) in enumerate(zip(ts.tolist(), gs.tolist(),
                                        wins.tolist())):
        # -- 1) kill events due before this sub-step ---------------------
        if E and next_kill <= g:
            while True:
                kp = s.kill_ptr.clamp(max=E - 1)
                live = s.kill_ptr < E
                act = live & (kill_g.gather(1, kp[:, None])[:, 0] <= g)
                if not bool(act.any()):
                    pend_g = torch.where(
                        live, kill_g.gather(1, kp[:, None])[:, 0], _BIG)
                    next_kill = int(pend_g.min())
                    break
                lanes = _lanes(act)
                slot = kill_slot[lanes, kp[lanes]]
                s.n_retried[lanes] += s.run_n[lanes, slot] + s.q_cnt[lanes, slot]
                for c in range(C):      # in-flight work, start order
                    take = c < s.run_n[lanes, slot]
                    if bool(take.any()):
                        s.push(lanes[take], s.run_idx[lanes[take], slot[take], c])
                while True:             # then the queue, FIFO
                    has = s.q_cnt[lanes, slot] > 0
                    if not bool(has.any()):
                        break
                    lh, sh = lanes[has], slot[has]
                    j = s.fifo_head(lh, sh)
                    s.push(lh, s.q_idx[lh, sh, j])
                    s.q_pop(lh, sh, j)
                s.run_fin[lanes, slot] = _INF
                s.run_n[lanes, slot] = 0
                s.kill_ptr[lanes] += 1

        # -- 2) arrivals ---------------------------------------------------
        new_ptr = arrived[:, k]
        cnt = new_ptr - s.a_ptr
        if bool(cnt.any()):
            src = s.a_ptr[:, None] + ks
            valid = src < new_ptr[:, None]
            pos = torch.where(valid, (s.p_head + s.p_cnt)[:, None] + ks, 0) % N
            pos = torch.where(valid, pos, N)          # row N: the dump
            s.pend.scatter_(1, pos, src)
            s.p_cnt += cnt
            s.a_ptr = new_ptr.clone()
            s.overflow |= cnt > amax

        # -- 3) due + dispatch ---------------------------------------------
        rdy = ready[:, win]
        nready = rdy.sum(1)
        due = (s.run_fin <= t).any(2)
        while True:
            act = (s.p_cnt > 0) & (nready > 0)
            if not bool(act.any()):
                break
            lanes = _lanes(act)
            i = s.pend[lanes, s.p_head[lanes]]
            s.p_head[lanes] = (s.p_head[lanes] + 1) % N
            s.p_cnt[lanes] -= 1
            ai = arr[lanes, i]
            ok = ~((t - ai) > timeout[lanes])
            rc = rcode[lanes, i]
            rd = rdy[lanes]
            if lb_rr:
                j = s.rr_cur[lanes] % nready[lanes].clamp(min=1)
                slot = _first(rd.cumsum(1) == (j + 1)[:, None])
                s.rr_cur[lanes] += ok.to(torch.int64)
            else:
                # lexicographic (load, rtt, slot) minimum over ready slots
                loads = s.run_n[lanes] + s.q_cnt[lanes]
                col = rtt[lanes[:, None], slot_ids[None, :], rc[:, None]]
                lmin = torch.where(rd, loads, _BIG).min(1, keepdim=True).values
                c1 = rd & (loads == lmin)
                cmin = torch.where(c1, col, _INF).min(1, keepdim=True).values
                slot = _first(c1 & (col == cmin))
            rn = s.run_n[lanes, slot]
            imm = (s.q_cnt[lanes, slot] == 0) & (rn < C) & ~due[lanes, slot]
            go = ok & imm
            if bool(go.any()):
                s.start(lanes[go], slot[go], i[go], t, svc, t)
            qu = ok & ~imm
            if bool(qu.any()):
                lq, sq, iq = lanes[qu], slot[qu], i[qu]
                # effective age arrival - rtt: the expiry sweep is then
                # RTT-inclusive
                age = arr[lq, iq] - rtt[lq, sq, rc[qu]]
                vrow = s.q_valid[lq, sq]
                s.overflow[lq] |= vrow.all(1)
                free = vrow.to(torch.int8).argmin(1)      # first free cell
                s.q_idx[lq, sq, free] = iq
                s.q_age[lq, sq, free] = age
                s.q_seq[lq, sq, free] = s.seq_ctr[lq]
                s.q_valid[lq, sq, free] = True
                if trace_on:
                    s.q_disp[lq, sq, free] = t
                s.q_cnt[lq, sq] += 1
                s.qmin[lq, sq] = torch.minimum(s.qmin[lq, sq], age)
                s.seq_ctr[lq] += 1
            # an expired request is dropped: status stays 0, the drain
            # counts it failed

        # -- 4) completions ------------------------------------------------
        fin = s.run_fin
        done = fin <= t
        if bool(done.any()):
            idx = s.run_idx.reshape(L, -1)
            rc = rcode.gather(1, idx).reshape(L, R, C)
            e2e = (fin - arr.gather(1, idx).reshape(L, R, C)) + rtt.gather(2, rc)
            scat = torch.where(done, s.run_idx, N).reshape(L, -1)
            verdict = torch.where(e2e > to[:, :, None], 2, 1).to(torch.int8)
            s.status.scatter_(1, scat, verdict.reshape(L, -1))
            s.e2e.scatter_(1, scat, e2e.reshape(L, -1))
            if trace_on:
                # a retried request overwrites its earlier attempt: these
                # record the final, completing one
                s.disp_t.scatter_(1, scat, s.run_disp.reshape(L, -1))
                s.start_t.scatter_(1, scat, s.run_start.reshape(L, -1))
                s.fin_t.scatter_(1, scat, fin.reshape(L, -1))
                s.rep.scatter_(1, scat, slot_ids[None, :, None].expand(
                    L, R, C).reshape(L, -1))
            order = done.to(torch.int8).argsort(dim=2, stable=True)
            s.run_fin = torch.where(done, _INF, fin).gather(2, order)
            s.run_idx = s.run_idx.gather(2, order)
            s.run_n -= done.sum(2)
            if trace_on:
                s.run_disp = s.run_disp.gather(2, order)
                s.run_start = s.run_start.gather(2, order)

        # -- 5) queue expiry (one whole slot per pass) ---------------------
        if expire_on:
            while True:
                hit = (s.q_cnt > 0) & ((t - s.qmin) > to)
                lanes = _lanes(hit.any(1))
                if not lanes.numel():
                    break
                slot = _first(hit[lanes])
                vrow = s.q_valid[lanes, slot]
                age = s.q_age[lanes, slot]
                keep = vrow & ~((t - age) > to[lanes])
                s.q_valid[lanes, slot] = keep
                s.q_cnt[lanes, slot] = keep.sum(1)
                s.qmin[lanes, slot] = torch.where(keep, age, _INF).min(1).values

        # -- 6) starts: queues drain into freed capacity -------------------
        while True:
            can = rdy & (s.run_n < C) & (s.q_cnt > 0)
            lanes = _lanes(can.any(1))
            if not lanes.numel():
                break
            slot = _first(can[lanes])
            j = s.fifo_head(lanes, slot)
            s.start(lanes, slot, s.q_idx[lanes, slot, j], t, svc,
                    s.q_disp[lanes, slot, j] if trace_on else None)
            s.q_pop(lanes, slot, j)

    out = {
        "status": s.status[:, :N],
        "e2e": s.e2e[:, :N],
        "a_ptr": s.a_ptr,
        "run_n": s.run_n,
        "q_cnt": s.q_cnt,
        "n_retried": s.n_retried,
        "overflow": s.overflow,
    }
    if trace_on:
        out.update(disp_t=s.disp_t[:, :N], start_t=s.start_t[:, :N],
                   rep=s.rep[:, :N], fin_t=s.fin_t[:, :N])
    return out


def new_outputs(L: int, N: int, R: int, trace_on: bool,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """The lane outputs as a launch starts them: counters and statuses zero,
    span timelines -inf and slots -1 for requests never resolved."""
    f64 = torch.float64
    out = {
        "status": torch.zeros((L, N), dtype=torch.int8, device=device),
        "e2e": torch.zeros((L, N), dtype=f64, device=device),
        "a_ptr": torch.zeros(L, dtype=torch.int64, device=device),
        "run_n": torch.zeros((L, R), dtype=torch.int64, device=device),
        "q_cnt": torch.zeros((L, R), dtype=torch.int64, device=device),
        "n_retried": torch.zeros(L, dtype=torch.int64, device=device),
        "overflow": torch.zeros(L, dtype=torch.bool, device=device),
    }
    if trace_on:
        for k in ("disp_t", "start_t", "fin_t"):
            out[k] = torch.full((L, N), float("-inf"), dtype=f64,
                                device=device)
        out["rep"] = torch.full((L, N), -1, dtype=torch.int64, device=device)
    return out


def launch(arr, svc, rcode, rtt, ready, kill_slot, kill_g, timeout, ts, gs,
           wins, *, Q: int, C: int, amax: int, lb_rr: bool, expire_on: bool,
           trace_on: bool) -> Dict[str, torch.Tensor]:
    """Launch the kernel on the current stream (one block per lane).
    Raises on inputs the kernel does not take and on a refused launch.  A
    lane that overflows stops at the end of that sub-step: only its
    ``overflow`` flag is meaningful, as in the reference."""
    if arr.dim() != 2:
        raise ValueError(f"arr must be [L, N], got {tuple(arr.shape)}")
    L, N = arr.shape
    if rtt.dim() != 3 or rtt.shape[0] != L:
        raise ValueError(f"rtt must be [L, R, NREG], got {tuple(rtt.shape)}")
    R, NREG = rtt.shape[1], rtt.shape[2]
    if ready.dim() != 3 or ready.shape[0] != L or ready.shape[2] != R:
        raise ValueError(f"ready must be [L, W, R={R}], got {tuple(ready.shape)}")
    W = ready.shape[1]
    E = kill_slot.shape[1]
    G = ts.shape[0]
    for name, t, shape in (("svc", svc, (L, N)), ("rcode", rcode, (L, N)),
                           ("kill_slot", kill_slot, (L, E)),
                           ("kill_g", kill_g, (L, E)), ("timeout", timeout, (L,)),
                           ("gs", gs, (G,)), ("wins", wins, (G,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    tensors = (arr, svc, rcode, rtt, ready, kill_slot, kill_g, timeout, ts,
               gs, wins)
    dev = arr.device
    if any(t.device != dev for t in tensors) or dev.type != "cuda":
        raise ValueError("every input must lie on one CUDA device")
    NP = 1 << (N - 1).bit_length()     # the pending rings' spill length
    if max(NP, R, NREG, W, E, G, Q, C) >= 2 ** 31 or L > 2 ** 31 - 1:
        raise ValueError("a dimension exceeds the kernel's 32-bit indices")
    if min(L, N, R, NREG, W, G, Q, C) < 1:
        raise ValueError("every dimension but E must be at least 1")
    smem, pend_cap, tape_cap = smem_plan(R, C, Q, NREG, trace_on)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"R={R}, C={C}, Q={Q}, NREG={NREG} need {smem} bytes "
                         f"of shared memory a lane; a block has {MAX_SMEM_BYTES}")
    f64, i32 = torch.float64, torch.int32
    ins = [arr.to(f64).contiguous(), svc.to(f64).contiguous(),
           rcode.to(i32).contiguous(), rtt.to(f64).contiguous(),
           ready.to(torch.uint8).contiguous(), kill_slot.to(i32).contiguous(),
           kill_g.to(i32).contiguous(), timeout.to(f64).contiguous(),
           ts.to(f64).contiguous(), gs.to(i32).contiguous(),
           wins.to(i32).contiguous()]
    out = new_outputs(L, N, R, trace_on, dev)
    pend = torch.empty((L, NP), dtype=i32, device=dev)     # rings' spill
    names = ("status", "e2e", "a_ptr", "run_n", "q_cnt", "n_retried",
             "overflow", "disp_t", "start_t", "fin_t", "rep")
    ptrs = [t.data_ptr() for t in ins] + [pend.data_ptr()] + [
        out[k].data_ptr() if k in out else None for k in names]
    dims = [L, N, R, NREG, W, E, G, Q, C, max(amax, 1), int(lb_rr),
            int(expire_on), int(trace_on), pend_cap, tape_cap, smem, NP]
    ptr_arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    dim_arr = (ctypes.c_longlong * len(dims))(*dims)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(ctypes.cast(ptr_arr, ctypes.c_void_p),
                           ctypes.cast(dim_arr, ctypes.c_void_p), stream)
    if err:
        raise RuntimeError(f"scenario_scan kernel launch failed: CUDA error {err}")
    return out
