"""Kernel wrappers: attention in the model layout, the selective scan in the
reference's (B, Q, C, N) layout, the MoE grouped matmul in its (E, C, D)
layout and the expert FFN built on it (counterpart of
``repro.kernels.ops``), and the scenario engine's data plane over a shape
group's lanes.

Each wrapper decides by the device of the tensors it is given, in plain
Python, before anything runs: a CPU tensor goes to the kernel's plain PyTorch
version; a CUDA tensor launches the hand-written CUDA kernel, which raises on
what it does not take; a ``meta`` tensor (the dry run,
``repro_torch.launch.dryrun``) gets an empty output of the kernel's shape
and dtype, and the call's operations and bytes (``kernels.cost``, the
formulas of ``chip_smoke.py``'s bound column) go to the active counter.
Nothing falls back from the kernel to the plain version.  Each wrapper
counts its kernel launches in ``<wrapper>.launches``, so a run can show that
its main path went through the kernels, and its meta calls apart, in
``<wrapper>.meta_calls``.  On a mesh (DTensors with meta shards, the dry
run's) a model wrapper takes its meta route on one device's shards
(``on_mesh``): the kernel computes rows, heads, channels or experts apart,
so those stay sharded and anything else is gathered first.

The kernels have no backward, and a launch writes its output through
ctypes, outside autograd.  So a model wrapper refuses, on any device, an
input that requires grad while grad mode is on: the gradient would stop at
the kernel without a word.  A model trains under ``impl="blockwise"``, the
reference's train path, which reaches no kernel (as the reference's train
path reaches no ``pallas_call``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cost
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import scenario_scan as _scn
from repro_torch.kernels import selective_scan as _ss
from repro_torch.models.layers import activation


def _route(*tensors: torch.Tensor) -> str:
    """"cpu", "cuda" or "meta": the one device all ``tensors`` lie on."""
    kinds = {t.device.type for t in tensors}
    if len(kinds) == 1 and kinds <= {"cpu", "cuda", "meta"}:
        return kinds.pop()
    raise ValueError(f"inputs on devices {sorted(kinds)}; need all CPU, all "
                     "CUDA or all meta")


def _is_dtensor(t) -> bool:
    return type(t).__name__ == "DTensor"


def on_mesh(fn, args, splits, out_split, lead: int = 0, **kw):
    """``fn`` (a wrapper) on one device's shards of the DTensor ``args``,
    the output a DTensor again: the dry run's route on a mesh, where the
    shards are ``meta`` tensors and ``fn`` takes its meta route.

    ``splits[i]`` names the dimensions of ``args[i]`` that the kernel
    computes apart ({"batch": 0, "heads": 2}: rows and heads of
    attention).  On each mesh dimension the lead argument's ``Shard(d)`` is
    kept where d is such a dimension and every argument that has it
    divides it; every argument is sharded alike there, or replicated where
    it lacks the dimension.  Any other placement (a sharded sequence, a
    partial sum) is gathered first, as ``redistribute`` does, and counted
    with the collectives.  The output is sharded as the lead argument's
    kept dimensions (``out_split``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = args[lead].device_mesh
    names = {d: n for n, d in splits[lead].items()}
    outs = out_split if isinstance(out_split, (list, tuple)) else [out_split]
    targets = [[] for _ in args]
    out_pl = [[] for _ in outs]
    for i, p in enumerate(args[lead].placements):
        n = names.get(p.dim) if isinstance(p, Shard) else None
        if n is not None and any(
                n in s and a is not None and a.shape[s[n]] % mesh.size(i)
                for a, s in zip(args, splits)):
            n = None
        for tgt, s in zip(targets, splits):
            tgt.append(Shard(s[n]) if n is not None and n in s else Replicate())
        for pl, o in zip(out_pl, outs):
            pl.append(Shard(o[n]) if n is not None and n in o else Replicate())
    if not isinstance(out_split, (list, tuple)):
        out_pl = out_pl[0]
    def shard(a, tgt):
        if a is None:
            return None
        if not _is_dtensor(a):          # a plain tensor counts as replicated
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        if any(p.is_partial() for p in a.placements):
            # sum the partials first: a reduce-scatter straight to the
            # target has no backward in some DTensor versions
            a = a.redistribute(mesh, [Replicate() if p.is_partial() else p
                                      for p in a.placements])
        return a.redistribute(mesh, tgt).to_local()

    local = [shard(a, tgt) for a, tgt in zip(args, targets)]
    kw = {k: shard(v, [Replicate()] * mesh.ndim) if _is_dtensor(v) else v
          for k, v in kw.items()}
    if any(t is not None and t.device.type != "meta" for t in local):
        raise ValueError("a kernel wrapper takes DTensors only in the dry "
                         "run, whose shards are meta tensors")
    out = fn(*local, **kw)
    if isinstance(out_split, (list, tuple)):      # several outputs
        return tuple(DTensor.from_local(o, mesh, pl, run_check=False)
                     for o, pl in zip(out, out_pl))
    return DTensor.from_local(out, mesh, out_pl, run_check=False)


HEADS = {"batch": 0, "heads": 2}


def attention_on_mesh(fn, tensors, **kw):
    """``fn`` (an attention in the model layout: q, k, v and a (B, S) mask
    after them) on one device's rows and heads of DTensor ``tensors``
    (``on_mesh``): attention is independent across both."""
    splits = [HEADS] * 3 + [{"batch": 0}] * (len(tensors) - 3)
    return on_mesh(fn, list(tensors), splits, HEADS, **kw)


def _refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and the hand-written kernel "
            "has no backward (its output would carry no grad_fn); train "
            "with impl='blockwise', or run under torch.no_grad()")


def flash_attention(
    q: torch.Tensor,              # model layout (B, S, H, D)
    k: torch.Tensor,              # (B, S, Kv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    prefix_len: int = 0,
) -> torch.Tensor:
    _refuse_grad("flash_attention", q, k, v)
    if _is_dtensor(q):
        return attention_on_mesh(flash_attention, (q, k, v), causal=causal,
                                 window=window, prefix_len=prefix_len)
    route = _route(q, k, v)
    if route == "cpu":
        return _fa.plain(q, k, v, causal=causal, window=window,
                         prefix_len=prefix_len)
    if route == "meta":
        B, Sq, H, D = q.shape
        cost.record("flash_attention", cost.flash_attention_work(
            B, H, k.shape[2], Sq, k.shape[1], D, q.element_size(),
            causal=causal, window=window, prefix=prefix_len))
        flash_attention.meta_calls += 1
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
    out = _fa.launch(q, k, v, causal=causal, window=window,
                     prefix_len=prefix_len)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
flash_attention.meta_calls = 0


def flash_decode(
    q: torch.Tensor,              # (B, 1, H, D) model layout
    k_cache: torch.Tensor,        # (B, S, Kv, D)
    v_cache: torch.Tensor,
    *,
    kv_valid: torch.Tensor,       # (B, S)
) -> torch.Tensor:
    _refuse_grad("flash_decode", q, k_cache, v_cache)
    if _is_dtensor(q):
        return attention_on_mesh(
            lambda q, k, v, valid: flash_decode(q, k, v, kv_valid=valid),
            (q, k_cache, v_cache, kv_valid))
    route = _route(q, k_cache, v_cache, kv_valid)
    if route == "cpu":
        return _fd.plain(q, k_cache, v_cache, kv_valid)
    if route == "meta":
        B, _, H, D = q.shape
        cost.record("flash_decode", cost.flash_decode_work(
            B, H, k_cache.shape[2], k_cache.shape[1], D, q.element_size()))
        flash_decode.meta_calls += 1
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
    out = _fd.launch(q, k_cache, v_cache, kv_valid)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
flash_decode.meta_calls = 0


def selective_scan(
    a: torch.Tensor,              # (B, Q, C, N)
    b: torch.Tensor,
    h0: torch.Tensor,             # (B, C, N)
) -> torch.Tensor:
    """Every h_t of h_t = a_t * h_{t-1} + b_t, (B, Q, C, N) fp32.

    The reference halves ``block_c`` until it divides C: that is the TPU
    kernel's (block_c, N) VMEM tiling.  The CUDA kernel gives each (c, n)
    element its own thread and takes any C, so there is no block size."""
    _refuse_grad("selective_scan", a, b, h0)
    if _is_dtensor(a):
        chan = {"batch": 0, "chan": 2}
        return on_mesh(selective_scan, [a, b, h0],
                        [chan, chan, {"batch": 0, "chan": 1}], chan)
    route = _route(a, b, h0)
    if route == "cpu":
        return _ss.plain(a, b, h0)
    if route == "meta":
        B, Q, C, N = a.shape
        cost.record("selective_scan", cost.selective_scan_work(
            B, Q, C, N, a.element_size()))
        selective_scan.meta_calls += 1
        return torch.empty(a.shape, dtype=torch.float32, device="meta")
    out = _ss.launch(a, b, h0)
    selective_scan.launches += 1
    return out


selective_scan.launches = 0
selective_scan.meta_calls = 0


def moe_gmm(
    x: torch.Tensor,              # (E, C, D)
    w: torch.Tensor,              # (E, D, F)
    rows: Optional[torch.Tensor] = None,   # (E,) int32
) -> torch.Tensor:
    """y[e] = x[e] @ w[e], (E, C, F) in x's dtype, products summed in fp32.
    With ``rows`` (int32 on x's device), rows[e] leading rows of x[e] hold
    tokens and y's rows past it are zeros; the result equals the product
    without it wherever x's rows past rows[e] are zero, as the MoE dispatch
    buffer's are, and the kernel skips the weights of empty experts.

    The reference pads C, D and F to its 128/512 blocks: that is the TPU
    kernel's MXU tiling.  The CUDA kernel masks ragged edges itself, so
    nothing is padded or copied."""
    _refuse_grad("moe_gmm", x, w)
    if _is_dtensor(w):
        experts = {"experts": 0}
        return on_mesh(moe_gmm, [x, w, rows], [experts] * 3, experts, lead=1)
    route = _route(*(t for t in (x, w, rows) if t is not None))
    if route == "cpu":
        return _gmm.plain(x, w, rows)
    if route == "meta":
        E, C, D = x.shape
        cost.record("moe_gmm", cost.moe_gmm_work(E, C, D, w.shape[2],
                                                 x.element_size()))
        moe_gmm.meta_calls += 1
        return torch.empty((E, C, w.shape[2]), dtype=x.dtype, device="meta")
    out = _gmm.launch(x, w, rows)
    moe_gmm.launches += 1
    return out


moe_gmm.launches = 0
moe_gmm.meta_calls = 0


def moe_ffn(
    xe: torch.Tensor,             # (E, C, D)
    wi: torch.Tensor,             # (E, D, F)
    wg: Optional[torch.Tensor],   # (E, D, F) or None
    wo: torch.Tensor,             # (E, F, D)
    *,
    act: str = "silu",
    impl: str = "kernel",
    rows: Optional[torch.Tensor] = None,   # (E,) int32
) -> torch.Tensor:
    """The expert FFN as grouped matmuls: h = x @ wi, h = act(x @ wg) * h
    (or act(h) without a gate), then h @ wo; three products with a gate, two
    without, each given ``rows`` (see ``moe_gmm``).  ``impl="kernel"`` runs
    each through ``moe_gmm``, ``"plain"`` through its plain version on any
    device."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "kernel":
        _refuse_grad("moe_ffn", xe, wi, wg, wo)
    gmm = moe_gmm if impl == "kernel" else _gmm.plain
    a = activation(act)
    h = gmm(xe, wi, rows)
    if wg is not None:
        h = a(gmm(xe, wg, rows)) * h
    else:
        h = a(h)
    return gmm(h, wo, rows)


def scenario_scan(arr, svc, rcode, rtt, ready, kill_slot, kill_g, timeout,
                  ts, gs, wins, *, Q: int, C: int, amax: int, lb_rr: bool,
                  expire_on: bool, trace_on: bool):
    """Every lane of a shape group over the whole sub-step grid (the
    layout and outputs of ``kernels.scenario_scan``); one launch a group."""
    args = (arr, svc, rcode, rtt, ready, kill_slot, kill_g, timeout, ts, gs,
            wins)
    kw = dict(Q=Q, C=C, amax=amax, lb_rr=lb_rr, expire_on=expire_on,
              trace_on=trace_on)
    route = _route(*args)
    if route == "cpu":
        return _scn.plain(*args, **kw)
    if route == "meta":
        (L, N), (R, NREG) = arr.shape, rtt.shape[1:]
        cost.record("scenario_scan", cost.scenario_scan_work(
            L, N, R, NREG, ready.shape[1], kill_slot.shape[1], ts.shape[0],
            trace_on))
        scenario_scan.meta_calls += 1
        return _scn.new_outputs(L, N, R, trace_on, torch.device("meta"))
    out = _scn.launch(*args, **kw)
    scenario_scan.launches += 1
    return out


scenario_scan.launches = 0
scenario_scan.meta_calls = 0


KERNEL_WRAPPERS = (flash_attention, flash_decode, selective_scan, moe_gmm,
                   scenario_scan)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def reset_meta_calls() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.meta_calls = 0
