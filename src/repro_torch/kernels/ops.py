"""Kernel wrappers: attention in the model layout, the selective scan in the
reference's (B, Q, C, N) layout, the MoE grouped matmul in its (E, C, D)
layout and the expert FFN built on it (counterpart of
``repro.kernels.ops``), and the scenario engine's data plane over a shape
group's lanes.

Each wrapper decides by the device of the tensors it is given, in plain
Python, before anything runs: a CPU tensor goes to the kernel's plain PyTorch
version; a CUDA tensor launches the hand-written CUDA kernel, which raises on
what it does not take.  Nothing falls back from the kernel to the plain
version.  Each wrapper counts its kernel launches in ``<wrapper>.launches``,
so a run can show that its main path went through the kernels.

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

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import scenario_scan as _scn
from repro_torch.kernels import selective_scan as _ss
from repro_torch.models.layers import activation


def _on_cpu(*tensors: torch.Tensor) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"inputs on devices {sorted(kinds)}; need all CPU or all CUDA")


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
    if _on_cpu(q, k, v):
        return _fa.plain(q, k, v, causal=causal, window=window,
                         prefix_len=prefix_len)
    out = _fa.launch(q, k, v, causal=causal, window=window,
                     prefix_len=prefix_len)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_decode(
    q: torch.Tensor,              # (B, 1, H, D) model layout
    k_cache: torch.Tensor,        # (B, S, Kv, D)
    v_cache: torch.Tensor,
    *,
    kv_valid: torch.Tensor,       # (B, S)
) -> torch.Tensor:
    _refuse_grad("flash_decode", q, k_cache, v_cache)
    if _on_cpu(q, k_cache, v_cache, kv_valid):
        return _fd.plain(q, k_cache, v_cache, kv_valid)
    out = _fd.launch(q, k_cache, v_cache, kv_valid)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


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
    if _on_cpu(a, b, h0):
        return _ss.plain(a, b, h0)
    out = _ss.launch(a, b, h0)
    selective_scan.launches += 1
    return out


selective_scan.launches = 0


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
    if _on_cpu(*(t for t in (x, w, rows) if t is not None)):
        return _gmm.plain(x, w, rows)
    out = _gmm.launch(x, w, rows)
    moe_gmm.launches += 1
    return out


moe_gmm.launches = 0


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
    if _on_cpu(*args):
        return _scn.plain(*args, **kw)
    out = _scn.launch(*args, **kw)
    scenario_scan.launches += 1
    return out


scenario_scan.launches = 0


KERNEL_WRAPPERS = (flash_attention, flash_decode, selective_scan, moe_gmm,
                   scenario_scan)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
