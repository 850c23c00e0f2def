"""Prefill flash attention: the CUDA kernel ``csrc/flash_attention.cu`` and
its plain PyTorch version, both in the model layout (B, S, heads, D).

Counterpart of ``repro.kernels.flash_attention`` (``flash_attention_bhsd``).
``repro_torch.kernels.ops.flash_attention`` picks between the two by the
device of its inputs and counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BQ = BK = 64              # query rows and keys per tile (csrc BQ, BK)
STAGES = 3                # bf16 up to D = 128: the K/V ring (csrc STAGES)
WS_STAGES = 3             # bf16 past D = 128: the K/V ring (csrc WS_STAGES)
SLICE = 256               # past 256 (and bf16 rows of loose alignment past
                          # 128): output columns a block owns (csrc SL_WIDTH,
                          # F32_WIDTH)
CHUNK = 64                # their Q.K^T chunks (csrc SL_CHUNK, F32_CHUNK)

_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention").flash_attention_fwd
        fn.argtypes = (
            [ctypes.c_int] * 2
            + [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 12
            + [ctypes.c_int] * 3
            + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def supports(D: int) -> bool:
    """The head widths both attention kernels take: every D >= 1, in fp32
    and bf16, as the reference's kernels (their BlockSpecs carry D whole)."""
    return D >= 1


def check_head_dim(D: int) -> None:
    """Raise ``ValueError`` where ``supports(D)`` is false."""
    if not supports(D):
        raise ValueError(f"head_dim {D}: the kernels take any head_dim >= 1")


def row_alignment(*tensors: torch.Tensor) -> int:
    """The largest of 16, 8, 4 and 2 bytes that divides every tensor's base
    address, its row (the last axis, unit stride) in bytes and the stride
    in bytes of each other axis longer than 1: the copies the kernels may
    use (16 and the row a multiple of 16: whole 16-byte chunks, cp.async and
    TMA; 8 or 4: cp.async of that size; 2: bf16 elements)."""
    align = 16
    for t in tensors:
        width = t.element_size()
        for x in (t.data_ptr(), t.shape[-1] * width,
                  *(t.stride(i) * width for i in range(t.dim() - 1) if t.shape[i] > 1)):
            while x % align:
                align //= 2
    return align


def kernel_form(dtype: torch.dtype, D: int, align: int = 16) -> str:
    """The kernel the C entry runs (csrc flash_attention_fwd): fp32 the
    scalar kernel ("f32", any alignment) up to 256 and its slices past it
    ("f32_sliced"); bf16 rows of whole aligned 16-byte chunks up to 256 the
    one-warpgroup kernel ("mma", tile widths 64 and 128) or the
    warp-specialised one ("ws", 192 and 256), other rows up to 128 the
    one-warpgroup kernel copying at any alignment ("mma_any"), and the rest
    (rows past 128 at a loose alignment, every row past 256) the sliced
    kernel ("sliced")."""
    if dtype == torch.float32:
        return "f32" if D <= 256 else "f32_sliced"
    if align >= 16 and D <= 256:
        return "mma" if D <= 128 else "ws"
    return "mma_any" if D <= 128 else "sliced"


def smem_bytes(dtype: torch.dtype, D: int, align: int = 16) -> int:
    """The kernel's dynamic shared memory at head width D (rows aligned to
    ``align`` bytes, ``row_alignment``).  fp32: the Q, K, V and P tiles,
    rows padded by one float; past 256, a 64-column chunk of Q and of K,
    a 256-column slice of V and P.  bf16 up to 128: the Q tile and
    ``STAGES`` K and V tiles at the tile width (64 or 128).  bf16 past 128
    (the warp-specialised kernel, tile width 192 or 256): the Q tile and
    ``WS_STAGES`` K and V tiles, then the full, empty and Q mbarriers (8
    bytes each).  The sliced kernel: two stages of a Q and a K chunk and
    the V slice.  The launch passes it; the kernel refuses a number that
    is not its own."""
    form = kernel_form(dtype, D, align)
    if form == "f32":
        return 4 * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1))
    if form == "f32_sliced":
        return 4 * (BQ * (CHUNK + 1) + BK * (CHUNK + 1) + BK * SLICE + BQ * (BK + 1))
    if form == "sliced":
        return 2 * (2 * 2 * BQ * CHUNK + BK * SLICE)
    width = next(w for w in (64, 128, 192, 256) if D <= w)   # the tile width
    if width > 128:
        return 2 * width * BK * (1 + 2 * WS_STAGES) + 8 * (2 * WS_STAGES + 1)
    return 2 * (BQ * width + 2 * STAGES * BK * width)


def plain(
    q: torch.Tensor,              # (B, Sq, H, D)
    k: torch.Tensor,              # (B, Skv, Kv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    prefix_len: int = 0,
) -> torch.Tensor:
    """The plain version in the model layout: ``ref.flash_attention_ref``
    on transposed views."""
    out = ref.flash_attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, prefix_len=prefix_len,
    )
    return out.transpose(1, 2)


def launch(
    q: torch.Tensor,              # (B, Sq, H, D) on CUDA
    k: torch.Tensor,              # (B, Skv, Kv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    prefix_len: int = 0,
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; returns (B, Sq, H, D).
    Any head width and any layout whose D axis has unit stride: the kernel
    reads the rows where they lie, at their alignment (``row_alignment``).
    Raises on inputs the kernel does not take and on a refused launch."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, heads, D)")
    B, Sq, H, D = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    if k.shape != (B, Skv, Kv, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch q {q.shape} k {k.shape} v {v.shape}")
    if H % Kv:
        raise ValueError(f"heads {H} not divisible by kv heads {Kv}")
    check_head_dim(D)
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}; need one of "
                        f"{list(DTYPES)} for all three")
    for t in (q, k, v):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError("q, k, v must lie on one CUDA device")
        if t.stride(3) != 1 and D > 1:
            raise ValueError("the D axis of q, k, v must have stride 1")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if B == 0 or Sq == 0:
        return out
    align = row_alignment(q, k, v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(
            DTYPES[q.dtype], D,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, Kv, Sq, Skv,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            int(causal), -1 if window is None else int(window),
            int(prefix_len), 1.0 / math.sqrt(D), stream,
            smem_bytes(q.dtype, D, align), align,
        )
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    return out
