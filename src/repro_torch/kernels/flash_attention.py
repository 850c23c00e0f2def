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

MAX_HEAD_DIM = 256        # one warpgroup's O accumulator in registers
HEAD_DIM_STEP = 8         # a bf16 row of whole 16-byte chunks (cp.async, TMA)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BQ = BK = 64              # query rows and keys per tile (csrc BQ, BK)
STAGES = 3                # bf16 up to D = 128: the K/V ring (csrc STAGES)
WS_STAGES = 3             # bf16 past D = 128: the K/V ring (csrc WS_STAGES)

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
            + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def supports(D: int) -> bool:
    """The head widths both attention kernels take: a multiple of
    ``HEAD_DIM_STEP`` from 8 to ``MAX_HEAD_DIM``, in fp32 and bf16."""
    return D % HEAD_DIM_STEP == 0 and HEAD_DIM_STEP <= D <= MAX_HEAD_DIM


def check_head_dim(D: int) -> None:
    """Raise ``ValueError`` naming the rule where ``supports(D)`` is false."""
    if not supports(D):
        raise ValueError(f"head_dim {D}: the kernels take a multiple of "
                         f"{HEAD_DIM_STEP} from {HEAD_DIM_STEP} to {MAX_HEAD_DIM}")


def smem_bytes(dtype: torch.dtype, D: int) -> int:
    """The kernel's dynamic shared memory at head width D.  fp32: the Q, K,
    V and P tiles, rows padded by one float.  bf16 up to 128: the Q tile
    and ``STAGES`` K and V tiles at the tile width (64 or 128).  bf16 past
    128 (the warp-specialised kernel, tile width 192 or 256): the Q tile
    and ``WS_STAGES`` K and V tiles, then the full, empty and Q mbarriers
    (8 bytes each).  The launch passes it; the kernel refuses a number
    that is not its own."""
    if dtype == torch.float32:
        return 4 * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1))
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


def _rows_16_byte_aligned(t: torch.Tensor) -> bool:
    """The base pointer and the stride of every axis of length > 1 but the
    last (unit) one are multiples of 16 bytes."""
    width = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        t.stride(i) * width % 16 == 0 for i in range(t.dim() - 1) if t.shape[i] > 1)


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
        if t.stride(3) != 1:
            raise ValueError("the D axis of q, k, v must have stride 1")
        if q.dtype == torch.bfloat16 and not _rows_16_byte_aligned(t):
            raise ValueError("bf16 q, k, v need 16-byte-aligned rows: the "
                             "kernel copies them in 16-byte pieces")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if B == 0 or Sq == 0:
        return out
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
            smem_bytes(q.dtype, D),
        )
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    return out
