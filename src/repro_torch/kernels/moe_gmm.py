"""MoE grouped matmul: the CUDA kernel ``csrc/moe_gmm.cu`` and its plain
PyTorch version, in the reference's kernel layout: x (E, C, D), w (E, D, F),
y (E, C, F) with y[e] = x[e] @ w[e], products summed in fp32, y in x's dtype.
An optional ``rows`` (E,) int32 says how many leading rows of each x[e]
hold tokens; y's rows past it are zeros, and the kernel reads no weight of
an expert with none.

Counterpart of ``repro.kernels.moe_gmm`` (``moe_gmm_ecf``).
``repro_torch.kernels.ops.moe_gmm`` picks between the two by the device of
its inputs and counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.grid import arrival_counters, sm_count

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMALL_C = 8               # bf16 capacities the persistent kernel takes (csrc P_CMAX)
ITEM_F = 256              # its columns per item (csrc P_BN)
BLOCKS_PER_SM = 1         # its grid: blocks per SM (csrc: 134 KB of shared memory each)

_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load("moe_gmm").moe_gmm_fwd
        fn.argtypes = (
            [ctypes.c_int]
            + [ctypes.c_void_p] * 6
            + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 4
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def plain(x: torch.Tensor, w: torch.Tensor,
          rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: ``ref.moe_gmm_ref``."""
    return ref.moe_gmm_ref(x, w, rows)


def launch(x: torch.Tensor, w: torch.Tensor,
           rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the grouped matmul on the current stream; returns (E, C, F) in
    x's dtype.  x and w may have any expert and row strides; their last axis
    must have unit stride.  ``rows``, if given, is an (E,) int32 tensor on
    x's device; it is read on the device only.  Raises on inputs the kernel
    does not take and on a refused launch."""
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"need x (E, C, D) and w (E, D, F), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    E, C, D = x.shape
    if w.shape[0] != E or w.shape[1] != D:
        raise ValueError(f"w {tuple(w.shape)} does not match x {tuple(x.shape)}")
    F = w.shape[2]
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x/w dtypes {x.dtype}/{w.dtype}; need one of "
                        f"{list(DTYPES)} for both")
    if (D > 1 and x.stride(2) != 1) or (F > 1 and w.stride(2) != 1):
        raise ValueError("the last axis of x and w must have unit stride")
    if rows is not None and (rows.shape != (E,) or rows.dtype != torch.int32
                             or rows.stride(0) != 1):
        raise ValueError(f"rows must be a dense (E,) int32 tensor, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    for t in (x, w) if rows is None else (x, w, rows):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError("x, w and rows must lie on one CUDA device")
    if E > 65535:
        raise ValueError(f"{E} experts exceed the grid's 65535")
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    blocks, part, tickets = 0, None, None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if C <= SMALL_C and x.dtype == torch.bfloat16:
            n_ft = -(-F // ITEM_F)          # blocks per group: one per F tile
            blocks = n_ft * max(1, BLOCKS_PER_SM * sm_count(x.device.index or 0)
                                // n_ft)
            part = torch.empty(blocks * 2 * SMALL_C * ITEM_F,
                               dtype=torch.float32, device=x.device)
            tickets = arrival_counters("moe_gmm", x.device, stream, E * n_ft)
        err = _kernel_fn()(
            DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), out.data_ptr(),
            None if rows is None else rows.data_ptr(),
            None if part is None else part.data_ptr(),
            None if tickets is None else tickets.data_ptr(),
            blocks, E, C, D, F, x.stride(0), x.stride(1), w.stride(0),
            w.stride(1), stream,
        )
    if err:
        raise RuntimeError(f"moe_gmm kernel launch failed: CUDA error {err}")
    return out
