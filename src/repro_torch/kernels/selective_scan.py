"""Selective scan: the CUDA kernel ``csrc/selective_scan.cu`` (one thread
per (b, c, n) element walking the chunk) and its plain PyTorch version, in
the reference's kernel layout: a, b (B, Q, C, N), h0 (B, C, N), out
(B, Q, C, N) fp32.

Counterpart of ``repro.kernels.selective_scan`` (``selective_scan_bqcn``).
``repro_torch.kernels.ops.selective_scan`` picks between the two by the
device of its inputs and counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load("selective_scan").selective_scan_fwd
        fn.argtypes = (
            [ctypes.c_int]
            + [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 2
            + [ctypes.c_longlong] * 6
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def plain(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """The plain version: ``ref.selective_scan_ref``."""
    return ref.selective_scan_ref(a, b, h0)


def _plane_is_dense(t: torch.Tensor) -> bool:
    """The trailing (C, N) plane has unit stride (size-1 axes are free)."""
    C, N = t.shape[-2], t.shape[-1]
    return (N == 1 or t.stride(-1) == 1) and (C == 1 or t.stride(-2) == N)


def launch(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """Launch the scan on the current stream; returns every h_t as
    (B, Q, C, N) fp32.  a and b may be views with any B and Q strides (a
    chunk of a longer sequence); their (C, N) plane must be dense.  Raises
    on inputs the kernel does not take and on a refused launch."""
    if a.dim() != 4:
        raise ValueError(f"a must be (B, Q, C, N), got {tuple(a.shape)}")
    B, Q, C, N = a.shape
    if b.shape != a.shape:
        raise ValueError(f"b {tuple(b.shape)} differs from a {tuple(a.shape)}")
    if h0.shape != (B, C, N):
        raise ValueError(f"h0 must be (B, C, N) = {(B, C, N)}, got {tuple(h0.shape)}")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError(f"a/b dtypes {a.dtype}/{b.dtype}; need one of "
                        f"{list(DTYPES)} for both")
    if not (_plane_is_dense(a) and _plane_is_dense(b)):
        raise ValueError("the (C, N) plane of a and b must have unit stride")
    for t in (a, b, h0):
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError("a, b and h0 must lie on one CUDA device")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the grid's 65535")
    h0 = h0.float()
    if not _plane_is_dense(h0):
        h0 = h0.contiguous()
    out = torch.empty((B, Q, C, N), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(
            DTYPES[a.dtype], a.data_ptr(), b.data_ptr(), h0.data_ptr(),
            out.data_ptr(), B, Q, C * N,
            a.stride(0), a.stride(1), b.stride(0), b.stride(1), h0.stride(0),
            stream,
        )
    if err:
        raise RuntimeError(f"selective_scan kernel launch failed: CUDA error {err}")
    return out
