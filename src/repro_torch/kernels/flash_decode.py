"""Decode attention: the CUDA kernel ``csrc/flash_decode.cu`` (split-KV with
a log-sum-exp merge) and its plain PyTorch version, both in the model layout:
q (B, 1, H, D), cache (B, S, Kv, D), valid (B, S).

Counterpart of ``repro.kernels.flash_decode`` (``flash_decode_bhd``).
``repro_torch.kernels.ops.flash_decode`` picks between the two by the device
of its inputs and counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_G = 8                 # query heads per kv head (csrc MAX_G)
MIN_SPLIT = 32            # fewest cache slots a split walks
BLOCKS_PER_SM = 2         # grid size the split count aims for

_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load("flash_decode").flash_decode_fwd
        fn.argtypes = (
            [ctypes.c_int] * 2
            + [ctypes.c_void_p] * 8
            + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 11
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def num_splits(B: int, Kv: int, S: int, sm_count: int) -> int:
    """Splits of S so that B * Kv * splits blocks fill the SMs about
    ``BLOCKS_PER_SM`` times over, each split walking at least ``MIN_SPLIT``
    slots."""
    want = -(-BLOCKS_PER_SM * sm_count // max(B * Kv, 1))
    return max(1, min(want, -(-S // MIN_SPLIT)))


def plain(
    q: torch.Tensor,              # (B, 1, H, D)
    k_cache: torch.Tensor,        # (B, S, Kv, D)
    v_cache: torch.Tensor,
    kv_valid: torch.Tensor,       # (B, S)
) -> torch.Tensor:
    """The plain version in the model layout: ``ref.flash_decode_ref`` on
    transposed views."""
    out = ref.flash_decode_ref(
        q[:, 0], k_cache.transpose(1, 2), v_cache.transpose(1, 2), kv_valid
    )
    return out[:, None]


def launch(
    q: torch.Tensor,              # (B, 1, H, D) on CUDA
    k_cache: torch.Tensor,        # (B, S, Kv, D)
    v_cache: torch.Tensor,
    kv_valid: torch.Tensor,       # (B, S) bool / int8 / uint8
) -> torch.Tensor:
    """Launch the split and merge kernels on the current stream; returns
    (B, 1, H, D).  Raises on inputs the kernel does not take and on a
    refused launch."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, D), got {tuple(q.shape)}")
    B, _, H, D = q.shape
    if k_cache.dim() != 4 or k_cache.shape[0] != B or k_cache.shape[3] != D:
        raise ValueError(f"cache must be (B, S, Kv, D), got {tuple(k_cache.shape)}")
    S, Kv = k_cache.shape[1], k_cache.shape[2]
    if v_cache.shape != k_cache.shape:
        raise ValueError("k_cache and v_cache differ in shape")
    if H % Kv or H // Kv > MAX_G:
        raise ValueError(f"need heads % kv heads == 0 and at most {MAX_G} "
                         f"query heads per kv head; got H={H}, Kv={Kv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k_cache.dtype}/{v_cache.dtype}; "
                        f"need one of {list(DTYPES)} for all three")
    if kv_valid.shape != (B, S) or kv_valid.dtype not in (
        torch.bool, torch.int8, torch.uint8
    ):
        raise ValueError(f"kv_valid must be (B, S) bool/int8, got "
                         f"{tuple(kv_valid.shape)} {kv_valid.dtype}")
    for t in (q, k_cache, v_cache, kv_valid):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError("q, caches and kv_valid must lie on one CUDA device")
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError("the last axis of every input must have stride 1")
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    splits = num_splits(B, Kv, S, _sm_count(q.device.index or 0))
    chunk = -(-S // splits)
    part_ml = torch.empty((2, B * H * splits), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((B * H * splits, D), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(
            DTYPES[q.dtype], D,
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            kv_valid.data_ptr(), out.data_ptr(),
            part_ml[0].data_ptr(), part_ml[1].data_ptr(), part_acc.data_ptr(),
            B, H, Kv, S, splits, chunk,
            q.stride(0), q.stride(2),
            k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
            v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
            kv_valid.stride(0), out.stride(0), out.stride(2),
            1.0 / math.sqrt(D), stream,
        )
    if err:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error {err}")
    return out
