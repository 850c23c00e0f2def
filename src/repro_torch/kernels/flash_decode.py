"""Decode attention: the CUDA kernel ``csrc/flash_decode.cu`` (one launch
that reads only the 64-slot tiles holding a valid slot, split over blocks
and merged by log-sum-exp by the last block of each kv head) and its plain
PyTorch version, both in the model layout: q (B, 1, H, D), cache
(B, S, Kv, D), valid (B, S).

Counterpart of ``repro.kernels.flash_decode`` (``flash_decode_bhd``).
``repro_torch.kernels.ops.flash_decode`` picks between the two by the device
of its inputs and counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import math
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import check_head_dim, row_alignment
from repro_torch.kernels.grid import arrival_counters, sm_count

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64                 # cache slots per tile (csrc TILE); a split takes whole tiles
BLOCKS_PER_SM = 2         # grid size the split count aims for
STAGES = 2                # the K/V ring's stages (csrc STAGES)
# bf16 widths whose kernels keep their own code at up to 8 query heads a kv
# head and rows of whole aligned 16-byte chunks (csrc flash_decode_fwd);
# every other shape up to 256 runs its width class
SERVED_WIDTHS = (64, 112, 120, 128, 256)
SLICE = 256               # past 256: output columns a block owns (csrc DC)

_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load("flash_decode").flash_decode_fwd
        fn.argtypes = (
            [ctypes.c_int] * 2
            + [ctypes.c_void_p] * 7
            + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 11
            + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
            + [ctypes.c_int] * 5
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def loose(dtype: torch.dtype, D: int, align: int = 16) -> bool:
    """Whether the kernel copies at any alignment (csrc mode ANY; SLICED
    past 256 does too): rows not whole aligned 16-byte chunks
    (``row_alignment`` below 16), and fp32 rows below 8 elements."""
    return align < 16 or (dtype == torch.float32 and D < 8)


def slices(D: int) -> int:
    """Blocks that share a row's output columns: ceil(D / 256) past 256,
    else 1."""
    return -(-D // SLICE) if D > SLICE else 1


def group_tile(dtype: torch.dtype, D: int, G: int, align: int = 16) -> int:
    """Query heads of one kv head that a block holds (csrc group_tile): 16
    on the bf16 kernels that put the heads on the 16 rows of their products
    (the width classes up to 192), else 8 (the served widths' own kernels
    at G <= 8 on whole aligned chunks, the D > 192 form with the heads on 8
    columns, the slices past 256, fp32).  A kv head's G heads take
    ceil(G / group_tile) blocks, each reading the kv head's K and V tiles."""
    served = D in SERVED_WIDTHS and G <= 8 and not loose(dtype, D, align)
    if dtype == torch.bfloat16 and D <= 192 and not served:
        return 16
    return 8


def smem_bytes(dtype: torch.dtype, D: int, S: int, group: int = 8,
               splits: int = 1, align: int = 16) -> int:
    """The kernel's dynamic shared memory for a cache of S slots: the K/V
    ring (two stages of a K and a V tile, one for fp32 rows wider than 128;
    bf16 rows padded to whole 64-element swizzle groups, fp32 rows copied
    at a loose alignment to whole 4-float chunks; past 256 one K chunk
    and one V slice of 256 columns), at least the last block's per-split
    weights and sums (2 x ``group`` x ``splits`` floats), then a bit per
    tile and the list of tiles.  The launch passes it; the kernel refuses
    a number that is not its own."""
    itemsize = 2 if dtype == torch.bfloat16 else 4
    if D > SLICE:
        pitch, stages = SLICE, 1
    else:
        pitch = (-(-D // 64) * 64 if dtype == torch.bfloat16
                 else -(-D // 4) * 4 if loose(dtype, D, align) else D)
        stages = 1 if dtype == torch.float32 and D > 128 else STAGES
    ring = max(stages * 2 * TILE * pitch * itemsize, 8 * group * splits)
    n_tiles = -(-S // TILE)
    return ring + 4 * (-(-n_tiles // 32) + n_tiles)


def num_splits(B: int, Kv: int, S: int, sms: int) -> int:
    """Splits of each (batch, kv head) so that B * Kv * splits blocks fill
    the SMs about ``BLOCKS_PER_SM`` times over, and no more splits than S
    has tiles (``Kv``: the kv heads times their group tiles and slices).  Chosen from
    shapes alone: the kernel divides the tiles that hold a valid slot among
    the splits on the card, so the mask is never read back to the host."""
    want = -(-BLOCKS_PER_SM * sms // max(B * Kv, 1))
    return max(1, min(want, -(-S // TILE)))


def plain(
    q: torch.Tensor,              # (B, 1, H, D)
    k_cache: torch.Tensor,        # (B, S, Kv, D)
    v_cache: torch.Tensor,
    kv_valid: torch.Tensor,       # (B, S)
    return_lse: bool = False,
):
    """The plain version in the model layout: ``ref.flash_decode_ref`` on
    transposed views.  With ``return_lse``: (the output in fp32, each
    row's log-sum-exp (B, H) fp32), the partial of one slot shard."""
    out = ref.flash_decode_ref(
        q[:, 0], k_cache.transpose(1, 2), v_cache.transpose(1, 2), kv_valid,
        return_lse=return_lse,
    )
    if return_lse:
        return out[0][:, None], out[1]
    return out[:, None]


def merge_decode_partials(outs, lses, dtype: torch.dtype = torch.float32):
    """One output from the partials of disjoint slot shards of one cache:
    ``outs`` (B, 1, H, D) fp32 and ``lses`` (B, H), each from ``plain`` or
    ``launch`` with ``return_lse``.  The weights are exp(lse - max lse),
    the sums run in the shards' order, and the result is cast to
    ``dtype`` once.  A shard with no valid slot has lse = -1e30 (its
    scores' finite mask value), so it weighs exactly 0 beside a shard that
    has one.  Where no shard has a valid slot, every lse is -1e30 and the
    row is the mean of the shards' means, each the mean of V over its
    slots: over shards of equal size, the mean over all slots, which is
    what the whole cache gives (the reference's ``decode_attention``)."""
    m = lses[0]
    for lse in lses[1:]:
        m = torch.maximum(m, lse)
    num = den = None
    for o, lse in zip(outs, lses):
        w = torch.exp(lse - m)
        term = o.float() * w[:, None, :, None]
        num = term if num is None else num + term
        den = w if den is None else den + w
    return (num / den[:, None, :, None]).to(dtype)


def launch(
    q: torch.Tensor,              # (B, 1, H, D) on CUDA
    k_cache: torch.Tensor,        # (B, S, Kv, D)
    v_cache: torch.Tensor,
    kv_valid: torch.Tensor,       # (B, S) bool / int8 / uint8
    return_lse: bool = False,
):
    """Launch the kernel on the current stream; returns (B, 1, H, D) in
    q's dtype, or with ``return_lse`` (the output in fp32, each row's
    log-sum-exp (B, H) fp32).  Any head width and any layout whose last
    axes have unit stride: the kernel reads the cache where it lies, at
    its alignment (``row_alignment``).  Raises on inputs the kernel does
    not take and on a refused launch."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, D), got {tuple(q.shape)}")
    B, _, H, D = q.shape
    if k_cache.dim() != 4 or k_cache.shape[0] != B or k_cache.shape[3] != D:
        raise ValueError(f"cache must be (B, S, Kv, D), got {tuple(k_cache.shape)}")
    S, Kv = k_cache.shape[1], k_cache.shape[2]
    if v_cache.shape != k_cache.shape:
        raise ValueError("k_cache and v_cache differ in shape")
    if Kv == 0 or H % Kv:
        raise ValueError(f"need heads % kv heads == 0; got H={H}, Kv={Kv}")
    check_head_dim(D)
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
    if S == 0:
        raise ValueError("the cache has no slots")
    out = torch.empty((B, 1, H, D),
                      dtype=torch.float32 if return_lse else q.dtype,
                      device=q.device)
    lse = (torch.empty((B, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if B == 0:
        return (out, lse) if return_lse else out
    align = row_alignment(q[:, 0], k_cache, v_cache)
    group = group_tile(q.dtype, D, H // Kv, align)
    # (kv head, group tile, slice) triples
    blocks = Kv * -(-(H // Kv) // group) * slices(D)
    splits = num_splits(B, blocks, S, sm_count(q.device.index or 0))
    # partial rows of D floats (4-float multiples but on whole aligned
    # chunks), then each slice's m and l
    pitch = D if not loose(q.dtype, D, align) and D <= SLICE else -(-D // 4) * 4
    part = torch.empty(B * H * splits * (pitch + 2 * slices(D)),
                       dtype=torch.float32, device=q.device)
    vec_mask = int(kv_valid.data_ptr() % 16 == 0
                   and (B == 1 or kv_valid.stride(0) % 16 == 0))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(
            DTYPES[q.dtype], D,
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            kv_valid.data_ptr(), out.data_ptr(), part.data_ptr(),
            arrival_counters("flash_decode", q.device, stream,
                             B * blocks).data_ptr(),
            B, H, Kv, S, splits, vec_mask,
            q.stride(0), q.stride(2),
            k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
            v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
            kv_valid.stride(0), out.stride(0), out.stride(2),
            1.0 / math.sqrt(D), stream,
            lse.data_ptr() if return_lse else None, int(return_lse),
            TILE, smem_bytes(q.dtype, D, S, group, splits, align), group, align,
        )
    if err:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error {err}")
    return (out, lse) if return_lse else out
