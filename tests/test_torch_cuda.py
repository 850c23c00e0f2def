"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip without a CUDA device of compute capability 9.0
(the kernels are built for ``sm_90a`` and have no CPU mode).  The file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The cases are those of ``tests/test_kernels.py`` (``test_torch_kernels.py``
checks that the copies agree), at its tolerances.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import moe_gmm as tgmm  # noqa: E402
from repro_torch.kernels import selective_scan as tss  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

ATTN_CASES = [
    # (B, H, Kv, Sq, Skv, D, causal, window, prefix)
    (1, 4, 4, 128, 128, 64, True, None, 0),
    (2, 4, 2, 256, 256, 64, True, None, 0),          # GQA
    (1, 8, 1, 128, 128, 128, True, None, 0),         # MQA (paligemma-like)
    (2, 4, 4, 192, 192, 64, True, None, 0),          # non-multiple of block
    (1, 4, 4, 128, 128, 64, False, None, 0),         # bidirectional (enc)
    (1, 4, 4, 256, 256, 64, True, 96, 0),            # sliding window
    (1, 4, 4, 128, 128, 64, True, None, 32),         # prefix-LM
]

DECODE_CASES = [
    (1, 4, 4, 256, 64, 256),     # full cache
    (2, 8, 2, 512, 64, 300),     # GQA + partial validity
    (1, 8, 1, 1024, 128, 700),   # MQA long cache
    (2, 4, 4, 384, 64, 100),     # short occupancy
]

SCAN_CASES = [
    (1, 32, 64, 16),
    (2, 64, 128, 16),
    (2, 17, 256, 8),      # odd chunk length
]

GMM_CASES = [
    (4, 64, 128, 256),
    (8, 96, 200, 64),       # non-aligned dims exercise padding
    (2, 256, 512, 512),
]

# test_torch_kernels.py's cases at the head widths 120 (h2o-danube3-4b:
# H=32, Kv=8; the tensor-core kernel's tile of 128 with one zero chunk in
# Q.K^T) and 256 (paligemma-3b: H=8, Kv=1; the warp-specialised kernel), under
# the causal, sliding-window and prefix-LM masks, and bidirectional
WIDE_ATTN_CASES = [
    (1, 32, 8, 128, 128, 120, True, None, 0),
    (1, 32, 8, 192, 192, 120, True, 48, 0),
    (1, 32, 8, 128, 128, 120, True, None, 40),
    (2, 8, 2, 64, 64, 120, False, None, 0),
    (1, 8, 1, 128, 128, 256, True, None, 0),
    (1, 8, 1, 192, 192, 256, True, 48, 0),
    (1, 8, 1, 160, 160, 256, True, None, 64),
    (2, 8, 2, 64, 64, 256, False, None, 0),
]

# (B, H, Kv, S, D, mask) at the same widths: "prefix", the first 137 and
# 300 slots of rows 0 and 1; "ring", 230 live slots wrapping past the end
WIDE_DECODE_CASES = [
    (2, 32, 8, 256, 120, "prefix"),
    (2, 32, 8, 256, 120, "ring"),
    (2, 8, 1, 256, 256, "prefix"),
    (2, 8, 1, 256, 256, "ring"),
]

# test_torch_kernels.py's cases at the widths and query groups the served
# models do not use (public models' attention: 32, SigLIP's 72, phi-2's 80,
# Phi-3-mini's 96, 160, Nemotron-4-340B's 192 at G = 12, Llama-3.1-405B's
# G = 16, StarCoder's 48, falcon-7b's 71), kernel against plain
ANY_ATTN_CASES = [
    (1, 4, 2, 128, 128, 32, True, None, 0),
    (2, 4, 4, 100, 100, 72, False, None, 0),
    (1, 4, 4, 192, 192, 72, True, 48, 0),
    (1, 4, 4, 128, 128, 80, True, None, 40),
    (1, 4, 4, 128, 128, 96, True, None, 0),
    (1, 4, 2, 192, 192, 160, True, 48, 0),
    (1, 12, 1, 128, 128, 192, True, None, 0),
    (1, 24, 2, 64, 64, 192, False, None, 0),
    (1, 16, 1, 128, 128, 128, True, None, 0),
    (1, 48, 1, 64, 64, 128, True, None, 0),
    (1, 71, 1, 64, 64, 64, True, None, 0),
]

# (B, H, Kv, S, D, mask) at the same widths and groups: "prefix", the first
# 137 and 300 slots of rows 0 and 1; "ring", 230 live slots wrapping past
# the end; "none", no valid slot
ANY_DECODE_CASES = [
    (2, 4, 2, 256, 32, "prefix"),
    (2, 4, 4, 256, 72, "ring"),
    (2, 4, 4, 128, 80, "none"),
    (2, 4, 2, 192, 96, "prefix"),
    (2, 4, 2, 256, 160, "ring"),
    (2, 12, 1, 256, 192, "prefix"),
    (2, 16, 1, 256, 128, "ring"),
    (2, 48, 1, 128, 128, "none"),
    (1, 71, 1, 64, 64, "prefix"),
]

# test_torch_any_width.py's cases: head widths 1 to 576 (off a multiple of
# 8, past 256) under every mask, kernel against plain
ANY_WIDTH_ATTN_CASES = [
    (1, 4, 2, 128, 128, 1, True, None, 0),
    (2, 4, 4, 100, 100, 4, False, None, 0),
    (1, 4, 1, 128, 128, 36, True, 48, 0),
    (1, 4, 4, 96, 96, 100, True, None, 40),
    (1, 8, 1, 80, 80, 130, True, None, 0),
    (2, 2, 2, 64, 64, 250, False, None, 0),
    (1, 4, 2, 128, 128, 264, True, 48, 0),
    (1, 2, 1, 100, 100, 288, True, None, 30),
    (1, 2, 2, 72, 72, 512, True, None, 0),
    (1, 2, 1, 64, 64, 576, False, None, 0),
]
ANY_WIDTH_DECODE_CASES = [
    (2, 4, 2, 128, 1, "prefix"),
    (2, 4, 4, 128, 4, "ring"),
    (2, 8, 1, 128, 36, "none"),
    (2, 4, 4, 128, 100, "prefix"),
    (2, 8, 2, 128, 130, "ring"),
    (2, 2, 1, 128, 250, "none"),
    (2, 12, 1, 128, 264, "prefix"),
    (2, 4, 2, 128, 288, "ring"),
    (2, 2, 2, 96, 512, "none"),
    (2, 4, 1, 128, 576, "prefix"),
]

# qwen3-moe-30b's attention (H=32, Kv=4, D=128) in bf16, in the layout of
# ATTN_CASES: ragged lengths around the tensor-core kernel's 64-row tiles,
# each with the causal, sliding-window and prefix-LM masks
QWEN_ATTN_CASES = [(1, 32, 4, S, S, 128, True, window, prefix)
                   for S in (1, 63, 65, 975)
                   for window, prefix in ((None, 0), (96, 0), (None, 37))]

# (E, C, D, F, layout of x) in bf16 for the tensor-core grouped matmul:
# capacities around its 16-row fragments and 128-row tiles at qwen3's D and
# F, with x the dispatch buffer's first C rows; qwen3's wo product; a ragged
# last D slice; element loads where rows or the base are not 16-byte aligned
QWEN_GMM_CASES = [
    *((16, C, 2048, 768, "dispatch")
      for C in (9, 16, 17, 63, 64, 65, 77, 128, 129, 153)),
    (128, 77, 768, 2048, "contiguous"),
    (8, 40, 200, 768, "dispatch"),
    (8, 40, 203, 768, "contiguous"),
    (8, 40, 2048, 768, "offset"),
]

# zamba2-7b's shared attention (H=Kv=32, D=112), in the layout of
# ATTN_CASES: ragged lengths around the 64-row tiles, causal, and the
# sliding-window and prefix-LM masks
ZAMBA_ATTN_CASES = [
    *((1, 32, 32, S, S, 112, True, None, 0) for S in (1, 63, 65, 975)),
    (1, 32, 32, 512, 512, 112, True, 96, 0),
    (1, 32, 32, 512, 512, 112, True, None, 37),
]

# whisper-medium's attention (H=Kv=16, D=64), in the layout of ATTN_CASES:
# the encoder's bidirectional walk over 1500 frames (a 28-key last tile),
# the cross-attention of Sq decoder tokens against them (Sq under, at and
# past one 64-row tile, and the 224-token prompt cap), the decoder's causal
# prefill at 224
WHISPER_ATTN_CASES = [
    (1, 16, 16, 1500, 1500, 64, False, None, 0),
    *((1, 16, 16, Sq, 1500, 64, False, None, 0) for Sq in (1, 4, 63, 65, 224)),
    (1, 16, 16, 224, 224, 64, True, None, 0),
]

# (B, H, Kv, S, D, mask) for whisper-medium's decode caches: the cross
# cache, 1500 slots all valid (24 tiles, none skipped, the last ragged) or
# 600 valid; the self cache, 448 slots (7 tiles) with the first 5, 212 or
# 257 valid (the served requests' range) or only the last
WHISPER_DECODE_CASES = [
    *((B, 16, 16, 1500, 64, mask) for B in (1, 2) for mask in ("1500", "600")),
    *((1, 16, 16, 448, 64, mask) for mask in ("5", "212", "257", "last")),
]

# (B, H, Kv, S, D, mask) for flash_decode's tile skipping: an all-masked
# row beside a partial one, one valid slot in the last tile, a ring of live
# slots wrapping past the end, S off the 64-slot tiles, qwen3-moe-30b's
# decode shape (H=32, Kv=4, D=128) with 600 valid slots and with none, and
# zamba2-7b's (H=Kv=32, D=112) under the same masks
CARD_DECODE_CASES = [
    (2, 32, 8, 2048, 64, "empty beside 600"),
    (1, 32, 8, 2048, 64, "last"),
    (2, 32, 8, 2048, 64, "ring"),
    (2, 32, 8, 1000, 64, "ring"),
    (1, 32, 4, 2048, 128, "600"),
    (1, 32, 4, 2048, 128, "empty"),
    (1, 32, 32, 2048, 112, "600"),
    (2, 32, 32, 2048, 112, "empty beside 600"),
    (1, 32, 32, 2048, 112, "last"),
    (2, 32, 32, 1000, 112, "ring"),
    # public models' decode shapes (chip_smoke.py PUBLIC_SHAPES): phi-2,
    # Phi-3-mini, SigLIP's width, Nemotron-4-340B, Llama-3.1-405B,
    # StarCoder, falcon-7b; then their groups in several group tiles
    (1, 32, 32, 2048, 80, "600"),
    (1, 32, 32, 2048, 96, "600"),
    (1, 16, 16, 2048, 72, "600"),
    (1, 96, 8, 2048, 192, "600"),
    (1, 128, 8, 2048, 128, "600"),
    (1, 48, 1, 2048, 128, "600"),
    (1, 71, 1, 2048, 64, "600"),
    (2, 71, 1, 2048, 64, "empty beside 600"),
    (2, 96, 8, 1000, 192, "ring"),
    (2, 48, 1, 2048, 128, "last"),
]

# the public models' prefill shapes (chip_smoke.py PUBLIC_SHAPES), in the
# layout of ATTN_CASES: causal at S = 1,024, SigLIP bidirectional at 729
PUBLIC_ATTN_CASES = [
    (1, 32, 32, 1024, 1024, 80, True, None, 0),
    (1, 32, 32, 1024, 1024, 96, True, None, 0),
    (1, 16, 16, 729, 729, 72, False, None, 0),
    (1, 96, 8, 1024, 1024, 192, True, None, 0),
    (1, 128, 8, 1024, 1024, 128, True, None, 0),
    (1, 48, 1, 1024, 1024, 128, True, None, 0),
    (1, 71, 1, 1024, 1024, 64, True, None, 0),
]

# (E, C, D, F, layout of x) for the grouped matmul with rows at qwen3's
# widths: "occupied:N", N of the 128 experts hold tokens (x zero past rows);
# "garbage:N", the same rows with nonzero values past them
CARD_ROWS_GMM_CASES = [
    *((128, C, 2048, 768, f"occupied:{n}") for C in (1, 5, 77) for n in (0, 8, 128)),
    (128, 1, 2048, 768, "garbage:8"),
    (128, 77, 2048, 768, "garbage:8"),
]

# the grouped matmul's own tolerances in the reference (test_kernels.py)
GMM_TOL = {"float32": (torch.float32, 1e-4), "bfloat16": (torch.bfloat16, 5e-2)}

DTYPES = {"float32": (torch.float32, 2e-5), "bfloat16": (torch.bfloat16, 2e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernels have no CPU mode")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda")


def _randn(rng, shape, dtype, device):
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    return x.to(device=device, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_kernel_matches_plain(card, case, dtype):
    B, H, Kv, Sq, Skv, D, causal, window, prefix = case
    tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(ATTN_CASES.index(case))
    q = _randn(rng, (B, Sq, H, D), tdt, card)
    k = _randn(rng, (B, Skv, Kv, D), tdt, card)
    v = _randn(rng, (B, Skv, Kv, D), tdt, card)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want = tfa.plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_decode_kernel_matches_plain(card, case, dtype):
    B, H, Kv, S, D, n_valid = case
    tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(100 + DECODE_CASES.index(case))
    q = _randn(rng, (B, 1, H, D), tdt, card)
    k = _randn(rng, (B, S, Kv, D), tdt, card)
    v = _randn(rng, (B, S, Kv, D), tdt, card)
    valid = (torch.arange(S, device=card) < n_valid)[None].expand(B, S)
    before = ops.flash_decode.launches
    got = ops.flash_decode(q, k, v, kv_valid=valid)
    torch.cuda.synchronize()
    assert ops.flash_decode.launches == before + 1
    want = tfd.plain(q, k, v, valid)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", WIDE_ATTN_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_kernel_at_wide_heads(card, case, dtype):
    B, H, Kv, Sq, Skv, D, causal, window, prefix = case
    tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(950 + WIDE_ATTN_CASES.index(case))
    q = _randn(rng, (B, Sq, H, D), tdt, card)
    k = _randn(rng, (B, Skv, Kv, D), tdt, card)
    v = _randn(rng, (B, Skv, Kv, D), tdt, card)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want = tfa.plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ANY_ATTN_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_kernel_at_any_width_and_group(card, case, dtype):
    B, H, Kv, Sq, Skv, D, causal, window, prefix = case
    tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(990 + ANY_ATTN_CASES.index(case))
    q = _randn(rng, (B, Sq, H, D), tdt, card)
    k = _randn(rng, (B, Skv, Kv, D), tdt, card)
    v = _randn(rng, (B, Skv, Kv, D), tdt, card)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want = tfa.plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ANY_WIDTH_ATTN_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_kernel_at_every_width(card, case, dtype):
    B, H, Kv, Sq, Skv, D, causal, window, prefix = case
    tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(1100 + ANY_WIDTH_ATTN_CASES.index(case))
    q = _randn(rng, (B, Sq, H, D), tdt, card)
    k = _randn(rng, (B, Skv, Kv, D), tdt, card)
    v = _randn(rng, (B, Skv, Kv, D), tdt, card)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want = tfa.plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("H,Kv,D", [(32, 8, 64), (32, 32, 112), (32, 8, 120),
                                    (32, 4, 128), (8, 1, 256), (4, 2, 288)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernels_read_views_of_a_fused_buffer(card, H, Kv, D, dtype):
    """q, k and v sliced out of one projection buffer one element in (rows
    2-byte aligned in bf16, 4-byte in float32), and a cache likewise: the
    kernels read the views where they lie."""
    tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(1200 + D)
    S, dS = 130, 300
    fused = _randn(rng, (1, S, 1 + (H + 2 * Kv) * D), tdt, card)
    q = fused[..., 1:1 + H * D].view(1, S, H, D)
    k = fused[..., 1 + H * D:1 + (H + Kv) * D].view(1, S, Kv, D)
    v = fused[..., 1 + (H + Kv) * D:].view(1, S, Kv, D)
    assert tfa.row_alignment(q, k, v) == torch.finfo(tdt).bits // 8
    torch.testing.assert_close(ops.flash_attention(q, k, v).float(),
                               tfa.plain(q, k, v).float(), atol=tol, rtol=tol)
    cache = _randn(rng, (2, dS, 1 + 2 * Kv * D), tdt, card)
    kd = cache[..., 1:1 + Kv * D].view(2, dS, Kv, D)
    vd = cache[..., 1 + Kv * D:].view(2, dS, Kv, D)
    qd = _randn(rng, (2, 1, 1 + H * D), tdt, card)[..., 1:].view(2, 1, H, D)
    valid = decode_mask(2, dS, "empty beside 77", card)
    torch.testing.assert_close(ops.flash_decode(qd, kd, vd, kv_valid=valid).float(),
                               tfd.plain(qd, kd, vd, valid).float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", PUBLIC_ATTN_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_kernel_at_public_shapes(card, case, dtype):
    B, H, Kv, Sq, Skv, D, causal, window, prefix = case
    tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(1010 + PUBLIC_ATTN_CASES.index(case))
    q = _randn(rng, (B, Sq, H, D), tdt, card)
    k = _randn(rng, (B, Skv, Kv, D), tdt, card)
    v = _randn(rng, (B, Skv, Kv, D), tdt, card)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    got = ops.flash_attention(q, k, v, **kw)
    want = tfa.plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _check_decode(card, case, dtype, seed):
    B, H, Kv, S, D, kind = case
    tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    q = _randn(rng, (B, 1, H, D), tdt, card)
    k = _randn(rng, (B, S, Kv, D), tdt, card)
    v = _randn(rng, (B, S, Kv, D), tdt, card)
    pos = np.arange(S)[None, :].repeat(B, 0)
    valid = (pos < np.array([[137], [300]])[:B] if kind == "prefix"
             else np.zeros((B, S), bool) if kind == "none"
             else (pos - (S - 100)) % S < 230)
    valid = torch.from_numpy(valid.astype(np.int8)).to(card)
    before = ops.flash_decode.launches
    got = ops.flash_decode(q, k, v, kv_valid=valid)
    torch.cuda.synchronize()
    assert ops.flash_decode.launches == before + 1
    want = tfd.plain(q, k, v, valid)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", WIDE_DECODE_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_decode_kernel_at_wide_heads(card, case, dtype):
    _check_decode(card, case, dtype, 970 + WIDE_DECODE_CASES.index(case))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ANY_DECODE_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_decode_kernel_at_any_width_and_group(card, case, dtype):
    _check_decode(card, case, dtype, 1030 + ANY_DECODE_CASES.index(case))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ANY_WIDTH_DECODE_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_decode_kernel_at_every_width(card, case, dtype):
    _check_decode(card, case, dtype, 1150 + ANY_WIDTH_DECODE_CASES.index(case))


def decode_mask(B, S, mask, device, seed=0):
    """The (B, S) int8 mask of a CARD_DECODE_CASES kind: "N", the first N
    slots; "empty", none; "empty beside N", none in row 0 and the first N
    in the others; "last", slot S - 1 alone; "ring", a window of live slots
    wrapping past the end, with holes."""
    pos = np.arange(S)[None, :].repeat(B, 0)
    if mask == "last":
        valid = pos == S - 1
    elif mask == "ring":
        rng = np.random.default_rng(seed)
        valid = ((pos - (S - 300)) % S < 900) & (rng.random((B, S)) < 0.9)
    elif mask == "empty":
        valid = np.zeros((B, S), bool)
    elif mask.startswith("empty beside "):
        valid = pos < int(mask.split()[-1])
        valid[0] = False
    else:
        valid = pos < int(mask)
    return torch.from_numpy(valid.astype(np.int8)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_DECODE_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_decode_kernel_skips_empty_tiles_exactly(card, case, dtype):
    B, H, Kv, S, D, mask = case
    tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(800 + CARD_DECODE_CASES.index(case))
    q = _randn(rng, (B, 1, H, D), tdt, card)
    k = _randn(rng, (B, S, Kv, D), tdt, card)
    v = _randn(rng, (B, S, Kv, D), tdt, card)
    valid = decode_mask(B, S, mask, card)
    for _ in range(2):      # the second launch finds the tickets reset
        got = ops.flash_decode(q, k, v, kv_valid=valid)
        torch.cuda.synchronize()
        want = tfd.plain(q, k, v, valid)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    # the same inputs with the masked slots' K and V set to NaN: a tile
    # without a valid slot is never read (a row with none reads them all)
    kn, vn = k.clone(), v.clone()
    dead = ~valid.bool()
    for b in range(B):
        if valid[b].any():
            kn[b][dead[b]] = float("nan")
            vn[b][dead[b]] = float("nan")
    tiles = dead.reshape(B, -1, tfd.TILE).all(-1) if S % tfd.TILE == 0 else None
    if tiles is not None and tiles.any():
        keep = tiles.repeat_interleave(tfd.TILE, 1)
        kn = torch.where(keep[..., None, None], kn, k)
        vn = torch.where(keep[..., None, None], vn, v)
        got = ops.flash_decode(q, kn, vn, kv_valid=valid)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _rows_x(rng, E, C, D, dtype, device, layout):
    """x (E, C, D) as the dispatch buffer's first C rows and rows (E,)
    int32 for an "occupied:N" or "garbage:N" layout: N experts (drawn from
    the seed) hold 1..C rows, the rest none; x is zero past rows[e], or
    random there for "garbage"."""
    kind, n = layout.split(":")
    occupied = rng.choice(E, size=int(n), replace=False)
    rows = np.zeros(E, np.int32)
    rows[occupied] = rng.integers(1, C + 1, size=int(n))
    if int(n):
        rows[occupied[0]] = C                    # one full expert at least
    x = _randn(rng, (E, C + 1, D), dtype, device)[:, :C]
    rows_t = torch.from_numpy(rows).to(device)
    if kind == "occupied":
        past = torch.arange(C, device=device)[None, :] >= rows_t[:, None]
        x[past] = 0
    return x, rows_t


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_ROWS_GMM_CASES)
@pytest.mark.parametrize("dtype", list(GMM_TOL))
def test_moe_gmm_kernel_with_rows(card, case, dtype):
    """With rows, the kernel equals the plain version with rows; where x is
    zero past rows[e] (the dispatch buffer), that is the product of the
    whole buffer; rows past rows[e] are zeros whatever x holds there."""
    E, C, D, F, layout = case
    tdt, tol = GMM_TOL[dtype]
    rng = np.random.default_rng(900 + CARD_ROWS_GMM_CASES.index(case))
    x, rows = _rows_x(rng, E, C, D, tdt, card, layout)
    # weights at fan-in scale, as the model's are: with unit-normal weights
    # an fp32 sum of 2048 products is O(100), and two correct fp32 orders of
    # it (cuBLAS's in the plain version, the kernel's) differ by ~2e-4
    w = _randn(rng, (E, D, F), tdt, card) / D ** 0.5
    before = ops.moe_gmm.launches
    for _ in range(2):      # the second launch finds the tickets reset
        got = ops.moe_gmm(x, w, rows)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), tgmm.plain(x, w, rows).float(),
                                   atol=tol, rtol=tol)
    assert ops.moe_gmm.launches == before + 2
    past = torch.arange(C, device=card)[None, :] >= rows[:, None]
    assert bool(got[past].eq(0).all())
    if layout.startswith("occupied"):
        torch.testing.assert_close(got.float(), tgmm.plain(x, w).float(),
                                   atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 5, 77])
@pytest.mark.parametrize("dtype", list(GMM_TOL))
def test_moe_gmm_kernel_without_rows_is_rows_all_c(card, C, dtype):
    tdt, _ = GMM_TOL[dtype]
    rng = np.random.default_rng(950 + C)
    x = _randn(rng, (128, C + 1, 2048), tdt, card)[:, :C]
    w = _randn(rng, (128, 2048, 768), tdt, card)
    full = torch.full((128,), C, dtype=torch.int32, device=card)
    got = tgmm.launch(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, tgmm.launch(x, w, full))


@pytest.mark.cuda
@pytest.mark.parametrize("case", QWEN_ATTN_CASES)
def test_flash_attention_bf16_kernel_at_qwen3_shapes(card, case):
    B, H, Kv, Sq, Skv, D, causal, window, prefix = case
    tdt, tol = DTYPES["bfloat16"]
    rng = np.random.default_rng(500 + QWEN_ATTN_CASES.index(case))
    q = _randn(rng, (B, Sq, H, D), tdt, card)
    k = _randn(rng, (B, Skv, Kv, D), tdt, card)
    v = _randn(rng, (B, Skv, Kv, D), tdt, card)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    got = tfa.launch(q, k, v, **kw)
    torch.cuda.synchronize()
    want = tfa.plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ZAMBA_ATTN_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_kernel_at_zamba2_shapes(card, case, dtype):
    """Head width 112: the bf16 kernel's tile of 128 with zero columns, the
    fp32 kernel at 7 columns a thread."""
    B, H, Kv, Sq, Skv, D, causal, window, prefix = case
    tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(900 + ZAMBA_ATTN_CASES.index(case))
    q = _randn(rng, (B, Sq, H, D), tdt, card)
    k = _randn(rng, (B, Skv, Kv, D), tdt, card)
    v = _randn(rng, (B, Skv, Kv, D), tdt, card)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    got = tfa.launch(q, k, v, **kw)
    torch.cuda.synchronize()
    want = tfa.plain(q, k, v, **kw)
    assert got.shape == (B, Sq, H, D)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _scan_inputs(rng, shape, dtype, device):
    a = torch.sigmoid(_randn(rng, shape, torch.float32, device)).to(dtype)
    b = (0.1 * _randn(rng, shape, torch.float32, device)).to(dtype)
    return a, b


@pytest.mark.cuda
@pytest.mark.parametrize("case", WHISPER_ATTN_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_kernel_at_whisper_shapes(card, case, dtype):
    B, H, Kv, Sq, Skv, D, causal, window, prefix = case
    tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(900 + WHISPER_ATTN_CASES.index(case))
    q = _randn(rng, (B, Sq, H, D), tdt, card)
    k = _randn(rng, (B, Skv, Kv, D), tdt, card)
    v = _randn(rng, (B, Skv, Kv, D), tdt, card)
    got = tfa.launch(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = tfa.plain(q, k, v, causal=causal)
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", WHISPER_DECODE_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_decode_kernel_over_whisper_caches(card, case, dtype):
    B, H, Kv, S, D, mask = case
    tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(950 + WHISPER_DECODE_CASES.index(case))
    q = _randn(rng, (B, 1, H, D), tdt, card)
    k = _randn(rng, (B, S, Kv, D), tdt, card)
    v = _randn(rng, (B, S, Kv, D), tdt, card)
    valid = decode_mask(B, S, mask, card).bool()
    for _ in range(2):      # the second launch finds the tickets reset
        got = tfd.launch(q, k, v, valid)
        torch.cuda.synchronize()
        want = tfd.plain(q, k, v, valid)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCAN_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_selective_scan_kernel_matches_plain(card, case, dtype):
    """Tolerance 1e-5, the reference's scan tolerance; bf16 inputs are
    widened to fp32 by both, so the tolerance holds there too."""
    B, Q, C, N = case
    tdt = DTYPES[dtype][0]
    rng = np.random.default_rng(200 + SCAN_CASES.index(case))
    a, b = _scan_inputs(rng, (B, Q, C, N), tdt, card)
    h0 = _randn(rng, (B, C, N), torch.float32, card)
    before = ops.selective_scan.launches
    got = ops.selective_scan(a, b, h0)
    torch.cuda.synchronize()
    assert ops.selective_scan.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (B, Q, C, N)
    torch.testing.assert_close(got, tss.plain(a, b, h0), atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_selective_scan_kernel_on_chunk_views(card):
    """Chunk slices of a (B, S, C, N) tensor launch with no copy, and the
    state carried between them gives the whole sequence's scan."""
    rng = np.random.default_rng(7)
    a, b = _scan_inputs(rng, (2, 50, 96, 16), torch.float32, card)
    h0 = _randn(rng, (2, 96, 16), torch.float32, card)
    whole = tss.plain(a, b, h0)
    h, parts = h0, []
    for c0 in range(0, 50, 16):
        hs = ops.selective_scan(a[:, c0:c0 + 16], b[:, c0:c0 + 16], h)
        parts.append(hs)
        h = hs[:, -1]
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat(parts, dim=1), whole, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", GMM_CASES)
@pytest.mark.parametrize("dtype", list(GMM_TOL))
def test_moe_gmm_kernel_matches_plain(card, case, dtype):
    E, C, D, F = case
    tdt, tol = GMM_TOL[dtype]
    rng = np.random.default_rng(300 + GMM_CASES.index(case))
    x = _randn(rng, (E, C, D), tdt, card)
    w = _randn(rng, (E, D, F), tdt, card)
    before = ops.moe_gmm.launches
    got = ops.moe_gmm(x, w)
    torch.cuda.synchronize()
    assert ops.moe_gmm.launches == before + 1
    assert got.dtype == tdt and got.shape == (E, C, F)
    torch.testing.assert_close(got.float(), tgmm.plain(x, w).float(),
                               atol=tol, rtol=tol)


# (E, C, D, F): decode capacities 1-8 (rows in registers, D split across the
# block), C between the two kernels, ragged F without vector loads
GMM_EDGE_CASES = [(16, 1, 256, 128), (16, 3, 130, 66), (8, 8, 200, 64),
                  (8, 9, 64, 100), (4, 200, 64, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", GMM_EDGE_CASES)
@pytest.mark.parametrize("dtype", list(GMM_TOL))
def test_moe_gmm_kernel_on_strided_capacity_views(card, case, dtype):
    """x as ``moe_apply`` hands it over: the first C rows of an (E, C + 1,
    D) dispatch buffer, a view with a dense last axis."""
    E, C, D, F = case
    tdt, tol = GMM_TOL[dtype]
    rng = np.random.default_rng(400 + GMM_EDGE_CASES.index(case))
    x = _randn(rng, (E, C + 1, D), tdt, card)[:, :C]
    w = _randn(rng, (E, D, F), tdt, card)
    assert not x.is_contiguous()
    got = tgmm.launch(x, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), tgmm.plain(x, w).float(),
                               atol=tol, rtol=tol)


def _gmm_x(rng, E, C, D, dtype, device, layout):
    """x (E, C, D): "contiguous"; "dispatch", the first C rows of an
    (E, C + 1, D) buffer; "offset", a view one element into a flat buffer
    (aligned to the element, not to 16 bytes)."""
    if layout == "contiguous":
        return _randn(rng, (E, C, D), dtype, device)
    if layout == "dispatch":
        return _randn(rng, (E, C + 1, D), dtype, device)[:, :C]
    return _randn(rng, (E * C * D + 1,), dtype, device)[1:].view(E, C, D)


@pytest.mark.cuda
@pytest.mark.parametrize("case", QWEN_GMM_CASES)
def test_moe_gmm_bf16_kernel_on_tensor_core_tiles(card, case):
    E, C, D, F, layout = case
    tdt, tol = GMM_TOL["bfloat16"]
    rng = np.random.default_rng(600 + QWEN_GMM_CASES.index(case))
    x = _gmm_x(rng, E, C, D, tdt, card, layout)
    w = _randn(rng, (E, D, F), tdt, card)
    if layout == "offset":
        assert x.data_ptr() % 16 == 2
    got = tgmm.launch(x, w)
    torch.cuda.synchronize()
    assert got.dtype == tdt and got.shape == (E, C, F)
    torch.testing.assert_close(got.float(), tgmm.plain(x, w).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
def test_moe_ffn_kernel_matches_plain(card):
    """Three launches with a gate, each product held by the plain path."""
    rng = np.random.default_rng(9)
    E, C, D, F = 8, 20, 128, 96
    xe = _randn(rng, (E, C, D), torch.float32, card)
    wi, wg = (_randn(rng, (E, D, F), torch.float32, card) / D ** 0.5
              for _ in range(2))
    wo = _randn(rng, (E, F, D), torch.float32, card) / F ** 0.5
    before = ops.moe_gmm.launches
    got = ops.moe_ffn(xe, wi, wg, wo, act="silu")
    torch.cuda.synchronize()
    assert ops.moe_gmm.launches == before + 3
    want = ops.moe_ffn(xe, wi, wg, wo, act="silu", impl="plain")
    assert ops.moe_gmm.launches == before + 3
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


# (B, H, Kv, S, D, mask) for flash_decode's log-sum-exp: a row with no
# valid slot beside a partial one, one valid slot, llama3.2-1b's decode
# shape, no valid slot at all, a ring at qwen3-moe-30b's heads and
# zamba2-7b's head width
LSE_CASES = [
    (2, 32, 8, 2048, 64, "empty beside 600"),
    (1, 32, 8, 2048, 64, "last"),
    (1, 32, 8, 2048, 64, "600"),
    (1, 32, 8, 2048, 64, "empty"),
    (2, 32, 4, 1000, 128, "ring"),
    (1, 32, 32, 2048, 112, "empty beside 600"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", LSE_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_decode_kernel_lse_matches_plain(card, case, dtype):
    """With ``return_lse`` the kernel writes its output in fp32 and each
    row's log-sum-exp: the plain version's within 1e-5 relative (float32)
    or 2e-3 absolute (bf16); a row with no valid slot holds -1e30 in both.
    Without it the output is q's dtype, as before."""
    B, H, Kv, S, D, mask = case
    tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(900 + LSE_CASES.index(case))
    q = _randn(rng, (B, 1, H, D), tdt, card)
    k = _randn(rng, (B, S, Kv, D), tdt, card)
    v = _randn(rng, (B, S, Kv, D), tdt, card)
    valid = decode_mask(B, S, mask, card)
    before = ops.flash_decode.launches
    got, lse = ops.flash_decode(q, k, v, kv_valid=valid, return_lse=True)
    torch.cuda.synchronize()
    assert ops.flash_decode.launches == before + 1
    want, want_lse = tfd.plain(q, k, v, valid, return_lse=True)
    assert got.dtype == torch.float32 and lse.shape == (B, H)
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    empty = want_lse == -1e30
    assert torch.equal(lse == -1e30, empty)
    if tdt == torch.float32:
        torch.testing.assert_close(lse[~empty], want_lse[~empty], atol=0,
                                   rtol=1e-5)
    else:
        torch.testing.assert_close(lse[~empty], want_lse[~empty], atol=2e-3,
                                   rtol=0)
    # without it, the same launch but for the epilogue's store: the fp32
    # output cast to q's dtype, to the bit
    plain_out = ops.flash_decode(q, k, v, kv_valid=valid)
    assert plain_out.dtype == tdt and torch.equal(plain_out, got.to(tdt))


SPLIT_S, SPLIT_VIEWS = 32_768, 4


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["600", "32768", "every view"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_decode_slot_split_on_one_card(card, mask, dtype):
    """llama3.2-1b's decode heads over a 32,768-slot cache cut into 4 slot
    views (multiples of 64 slots, 16-byte aligned), the kernel on each with
    its log-sum-exp, merged: one whole-cache launch's output and the plain
    version's, under 600 valid slots (three views empty), all valid and
    valid slots in every view."""
    B, H, Kv, D = 2, 32, 8, 64
    tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(950)
    q = _randn(rng, (B, 1, H, D), tdt, card)
    k = _randn(rng, (B, SPLIT_S, Kv, D), tdt, card)
    v = _randn(rng, (B, SPLIT_S, Kv, D), tdt, card)
    if mask == "every view":
        pos = torch.arange(SPLIT_S, device=card)
        valid = ((pos % (SPLIT_S // SPLIT_VIEWS)) < 3000)[None].expand(B, SPLIT_S)
        valid = valid.to(torch.int8).contiguous()
    else:
        valid = decode_mask(B, SPLIT_S, mask, card)
    n = SPLIT_S // SPLIT_VIEWS
    parts = [tfd.launch(q, k[:, i * n:(i + 1) * n], v[:, i * n:(i + 1) * n],
                        valid[:, i * n:(i + 1) * n], return_lse=True)
             for i in range(SPLIT_VIEWS)]
    got = tfd.merge_decode_partials([o for o, _ in parts],
                                    [lse for _, lse in parts], dtype=tdt)
    whole = tfd.launch(q, k, v, valid)
    want = tfd.plain(q, k, v, valid)
    torch.cuda.synchronize()
    assert got.dtype == tdt
    torch.testing.assert_close(got.float(), whole.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# paligemma-3b's head width 256 in bf16: the warp-specialised prefill
# (B, H, Kv, Sq, Skv, causal, window, prefix): causal at GQA 8:1, the
# 256-patch prefix before 1024 text tokens, a window, Sq != Skv, ragged
# lengths (one 64-row tile, an odd and an even count of tiles), B > 1 and
# GQA 1:1
PALI_ATTN_CASES = [
    (1, 8, 1, 1024, 1024, True, None, 0),
    (1, 8, 1, 1280, 1280, True, None, 256),
    (1, 8, 1, 512, 512, True, 96, 0),
    (1, 8, 1, 100, 700, False, None, 0),
    (1, 8, 1, 975, 975, True, None, 0),
    (1, 8, 1, 1, 1, True, None, 0),
    (1, 8, 1, 130, 130, True, None, 0),
    (2, 8, 1, 333, 333, True, None, 37),
    (2, 4, 4, 200, 200, True, None, 0),
    (2, 4, 4, 192, 192, False, None, 0),
]

# and the unpadded decode, (B, H, Kv, S, mask) (decode_mask): B > 1, a row
# with no valid slot beside a partial one, a ring, every slot valid, one
# slot, S off the 64-slot tile, and 1:1 and 4:1 heads
PALI_DECODE_CASES = [
    (2, 8, 1, 2048, "600"),
    (2, 8, 1, 2048, "empty beside 600"),
    (2, 8, 1, 1000, "ring"),
    (1, 8, 1, 2048, "2048"),
    (1, 8, 1, 2048, "last"),
    (2, 8, 1, 1001, "700"),
    (2, 8, 8, 512, "300"),
    (1, 8, 2, 2048, "empty"),
]
PALI_D = 256
# the log-sum-exp's measured worst relative error of the fp32 kernel
# across the head widths before the redesign (the one-slot row)
LSE_RTOL_F32 = 5.4e-7


@pytest.mark.cuda
@pytest.mark.parametrize("case", PALI_ATTN_CASES)
def test_flash_attention_kernel_at_head_width_256(card, case):
    B, H, Kv, Sq, Skv, causal, window, prefix = case
    tdt, tol = DTYPES["bfloat16"]
    rng = np.random.default_rng(1100 + PALI_ATTN_CASES.index(case))
    q = _randn(rng, (B, Sq, H, PALI_D), tdt, card)
    k = _randn(rng, (B, Skv, Kv, PALI_D), tdt, card)
    v = _randn(rng, (B, Skv, Kv, PALI_D), tdt, card)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want = tfa.plain(q, k, v, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", PALI_DECODE_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_decode_kernel_at_head_width_256(card, case, dtype):
    """The output against the plain version, then with ``return_lse`` the
    fp32 output and each row's log-sum-exp: within ``LSE_RTOL_F32`` of
    max(|lse|, 1) (float32) or 2e-3 absolute (bf16), -1e30 in a row with
    no valid slot."""
    B, H, Kv, S, mask = case
    tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(1200 + PALI_DECODE_CASES.index(case))
    q = _randn(rng, (B, 1, H, PALI_D), tdt, card)
    k = _randn(rng, (B, S, Kv, PALI_D), tdt, card)
    v = _randn(rng, (B, S, Kv, PALI_D), tdt, card)
    valid = decode_mask(B, S, mask, card)
    before = ops.flash_decode.launches
    got = ops.flash_decode(q, k, v, kv_valid=valid)
    out, lse = ops.flash_decode(q, k, v, kv_valid=valid, return_lse=True)
    torch.cuda.synchronize()
    assert ops.flash_decode.launches == before + 2
    want, want_lse = tfd.plain(q, k, v, valid, return_lse=True)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(out, want, atol=tol, rtol=tol)
    empty = want_lse == -1e30
    assert torch.equal(lse == -1e30, empty)
    diff = (lse - want_lse).abs()[~empty]
    if tdt == torch.float32:
        # relative to |lse|, absolute below 1 (chip_smoke.py's lse_error):
        # a one-slot row's lse is that slot's score, which may be near 0
        rel = diff / want_lse.abs()[~empty].clamp(min=1.0)
        assert rel.numel() == 0 or rel.max().item() <= LSE_RTOL_F32
    else:
        assert diff.numel() == 0 or diff.max().item() <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["600", "32768", "every view"])
def test_flash_decode_slot_split_at_head_width_256(card, mask):
    """paligemma-3b's decode heads (H=8, Kv=1, D=256, bf16) over a
    32,768-slot cache cut into 4 slot views, the kernel on each with its
    log-sum-exp, merged as ``slot_parallel_decode`` merges the shards of
    its mesh: one whole-cache launch's output and the plain version's."""
    B, H, Kv = 2, 8, 1
    tdt, tol = DTYPES["bfloat16"]
    rng = np.random.default_rng(1300)
    q = _randn(rng, (B, 1, H, PALI_D), tdt, card)
    k = _randn(rng, (B, SPLIT_S, Kv, PALI_D), tdt, card)
    v = _randn(rng, (B, SPLIT_S, Kv, PALI_D), tdt, card)
    if mask == "every view":
        pos = torch.arange(SPLIT_S, device=card)
        valid = ((pos % (SPLIT_S // SPLIT_VIEWS)) < 3000)[None].expand(B, SPLIT_S)
        valid = valid.to(torch.int8).contiguous()
    else:
        valid = decode_mask(B, SPLIT_S, mask, card)
    n = SPLIT_S // SPLIT_VIEWS
    parts = [tfd.launch(q, k[:, i * n:(i + 1) * n], v[:, i * n:(i + 1) * n],
                        valid[:, i * n:(i + 1) * n], return_lse=True)
             for i in range(SPLIT_VIEWS)]
    got = tfd.merge_decode_partials([o for o, _ in parts],
                                    [lse for _, lse in parts], dtype=tdt)
    whole = tfd.launch(q, k, v, valid)
    want = tfd.plain(q, k, v, valid)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), whole.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(card):
    q = torch.zeros((1, 8, 4, 64), device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        tfa.launch(q, q, q)
    # a bf16 base one element off is taken (its rows copied at 2-byte
    # alignment) and agrees with the plain version; a width below 1 is not
    q = torch.randn((1 * 8 * 4 * 64 + 1,), device=card).to(
        torch.bfloat16)[1:].view(1, 8, 4, 64)
    torch.testing.assert_close(tfa.launch(q, q, q).float(),
                               tfa.plain(q, q, q).float(), atol=2e-2, rtol=2e-2)
    with pytest.raises(ValueError, match="head_dim 0"):
        tfa.launch(q[..., :0], q[..., :0], q[..., :0])
    q = torch.zeros((1, 8, 4, 64), device=card)
    with pytest.raises(ValueError, match="kv_valid"):
        tfd.launch(q[:, :1], q, q, torch.ones((1, 8), device=card))
    with pytest.raises(ValueError, match="unit stride"):
        tss.launch(q.transpose(2, 3), q.transpose(2, 3), q[:, 0].transpose(1, 2))
    x = torch.zeros((4, 3, 8), device=card)
    with pytest.raises(TypeError):
        tgmm.launch(x, torch.zeros((4, 8, 5), device=card, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="unit stride"):
        tgmm.launch(x.transpose(1, 2).contiguous().transpose(1, 2),
                    torch.zeros((4, 8, 5), device=card))


# ---------------------------------------------------------------------------
# the serve step captured as a CUDA graph (repro_torch.launch.steps)
# ---------------------------------------------------------------------------

# one model of each family the port serves, plus the sliding-window ring
CAPTURE_ARCHS = ["llama3.2-1b", "qwen3-moe-30b", "falcon-mamba-7b",
                 "h2o-danube3-4b"]


def _card_model(arch, card):
    """``arch`` at d_model 256 (head_dim 64), bf16, random weights from
    seed 0."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    gen = torch.Generator(device=card).manual_seed(0)
    return build_model(get_config(arch).scaled(d_model=256), device=card,
                       dtype=torch.bfloat16, generator=gen)


def _prompt(model, n, card, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (1, n))).to(card)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", CAPTURE_ARCHS)
def test_captured_step_replays_the_eager_tokens(card, arch):
    """From one prefill, 32 replays pick the tokens of 32 eager steps (the
    ring of h2o-danube3-4b's 64 slots wraps: 40 + 32 tokens)."""
    from repro_torch.launch.steps import build_serve_step

    model = _card_model(arch, card)
    graph_cache = model.init_cache(1, 128)
    step = build_serve_step(model, graph_cache)
    assert step.graph is not None and int(graph_cache["len"]) == 0
    eager_cache = model.init_cache(1, 128)
    with torch.inference_mode():
        logits, _ = model.prefill(_prompt(model, 40, card), eager_cache)
        for key in ("kv", "ssm_state"):
            for name, t in eager_cache.get(key, {}).items():
                graph_cache[key][name].copy_(t)
        graph_cache["len"].copy_(eager_cache["len"])
        tok = logits.argmax(-1)
        step.tokens.copy_(tok)
        for i in range(32):
            logits, _ = model.decode_step(tok, eager_cache)
            tok = logits.argmax(-1)
            assert torch.equal(step(), tok), f"step {i}"
    assert int(graph_cache["len"]) == int(eager_cache["len"]) == 72


@pytest.mark.cuda
def test_captured_step_at_the_smoke_head_width(card):
    """llama3.2-1b's smoke config as it is (head_dim 32, G = 4: the width
    class of 64 and a group tile of 16 in decode): 16 replays pick the
    tokens of 16 eager steps, every step through both kernels."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models.registry import build_model

    cfg = get_smoke_config("llama3.2-1b")
    assert cfg.resolved_head_dim == 32
    gen = torch.Generator(device=card).manual_seed(0)
    model = build_model(cfg, device=card, dtype=torch.bfloat16, generator=gen)
    graph_cache = model.init_cache(1, 64)
    step = build_serve_step(model, graph_cache)
    assert step.launches["flash_decode"] == cfg.num_layers
    eager_cache = model.init_cache(1, 64)
    ops.reset_launch_counts()
    with torch.inference_mode():
        logits, _ = model.prefill(_prompt(model, 20, card), eager_cache)
        assert ops.flash_attention.launches == cfg.num_layers
        for name, t in eager_cache["kv"].items():
            graph_cache["kv"][name].copy_(t)
        graph_cache["len"].copy_(eager_cache["len"])
        tok = logits.argmax(-1)
        step.tokens.copy_(tok)
        for i in range(16):
            logits, _ = model.decode_step(tok, eager_cache)
            tok = logits.argmax(-1)
            assert torch.equal(step(), tok), f"step {i}"
    torch.cuda.synchronize()
    assert ops.flash_decode.launches == 2 * 16 * cfg.num_layers


@pytest.mark.cuda
def test_replays_count_the_graphs_launches(card):
    from repro_torch.launch.steps import build_serve_step

    model = _card_model("qwen3-moe-30b", card)
    L = model.cfg.num_layers
    cache = model.init_cache(1, 128)
    ops.reset_launch_counts()
    step = build_serve_step(model, cache)
    # the warmup and the capture leave the counters where they were
    assert all(fn.launches == 0 for fn in ops.KERNEL_WRAPPERS)
    assert step.launches == {"flash_attention": 0, "flash_decode": L,
                             "selective_scan": 0, "moe_gmm": 3 * L,
                             "scenario_scan": 0}
    with torch.inference_mode():
        logits, _ = model.prefill(_prompt(model, 20, card), cache)
    step(logits.argmax(-1))
    step()
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == L
    assert ops.flash_decode.launches == 2 * L
    assert ops.moe_gmm.launches == 3 * L + 2 * 3 * L


@pytest.mark.cuda
def test_second_replica_replays_after_the_first_is_dropped(card):
    import gc

    from repro_torch.serving.live import LiveReplica

    model = _card_model("llama3.2-1b", card)
    prompt = _prompt(model, 24, card)[0]
    first = LiveReplica("first", model, max_len=128, slots=2)
    second = LiveReplica("second", model, max_len=128, slots=2)
    first.submit(0, prompt, out_tokens=6)
    want = []
    while not want:
        want = first.step()
    del first
    gc.collect()
    torch.cuda.empty_cache()
    got = []
    second.submit(0, prompt, out_tokens=6)
    while not got:
        got = second.step()
    assert got == want and len(got[0][1]) == 7


# zamba2-7b at 14 layers (2 prelude Mamba-2 layers, 2 super-blocks) and
# d_model 448, so that its attention heads are 112 wide, as at full width
def _hybrid_card_model(card):
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    gen = torch.Generator(device=card).manual_seed(0)
    cfg = get_config("zamba2-7b").scaled(num_layers=14, d_model=448)
    assert cfg.resolved_head_dim == 112 and cfg.hybrid_blocks == 2
    return build_model(cfg, device=card, dtype=torch.bfloat16, generator=gen)


@pytest.mark.cuda
def test_hybrid_captured_step_replays_the_eager_tokens(card):
    """From one prefill, 32 replays of the hybrid's captured step pick the
    tokens of 32 eager steps, and leave every cache group as they do."""
    from repro_torch.launch.steps import build_serve_step

    model = _hybrid_card_model(card)
    graph_cache = model.init_cache(1, 128)
    step = build_serve_step(model, graph_cache)
    assert step.graph is not None and int(graph_cache["len"]) == 0
    eager_cache = model.init_cache(1, 128)
    with torch.inference_mode():
        logits, _ = model.prefill(_prompt(model, 40, card), eager_cache)
        for key, group in eager_cache.items():
            if key == "len":
                graph_cache[key].copy_(group)
            else:
                for name, t in group.items():
                    graph_cache[key][name].copy_(t)
        tok = logits.argmax(-1)
        step.tokens.copy_(tok)
        for i in range(32):
            logits, _ = model.decode_step(tok, eager_cache)
            tok = logits.argmax(-1)
            assert torch.equal(step(), tok), f"step {i}"
    torch.cuda.synchronize()
    assert int(graph_cache["len"]) == int(eager_cache["len"]) == 72
    for key in ("prelude_state", "block_state", "attn_kv"):
        for name, t in eager_cache[key].items():
            assert torch.equal(graph_cache[key][name], t), (key, name)


@pytest.mark.cuda
def test_hybrid_replays_count_one_decode_launch_per_block(card):
    from repro_torch.launch.steps import build_serve_step

    model = _hybrid_card_model(card)
    blocks = model.cfg.hybrid_blocks
    cache = model.init_cache(1, 128)
    ops.reset_launch_counts()
    step = build_serve_step(model, cache)
    assert all(fn.launches == 0 for fn in ops.KERNEL_WRAPPERS)
    assert step.launches == {"flash_attention": 0, "flash_decode": blocks,
                             "selective_scan": 0, "moe_gmm": 0,
                             "scenario_scan": 0}
    with torch.inference_mode():
        logits, _ = model.prefill(_prompt(model, 20, card), cache)
    step(logits.argmax(-1))
    step()
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == blocks
    assert ops.flash_decode.launches == 2 * blocks
    assert ops.selective_scan.launches == ops.moe_gmm.launches == 0


# whisper-medium at d_model 256 (heads of 64, a width the kernels take) and
# 150 audio frames (a ragged last 64-slot tile): 2 encoder and 2 decoder
# layers
def _whisper_card_model(card, impl="kernel"):
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    gen = torch.Generator(device=card).manual_seed(0)
    cfg = get_config("whisper-medium").scaled(d_model=256, frontend_seq=150)
    assert cfg.resolved_head_dim == 64
    return build_model(cfg, device=card, dtype=torch.bfloat16, generator=gen,
                       impl=impl)


def _frames(model, card, seed=2):
    rng = np.random.default_rng(seed)
    cfg = model.cfg
    return _randn(rng, (1, cfg.frontend_seq, cfg.d_model), torch.float32, card)


@pytest.mark.cuda
def test_whisper_kernel_prefill_matches_plain(card):
    """Prefill logits and caches through the kernels against the plain
    versions, in float32 (1e-3) and bfloat16 (no further from the float32
    plain logits than twice the bfloat16 plain path)."""
    model = _whisper_card_model(card)
    frames, tokens = _frames(model, card), _prompt(model, 40, card)
    out = {}
    with torch.inference_mode():
        for impl in ("kernel", "plain"):
            model.impl = impl
            for dt in (torch.float32, torch.bfloat16):
                cache = model.init_cache(1, 64, dtype=dt)
                ops.reset_launch_counts()
                logits, _ = model.prefill(frames, tokens, cache, dtype=dt)
                torch.cuda.synchronize()
                launched = ops.flash_attention.launches
                assert launched == (6 if impl == "kernel" else 0), impl
                out[impl, dt] = (logits[..., :model.cfg.vocab_size].float(), cache)
    model.impl = "kernel"
    got32, c_got = out["kernel", torch.float32]
    want32, c_want = out["plain", torch.float32]
    torch.testing.assert_close(got32, want32, atol=1e-3, rtol=1e-3)
    for key in ("cross_k", "cross_v"):
        torch.testing.assert_close(c_got[key], c_want[key], atol=1e-3, rtol=1e-3)
    got16 = out["kernel", torch.bfloat16][0]
    plain16 = out["plain", torch.bfloat16][0]
    assert (got16 - want32).abs().max() <= 2 * (plain16 - want32).abs().max()


@pytest.mark.cuda
def test_whisper_captured_step_replays_the_eager_tokens(card):
    """From one prefill, 32 replays pick the tokens of 32 eager steps; a
    replay launches flash_decode twice per decoder layer (self and cross);
    the captured step reads the cross K/V a later prefill writes."""
    from repro_torch.launch.steps import build_serve_step

    model = _whisper_card_model(card)
    L = model.cfg.num_layers
    graph_cache = model.init_cache(1, 128)
    ops.reset_launch_counts()
    step = build_serve_step(model, graph_cache)
    assert step.graph is not None and int(graph_cache["len"]) == 0
    assert step.launches == {"flash_attention": 0, "flash_decode": 2 * L,
                             "selective_scan": 0, "moe_gmm": 0,
                             "scenario_scan": 0}
    eager_cache = model.init_cache(1, 128)
    with torch.inference_mode():
        for seed in (2, 3):      # a second request into the same slot
            frames, prompt = _frames(model, card, seed), _prompt(model, 40, card, seed)
            model.reset_cache(graph_cache)
            model.reset_cache(eager_cache)
            logits, _ = model.prefill(frames, prompt, eager_cache)
            model.prefill(frames, prompt, graph_cache)
            tok = logits.argmax(-1)
            step.tokens.copy_(tok)
            for i in range(32):
                logits, _ = model.decode_step(tok, eager_cache)
                tok = logits.argmax(-1)
                assert torch.equal(step(), tok), f"request {seed} step {i}"
            torch.cuda.synchronize()
            assert int(graph_cache["len"]) == int(eager_cache["len"]) == 72
            for key in ("cross_k", "cross_v"):
                assert torch.equal(graph_cache[key], eager_cache[key]), key


# ---------------------------------------------------------------------------
# the scenario engine's data plane (scenario_scan)
# ---------------------------------------------------------------------------

SCENARIO_EXACT = ("status", "a_ptr", "run_n", "q_cnt", "n_retried", "overflow")
SCENARIO_FLOAT = ("e2e",)
SCENARIO_TRACE = (("rep",), ("disp_t", "start_t", "fin_t"))

# (id, lb_rr, expire_on, trace_on, concurrency, service scale (s), queue
# capacity, amax below the real maximum[, shape of the lanes]): one regime
# per branch the kernel takes; every regime has kill events, within the
# horizon and past it.  The regimes with a shape reach what the kernel keeps
# off its common path: a tape 20x its shared-memory window with a pending
# backlog past the ring's shared-memory share (it spills to device memory,
# and a drained backlog reads tape entries older than the window); more
# slots than a warp has threads (a thread owns two); kills re-pending deep
# queues whose requests lie further behind the arrivals than the window
# reaches; and queue rings that compact (RTTs 25 s apart make the expiry
# sweep punch holes in the middle of a ring).
SCENARIO_REGIMES = [
    ("least_loaded_traced", False, True, True, 2, 2.0, 256, False),
    ("round_robin", True, True, False, 2, 1.0, 256, False),
    ("round_robin_traced", True, True, True, 3, 2.0, 256, False),
    ("no_expiry_sweep", False, False, True, 2, 1.0, 256, False),
    ("saturated_expiry", False, True, True, 1, 8.0, 256, False),
    ("queue_overflow", False, True, False, 1, 8.0, 4, False),
    ("arrival_overflow", True, True, False, 2, 1.0, 256, True),
    ("long_tape_spilled_backlog", False, True, True, 8, 0.05, 256, False,
     dict(L=4, N=20_000, W=240, R=8, dark=(60, 100))),
    ("slots_beyond_a_warp", False, True, True, 2, 2.0, 256, False,
     dict(R=40, N=3000, E=12)),
    ("slots_beyond_a_warp_round_robin", True, True, False, 2, 2.0, 256, False,
     dict(R=40, N=3000, E=12)),
    ("kills_re_pend_deep_queues", False, True, False, 1, 8.0, 2048, False,
     dict(N=2000, E=12, timeout=1e4)),
    ("queue_rings_compact", False, True, True, 1, 8.0, 28, False,
     dict(rtt_values=(0.002, 25.0))),
]


def scenario_lanes(seed: int, *, L: int = 6, W: int = 40, R: int = 6,
                   NREG: int = 2, E: int = 4, N: int = 600,
                   svc_scale: float = 1.0, timeout: float = 30.0,
                   rtt_values=(0.002, 0.07), dark=None):
    """Seeded lanes of a shape group, numpy, on a grid of W 15 s windows of
    1 s sub-steps: ragged tapes (+inf padded) of about N / (0.9 G) arrivals
    a second (one at the defaults), service times of 0.05 s plus an
    exponential of ``svc_scale`` seconds, RTTs of two values (ties for the
    least-loaded tie-break), each slot ready over a window range, E kill
    events per lane (some past the horizon) and a ``timeout`` in seconds;
    no slot is ready in the windows of the range ``dark``."""
    from repro_torch.serving.torchengine.schedule import build_grid

    rng = np.random.default_rng(seed)
    grid = build_grid(W * 15.0, 15.0, 1.0)
    G = grid.n_points
    lanes = {
        "arr": np.full((L, N), np.inf), "svc": np.ones((L, N)),
        "rcode": np.zeros((L, N), np.int64), "rtt": np.zeros((L, R, NREG)),
        "ready": np.zeros((L, W, R), bool),
        "kill_slot": np.zeros((L, E), np.int64),
        "kill_g": np.full((L, E), G, np.int64), "timeout": np.full(L, timeout),
    }
    win = np.arange(W)[:, None]
    for li in range(L):
        n = N - int(rng.integers(0, N // 4))
        lanes["arr"][li, :n] = np.sort(rng.uniform(0.0, 0.9 * G, n))
        lanes["svc"][li, :n] = 0.05 + rng.exponential(svc_scale, n)
        lanes["rcode"][li, :n] = rng.integers(0, NREG, n)
        lanes["rtt"][li] = rng.choice(list(rtt_values), (R, NREG))
        start = rng.integers(0, W // 4, R)
        stop = rng.integers(W // 2, W + 1, R)
        lanes["ready"][li] = (win >= start) & (win < stop)
        if dark is not None:
            lanes["ready"][li, dark[0]:dark[1]] = False
        wk = np.sort(rng.integers(1, W + 3, E))     # W and past: post-horizon
        lanes["kill_slot"][li] = rng.integers(0, R, E)
        lanes["kill_g"][li] = np.where(wk < W, grid.win_first[np.minimum(wk, W - 1)], G)
    return lanes, (grid.ts, np.arange(G, dtype=np.int64), grid.win_of)


def scenario_args(lanes, grid, device):
    from repro_torch.serving.torchengine.kernel import LANE_KEYS

    return ([torch.from_numpy(lanes[k]).to(device) for k in LANE_KEYS]
            + [torch.from_numpy(a).to(device) for a in grid])


def assert_scenario_equal(got, want, trace_on: bool):
    """Kernel outputs against the plain version's: the overflow flags
    equal, and on every lane that did not overflow the counts and statuses
    equal and the floats within the reference's 1e-6 (expected equal)."""
    got = {k: v.cpu().numpy() for k, v in got.items()}
    want = {k: v.cpu().numpy() for k, v in want.items()}
    assert set(got) == set(want)
    keep = ~want["overflow"]
    np.testing.assert_array_equal(got["overflow"], want["overflow"])
    exact, floats = SCENARIO_EXACT, SCENARIO_FLOAT
    if trace_on:
        exact, floats = exact + SCENARIO_TRACE[0], floats + SCENARIO_TRACE[1]
    for k in exact:
        np.testing.assert_array_equal(got[k][keep], want[k][keep], err_msg=k)
    for k in floats:
        g, w = got[k][keep], want[k][keep]
        with np.errstate(invalid="ignore"):     # inf - inf: equal, below
            close = np.abs(g - w) <= 1e-6
        assert np.all((g == w) | close), k
    return keep


@pytest.mark.cuda
@pytest.mark.parametrize("regime", SCENARIO_REGIMES, ids=[r[0] for r in SCENARIO_REGIMES])
def test_scenario_scan_kernel_matches_plain(card, regime):
    from repro_torch.kernels import scenario_scan as tscn

    _, lb_rr, expire_on, trace_on, C, svc_scale, Q, low_amax = regime[:8]
    shape = regime[8] if len(regime) > 8 else {}
    lanes, grid = scenario_lanes(3 + C, svc_scale=svc_scale, **shape)
    counts = np.diff([np.searchsorted(a, grid[0], side="right")
                      for a in lanes["arr"]], prepend=0, axis=1)
    amax = int(counts[0].max()) - 1 if low_amax else max(64, int(counts.max()))
    kw = dict(Q=Q, C=C, amax=amax, lb_rr=lb_rr, expire_on=expire_on,
              trace_on=trace_on)
    want = tscn.plain(*scenario_args(lanes, grid, "cpu"), **kw)
    before = ops.scenario_scan.launches
    got = ops.scenario_scan(*scenario_args(lanes, grid, card), **kw)
    torch.cuda.synchronize()
    assert ops.scenario_scan.launches == before + 1
    keep = assert_scenario_equal(got, want, trace_on)
    if regime[0].endswith("overflow"):
        assert not keep.all()
    else:
        assert keep.all()
        assert (want["n_retried"] > 0).any()              # kills re-pended work
        assert (want["status"] == 2).any() or (want["status"] == 0).any()


@pytest.mark.cuda
def test_scenario_matrix_on_card_matches_the_recording(card):
    """The first 4 seeds of both policies of the reference benchmark's
    matrix: one launch on the card, each cell equal to the reference
    oracle's recorded result, and every lane's outputs equal to the plain
    version's."""
    from repro_torch.serving.torchengine import engine as teng
    from repro_torch.serving.torchengine import recorded

    scheds = recorded.recorded_matrix(n_seeds=4)
    cells = recorded.recorded_cells(n_seeds=4)
    ops.reset_launch_counts()
    outs = []
    got = teng.run_schedules(scheds, outputs=outs)
    assert ops.scenario_scan.launches == 1
    for res, cell in zip(got, cells):
        want = cell["result"]
        for k in ("n_requests", "n_completed", "n_failed", "n_retried_requests"):
            assert getattr(res, k) == want[k], k
        assert res.availability == pytest.approx(want["availability"], abs=1e-12)
        assert res.total_cost == pytest.approx(want["total_cost"], abs=1e-9)
        for q in (50, 90, 99):
            assert res.pct(q) == pytest.approx(want[f"p{q}_s"], abs=1e-6)
    plain_outs = []
    teng.run_schedules(scheds, outputs=plain_outs, device="cpu")
    for out, ref in zip(outs, plain_outs):
        for k in ref:
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


@pytest.mark.cuda
def test_scenario_scan_refuses_what_it_does_not_take(card):
    from repro_torch.kernels import scenario_scan as tscn

    lanes, grid = scenario_lanes(1, L=2)
    args = scenario_args(lanes, grid, card)
    kw = dict(Q=256, C=2, amax=8, lb_rr=False, expire_on=True, trace_on=True)
    with pytest.raises(ValueError, match="shared memory"):
        tscn.launch(*args, **{**kw, "Q": 4096})
    with pytest.raises(ValueError, match="one CUDA device"):
        tscn.launch(*args[:-1], args[-1].cpu(), **kw)
    with pytest.raises(ValueError, match="svc"):
        tscn.launch(args[0], args[1][:, :-1], *args[2:], **kw)


# ---------------------------------------------------------------------------
# the front door: Service and ScenarioSuite with phase B on the card
# ---------------------------------------------------------------------------

# tests/test_golden.py's spothedge constants (this file imports no JAX)
GOLDEN_SPOTHEDGE = dict(n_requests=3571, n_completed=3501, n_failed=70,
                        n_preemptions=1, n_launch_failures=0,
                        total_cost=50.733135, p50_s=0.703607,
                        p99_s=1.692754, availability=0.972917)


def golden_spec(engine: str) -> dict:
    return {
        "name": "golden-spothedge", "model": "llama3.2-1b", "trace": "aws-1",
        "resources": {"instance_type": "g5.48xlarge"},
        "replica_policy": {"name": "spothedge"},
        "autoscaler": {"kind": "constant", "target": 3},
        "workload": {"kind": "poisson", "rate_per_s": 0.5, "seed": 17},
        "sim": {"duration_hours": 2.0, "timeout_s": 60.0, "concurrency": 2,
                "drain_s": 300.0, "seed": 0, "engine": engine},
    }


@pytest.mark.cuda
def test_service_golden_on_card(card):
    from repro_torch.service import Service

    svc = Service(golden_spec("jax"))
    ops.reset_launch_counts()
    res = svc.run()
    assert ops.scenario_scan.launches == 1
    assert svc.status()["oracle_rerun"] is False
    want = GOLDEN_SPOTHEDGE
    for k in ("n_requests", "n_completed", "n_failed", "n_preemptions",
              "n_launch_failures"):
        assert getattr(res, k) == want[k], k
    assert res.total_cost == pytest.approx(want["total_cost"], abs=1e-6)
    assert res.pct(50) == pytest.approx(want["p50_s"], abs=1e-6)
    assert res.pct(99) == pytest.approx(want["p99_s"], abs=1e-6)
    assert res.availability == pytest.approx(want["availability"], abs=1e-6)


@pytest.mark.cuda
def test_arena_sweep_on_card_equals_the_host_engine(card):
    from repro_torch.experiments import ScenarioSuite

    spec = dict(golden_spec("jax"),
                workload={"kind": "arena", "rate_per_s": 0.8, "seed": 5},
                sweep={"policies": ["spothedge", "even_spread"],
                       "traces": ["aws-1", "gcp-1"]})
    spec["sim"] = dict(spec["sim"], duration_hours=1.0)
    suite = ScenarioSuite.from_spec(spec)
    ops.reset_launch_counts()
    got = suite.run()
    assert ops.scenario_scan.launches == got.shape_groups == 1
    want = ScenarioSuite.from_spec(spec).run(engine="vector")
    for a, b in zip(got.cells, want.cells):
        assert a.labels == b.labels
        for k in ("n_requests", "n_completed", "n_failed", "n_preemptions",
                  "n_launch_failures"):
            assert getattr(a, k) == getattr(b, k), k
        for k in ("total_cost", "cost_vs_ondemand", "availability"):
            assert getattr(a, k) == pytest.approx(getattr(b, k), abs=1e-9), k
        for k in ("mean_s", "p50_s", "p90_s", "p99_s"):
            assert getattr(a, k) == pytest.approx(getattr(b, k), abs=1e-6), k


@pytest.mark.cuda
def test_risk_and_omniscient_sweep_on_card_equals_the_plain_version(card):
    """Risk-aware SpotHedge under two forecasters and the Omniscient oracle
    (its plan solved on the trace when the cell is built), their request
    lanes through ``run_cells`` on the card in one launch: every cell
    equal to the plain version's on the host."""
    from repro_torch.experiments import ScenarioSuite
    from repro_torch.serving.torchengine import engine as teng

    spec = dict(golden_spec("jax"),
                workload={"kind": "arena", "rate_per_s": 0.8, "seed": 5},
                forecast={"name": "markov"},
                sweep={"policies": ["risk_spothedge", "omniscient"],
                       "forecasters": ["ewma", "markov"]})
    spec["sim"] = dict(spec["sim"], duration_hours=1.0)
    cells = ScenarioSuite.from_spec(spec).cells()
    assert [c.labels.get("forecaster") for c in cells] == ["ewma", "markov",
                                                           None]
    assert cells[2].engine.cluster.policy.schedule is not None
    groups = []
    ops.reset_launch_counts()
    got = teng.run_cells([c.engine for c in cells],
                         [c.duration_s for c in cells], groups=groups)
    assert ops.scenario_scan.launches == len(groups) == 1
    assert not any(c.engine.fell_back for c in cells)
    plain = ScenarioSuite.from_spec(spec).cells()
    want = teng.run_cells([c.engine for c in plain],
                          [c.duration_s for c in plain], device="cpu")
    for a, b in zip(got, want):
        for k in ("n_requests", "n_completed", "n_failed", "n_preemptions",
                  "n_launch_failures", "n_retried_requests"):
            assert getattr(a, k) == getattr(b, k), k
        for k in ("total_cost", "cost_vs_ondemand"):
            assert getattr(a, k) == pytest.approx(getattr(b, k), abs=1e-9), k
        assert a.availability == pytest.approx(b.availability, abs=1e-12)
        np.testing.assert_allclose(np.sort(a.latencies_s),
                                   np.sort(b.latencies_s), atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_mixed_matrix_on_card_runs_token_cells_on_the_host(card):
    """A request x token matrix through ``run_cells`` on the card: the
    request lanes in one ``scenario_scan`` launch, the token cells on the
    host engine (no lane, no output, in no group), no oracle rerun, and
    every cell equal to the host engine's."""
    import dataclasses

    from repro_torch.experiments import ScenarioSuite
    from repro_torch.serving.engine import VectorizedServingEngine
    from repro_torch.serving.torchengine import engine as teng

    spec = dict(golden_spec("jax"),
                workload={"kind": "arena", "rate_per_s": 0.8, "seed": 5},
                sweep={"policies": ["spothedge", "ondemand_only"],
                       "replica_models": ["request", "token"]})
    spec["sim"] = dict(spec["sim"], duration_hours=1.0)
    cells = ScenarioSuite.from_spec(spec).cells()
    token = [c.spec.sim.replica_model == "token" for c in cells]
    assert token == [False, True, False, True]
    outs, groups = [], []
    ops.reset_launch_counts()
    got = teng.run_cells([c.engine for c in cells],
                         [c.duration_s for c in cells], outputs=outs,
                         groups=groups)
    assert ops.scenario_scan.launches == 1
    assert groups == [[0, 2]]
    assert [o is None for o in outs] == token
    assert [c.engine.ran_on_host for c in cells] == token
    assert not any(c.engine.fell_back for c in cells)
    hosts = ScenarioSuite.from_spec(spec).cells()
    for res, host in zip(got, hosts):
        want = VectorizedServingEngine.run(host.engine, host.duration_s)
        for f in dataclasses.fields(want):
            a, b = getattr(res, f.name), getattr(want, f.name)
            if f.name == "latencies_s":
                np.testing.assert_allclose(np.sort(a), np.sort(b), atol=1e-6,
                                           rtol=0)
            elif f.name == "token":
                assert (a is None) == (b is None)
                if b is not None:
                    assert a.to_dict() == b.to_dict()
            elif f.name == "obs":
                # the card's phase A records the host engine's control
                # plane (a token cell ran on the host: all of it)
                from repro_torch.obs import control_plane_records
                want_recs = (b.records() if res.token is not None
                             else control_plane_records(b.records()))
                assert a.records() == want_recs
            elif isinstance(b, float):
                assert a == pytest.approx(b, abs=1e-9), f.name
            else:
                assert a == b, f.name


@pytest.mark.cuda
def test_card_spans_equal_the_plain_versions(card):
    """The reference's obs fixture (tests/test_obs.py: the mini trace over 3
    zones, spothedge x 3, Poisson 0.8/s for 1 h, every request sampled)
    through ``run_cells`` on the card and through the plain version on the
    CPU: the same event stream, and span records rebuilt from the kernel's
    span timelines byte-identical to the plain version's."""
    from repro_torch.cluster.traces import synth_correlated_trace
    from repro_torch.configs import get_config
    from repro_torch.core.autoscaler import ConstantTarget
    from repro_torch.core.policy import make_policy
    from repro_torch.obs import ObsRecorder, dumps_jsonl
    from repro_torch.serving.torchengine import engine as teng
    from repro_torch.workloads.arrivals import make_workload

    zones = ["us-west-2a", "us-west-2b", "us-east-2a"]

    def engine():
        trace = synth_correlated_trace(
            zones, {z: z[:-1] for z in zones}, steps=120, dt=60.0, seed=3,
            max_capacity=4, name="mini")
        reqs = make_workload("poisson", rate_per_s=0.8, seed=3).generate(3600.0)
        return teng.TorchServingEngine(
            trace, make_policy("spothedge"), reqs, get_config("llama3.2-1b"),
            itype="g5.48xlarge", autoscaler=ConstantTarget(3), timeout_s=60.0,
            concurrency=2, workload_name="poisson",
            obs=ObsRecorder(detail="full", trace_sample=1.0))

    ops.reset_launch_counts()
    got = teng.run_cells([engine()], [4200.0])[0]
    assert ops.scenario_scan.launches == 1
    want = teng.run_cells([engine()], [4200.0], device="cpu")[0]
    spans = got.obs.span_records()
    assert spans and len(spans) == len(want.obs.span_records())
    assert dumps_jsonl(spans) == dumps_jsonl(want.obs.span_records())
    assert dumps_jsonl(got.obs.records()) == dumps_jsonl(want.obs.records())
    assert got.metrics == want.metrics


# ---------------------------------------------------------------------------
# the prefill step captured as a CUDA graph, and the train path on the card
# ---------------------------------------------------------------------------


def _cache_tensors(cache):
    for key, value in cache.items():
        if isinstance(value, torch.Tensor):
            yield key, value
        else:
            for name, t in value.items():
                yield f"{key}.{name}", t


@pytest.mark.cuda
@pytest.mark.parametrize("arch", CAPTURE_ARCHS)
def test_captured_prefill_equals_eager_prefill(card, arch):
    """Two replays (the second over the cache the first filled) each equal
    one eager ``prefill`` into a fresh cache, logits and every cache tensor
    to the bit; a replay adds the launches the capture counted."""
    from repro_torch.launch.steps import build_prefill_step

    model = _card_model(arch, card)
    step = build_prefill_step(model, model.init_cache(1, 96), 80)
    assert step.graph is not None and int(step.cache["len"]) == 0
    with torch.inference_mode():
        for seed in (1, 2):
            tokens = _prompt(model, 80, card, seed=seed)
            fresh = model.init_cache(1, 96)
            want, _ = model.prefill(tokens, fresh)
            before = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
            got = step(tokens)
            torch.cuda.synchronize()
            assert {fn.__name__: fn.launches - before[fn.__name__]
                    for fn in ops.KERNEL_WRAPPERS} == step.launches
            assert torch.equal(got, want), seed
            theirs = dict(_cache_tensors(fresh))
            for k, t in _cache_tensors(step.cache):
                assert torch.equal(t, theirs[k]), (seed, k)


@pytest.mark.cuda
def test_train_step_on_the_card_equals_the_cpu(card):
    """A 2-layer llama3.2-1b at d_model 256 in float32 (TF32 off): one train
    step on the card and on the CPU from the same weights and batch, loss
    and parameters within 1e-5 relative; no kernel launched."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_train_step
    from repro_torch.training import make_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("llama3.2-1b").scaled(d_model=256),
                              num_layers=2)
    kw = dict(microbatches=2, param_dtype=torch.float32, dtype=torch.float32)
    cpu = build_train_step(cfg, device="cpu", **kw)
    dev = build_train_step(cfg, device=card, **kw)
    dev.model.load_state_dict(cpu.model.state_dict())
    batch = make_batch(cfg, 4, 32, seed=2, device="cpu", dtype=torch.float32)
    ops.reset_launch_counts()
    m_dev = dev({k: v.to(card) for k, v in batch.items()})
    m_cpu = cpu(batch)
    assert all(fn.launches == 0 for fn in ops.KERNEL_WRAPPERS)
    assert float(m_dev["loss"]) == pytest.approx(float(m_cpu["loss"]), rel=1e-5)
    for k, p in cpu.params.items():
        got = dev.params[k].detach().cpu()
        assert float((got - p.detach()).norm()) <= 1e-5 * float(p.detach().norm()), k


@pytest.mark.cuda
def test_kernel_wrappers_refuse_grad_on_the_card(card):
    q = torch.randn(1, 64, 4, 64, device=card, dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.randn(1, 64, 4, 64, device=card, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="requires grad"):
        ops.flash_attention(q, k, k)
    with torch.no_grad():
        assert ops.flash_attention(q, k, k).shape == q.shape
