"""The attention kernels at every head width the reference's take: past
256, off a multiple of 8, and on rows that are not 16-byte aligned.

``flash_attention_bhsd`` and ``flash_decode_bhd`` carry D whole in their
BlockSpecs, so they take any D >= 1; the port's wrappers must too.  On the
CPU the wrappers run their plain versions, held here against the Pallas
kernels in interpret mode and the reference's oracles at the reference's
tolerances (2e-5 in float32, 2e-2 in bfloat16), at D = 1 .. 576 under the
causal, sliding-window, prefix-LM and bidirectional masks and the decode
masks (occupancy, ring, no valid slot); a 2-layer model at head_dim 100 and
288 against the reference model; the meta route's count of the work; the
launch's shared-memory figures, group tiles and copy alignment at the new
widths.  The CUDA kernels themselves run on the card
(``test_torch_cuda.py``, ``chip_smoke.py``'s width sweep).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_bhsd  # noqa: E402
from repro.kernels.flash_decode import flash_decode_bhd  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import cost, ops  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.models.registry import build_model as t_build  # noqa: E402
from test_torch_kernels import _check_p_in_bf16, _decode_mask, _np, _pair  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
WIDTHS = (1, 4, 36, 100, 130, 250, 264, 288, 512, 576)

# (B, H, Kv, Sq, Skv, D, causal, window, prefix) in the layout of
# test_kernels.py's ATTN_CASES: each width under one of the masks, the
# query groups 1, 2, 4 and 8, ragged lengths around the 64-row tiles
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

# (B, H, Kv, S, D, mask) in the layout of WIDE_DECODE_CASES: the masks of
# _decode_mask, query groups 1 to 12 (G = 12 holds two of the bf16 group
# tiles of 8 past 192)
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


def test_card_cases_are_these_cases():
    """``test_torch_cuda.py`` (no JAX on the card) keeps its own copy."""
    import test_torch_cuda

    assert test_torch_cuda.ANY_WIDTH_ATTN_CASES == ANY_WIDTH_ATTN_CASES
    assert test_torch_cuda.ANY_WIDTH_DECODE_CASES == ANY_WIDTH_DECODE_CASES


def test_the_cases_cover_every_width():
    assert tuple(c[5] for c in ANY_WIDTH_ATTN_CASES) == WIDTHS
    assert tuple(c[4] for c in ANY_WIDTH_DECODE_CASES) == WIDTHS
    masks = {(c[6], c[7] is not None, c[8] > 0) for c in ANY_WIDTH_ATTN_CASES}
    assert masks == {(True, False, False), (False, False, False),
                     (True, True, False), (True, False, True)}
    assert {c[5] for c in ANY_WIDTH_DECODE_CASES} == {"prefix", "ring", "none"}


@pytest.mark.parametrize("case", ANY_WIDTH_ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas_at_any_width(case, dtype):
    """The port's wrapper on the CPU (its plain version) against the Pallas
    kernel in interpret mode and the reference's oracle."""
    B, H, Kv, Sq, Skv, D, causal, window, prefix = case
    tol = TOL[dtype]
    rng = np.random.default_rng(600 + ANY_WIDTH_ATTN_CASES.index(case))
    jq, tq = _pair(rng, (B, H, Sq, D), dtype)
    jk, tk = _pair(rng, (B, Kv, Skv, D), dtype)
    jv, tv = _pair(rng, (B, Kv, Skv, D), dtype)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    pallas = flash_attention_bhsd(jq, jk, jv, block_q=64, block_kv=64,
                                  interpret=True, **kw)
    oracle = jref.flash_attention_ref(jq, jk, jv, **kw)
    got = ops.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                              tv.transpose(1, 2), **kw).transpose(1, 2)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", ANY_WIDTH_ATTN_CASES)
def test_bf16_rounding_of_p_at_any_width(case):
    """The tensor-core kernels round P to bf16 before P.V at these widths
    too (the sliced kernel's P.V is the warp-specialised kernel's step);
    that stays within 2e-2 of the Pallas kernel."""
    _check_p_in_bf16(case, 600 + ANY_WIDTH_ATTN_CASES.index(case))


@pytest.mark.parametrize("case", ANY_WIDTH_DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_matches_pallas_at_any_width(case, dtype):
    B, H, Kv, S, D, kind = case
    tol = TOL[dtype]
    rng = np.random.default_rng(700 + ANY_WIDTH_DECODE_CASES.index(case))
    jq, tq = _pair(rng, (B, H, D), dtype)
    jk, tk = _pair(rng, (B, Kv, S, D), dtype)
    jv, tv = _pair(rng, (B, Kv, S, D), dtype)
    valid = _decode_mask(kind, B, S)
    pallas = flash_decode_bhd(jq, jk, jv, jnp.asarray(valid), block_kv=128,
                              interpret=True)
    oracle = jref.flash_decode_ref(jq, jk, jv, jnp.asarray(valid))
    got = ops.flash_decode(tq[:, None], tk.transpose(1, 2), tv.transpose(1, 2),
                           kv_valid=torch.from_numpy(valid))[:, 0]
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol, rtol=tol)


@pytest.mark.parametrize("D", [0, -3])
def test_only_a_width_below_one_is_refused(D):
    assert not tfa.supports(D)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.check_head_dim(D)


@pytest.mark.parametrize("D", [100, 576])
def test_meta_route_counts_the_work(D):
    """The meta route takes the new widths and records what the kernels
    must do: the causal pairs' two products and each operand once."""
    B, H, Kv, S = 1, 32, 8, 256

    class Counter:
        def __init__(self):
            self.work = {}

        def add_kernel(self, kernel, work):
            self.work[kernel] = work

    counter = Counter()
    cost._active.append(counter)
    try:
        q = torch.empty((B, S, H, D), dtype=torch.bfloat16, device="meta")
        kv = torch.empty((B, S, Kv, D), dtype=torch.bfloat16, device="meta")
        out = ops.flash_attention(q, kv, kv)
        assert out.shape == q.shape and out.device.type == "meta"
        qd = torch.empty((B, 1, H, D), dtype=torch.bfloat16, device="meta")
        valid = torch.empty((B, S), dtype=torch.bool, device="meta")
        assert ops.flash_decode(qd, kv, kv, kv_valid=valid).shape == qd.shape
    finally:
        cost._active.remove(counter)
    pairs = S * (S + 1) // 2
    fa, fd = counter.work["flash_attention"], counter.work["flash_decode"]
    assert fa.flops == 4.0 * B * H * D * pairs
    assert fa.bytes == 2.0 * (2 * B * S * H * D + 2 * B * S * Kv * D)
    assert fd.flops == 4.0 * B * H * D * S
    assert fd.bytes == 2.0 * B * H * D * 2 + B * S + 2.0 * 2 * B * S * Kv * D


@pytest.mark.parametrize("dtype,D,align,form,want", [
    # bf16 rows of whole aligned chunks keep their kernels
    (torch.bfloat16, 64, 16, "mma", 2 * 64 * 64 * 7),
    (torch.bfloat16, 256, 16, "ws", 2 * 64 * 256 * 7 + 8 * 7),
    # rows that are not (OpenLLaMA-3B's 100: 200-byte rows, 8-byte aligned;
    # odd widths and element offsets, 2) up to 128: the one-warpgroup
    # kernel's tiles, copied at any alignment
    (torch.bfloat16, 100, 8, "mma_any", 2 * 64 * 128 * 7),
    (torch.bfloat16, 1, 2, "mma_any", 2 * 64 * 64 * 7),
    (torch.bfloat16, 64, 2, "mma_any", 2 * 64 * 64 * 7),
    # past 128 at a loose alignment, and every width past 256: two stages
    # of a 64 x 64 Q and K chunk and a 64 x 256 V slice
    (torch.bfloat16, 130, 4, "sliced", 2 * (2 * 2 * 64 * 64 + 64 * 256)),
    (torch.bfloat16, 256, 2, "sliced", 2 * (2 * 2 * 64 * 64 + 64 * 256)),
    (torch.bfloat16, 512, 16, "sliced", 2 * (2 * 2 * 64 * 64 + 64 * 256)),
    (torch.bfloat16, 1024, 16, "sliced", 2 * (2 * 2 * 64 * 64 + 64 * 256)),
    # fp32 up to 256 at any width and alignment: the scalar kernel
    (torch.float32, 1, 4, "f32", 4 * (64 * 2 * 2 + 64 * 1 + 64 * 65)),
    (torch.float32, 250, 8, "f32", 4 * (64 * 251 * 2 + 64 * 250 + 64 * 65)),
    # past 256: its slices, whatever D
    (torch.float32, 264, 16, "f32_sliced", 4 * (64 * 65 * 3 + 64 * 256)),
    (torch.float32, 1024, 4, "f32_sliced", 4 * (64 * 65 * 3 + 64 * 256)),
])
def test_prefill_form_and_shared_memory_at_any_width(dtype, D, align, form, want):
    assert tfa.kernel_form(dtype, D, align) == form
    assert tfa.smem_bytes(dtype, D, align) == want <= 232_448


@pytest.mark.parametrize("dtype,D,align,S,want", [
    # bf16 at a loose alignment: the class's ring (rows of whole
    # 64-element swizzle groups), as on aligned rows
    (torch.bfloat16, 100, 8, 2048, 2 * 2 * 64 * 128 * 2 + 4 * (1 + 32)),
    (torch.bfloat16, 1, 2, 2048, 2 * 2 * 64 * 64 * 2 + 4 * (1 + 32)),
    (torch.bfloat16, 250, 4, 2048, 2 * 2 * 64 * 256 * 2 + 4 * (1 + 32)),
    # fp32 at a loose alignment: rows padded to whole 4-float chunks (one
    # stage past 128); D = 4 (rows below 8 floats) copies so too
    (torch.float32, 36, 4, 2048, 2 * 2 * 64 * 36 * 4 + 4 * (1 + 32)),
    (torch.float32, 37, 4, 2048, 2 * 2 * 64 * 40 * 4 + 4 * (1 + 32)),
    (torch.float32, 130, 8, 2048, 2 * 64 * 132 * 4 + 4 * (1 + 32)),
    (torch.float32, 4, 16, 2048, 2 * 2 * 64 * 4 * 4 + 4 * (1 + 32)),
    # past 256: one stage of a 256-column K chunk and V slice, whatever D
    (torch.bfloat16, 264, 16, 2048, 2 * 64 * 256 * 2 + 4 * (1 + 32)),
    (torch.bfloat16, 576, 2, 2048, 2 * 64 * 256 * 2 + 4 * (1 + 32)),
    (torch.float32, 1024, 4, 2048, 2 * 64 * 256 * 4 + 4 * (1 + 32)),
])
def test_decode_shared_memory_at_any_width(dtype, D, align, S, want):
    assert tfd.smem_bytes(dtype, D, S, align=align) == want <= 200 * 1024


@pytest.mark.parametrize("dtype,D,G,align,want", [
    # a served width on rows not whole aligned chunks runs its class
    (torch.bfloat16, 128, 8, 8, 16),
    (torch.bfloat16, 64, 4, 2, 16),
    (torch.bfloat16, 128, 8, 16, 8),
    (torch.bfloat16, 100, 1, 8, 16),
    (torch.bfloat16, 250, 4, 4, 8),
    # past 256, 8 heads on the n8 columns in both dtypes
    (torch.bfloat16, 264, 16, 16, 8),
    (torch.bfloat16, 576, 128, 16, 8),
    (torch.float32, 288, 4, 16, 8),
    (torch.float32, 36, 48, 4, 8),
])
def test_decode_group_tile_at_any_width(dtype, D, G, align, want):
    assert tfd.group_tile(dtype, D, G, align) == want


def test_decode_slices_past_256():
    assert [tfd.slices(D) for D in (1, 256, 257, 512, 576, 1024)] == [1, 1, 2, 2, 3, 4]
    assert tfd.loose(torch.bfloat16, 256, 16) is False
    assert tfd.loose(torch.bfloat16, 100, 8) and tfd.loose(torch.float32, 4, 16)


def test_row_alignment_reads_base_strides_and_width():
    """The copies the kernels may use, from the tensors alone: views into a
    fused buffer at an odd element offset go element by element, a
    200-byte row in 8-byte pieces, aligned rows in 16-byte chunks."""
    x = torch.zeros((2, 64, 4, 128), dtype=torch.bfloat16)
    assert tfa.row_alignment(x) == 16
    assert tfa.row_alignment(x[..., :100]) == 8        # 200-byte rows
    assert tfa.row_alignment(torch.zeros((2, 64, 4, 100), dtype=torch.bfloat16)) == 8
    assert tfa.row_alignment(torch.zeros((2, 64, 4, 36), dtype=torch.bfloat16)) == 8
    assert tfa.row_alignment(x[..., :99]) == 2         # odd widths
    fused = torch.zeros((2, 64, 3 * 4 * 64 + 1), dtype=torch.bfloat16)
    q = fused[..., 1:1 + 4 * 64].view(2, 64, 4, 64)    # one element off
    assert q.data_ptr() % 16 == 2 and tfa.row_alignment(q) == 2
    assert tfa.row_alignment(x, q) == 2                # the least of them
    f = torch.zeros((1, 8, 2, 37))
    assert tfa.row_alignment(f) == 4
    # an axis of length 1 is never stepped: its stride does not count
    assert tfa.row_alignment(x[:1, :, :1]) == 16


# ---------------------------------------------------------------------------
# a model at head_dim 100 and 288 against the reference
# ---------------------------------------------------------------------------

B, STEPS, PROMPT = 2, 6, 10


def _cut(cfg, head_dim):
    """llama3.2-1b's block at 2 layers of width 128, 4 heads on 2 KV heads
    of ``head_dim`` (so the projections are 4 x head_dim wide), d_ff 256,
    vocabulary 512."""
    return dataclasses.replace(cfg, num_layers=2, d_model=128, num_heads=4,
                               num_kv_heads=2, head_dim=head_dim, d_ff=256,
                               vocab_size=512)


@pytest.mark.parametrize("head_dim", [100, 288])
def test_model_at_head_dim_matches_reference(head_dim):
    """The reference under ``impl="pallas"`` (its kernels in interpret
    mode) and the port (its kernel wrappers: plain versions on the CPU),
    both from the reference's init tree moved by seeded noise, in float32:
    prefill logits and every decode step's within 1e-4, greedy tokens
    equal, caches within 1e-5."""
    jcfg = _cut(j_config("llama3.2-1b"), head_dim)
    tcfg = _cut(t_config("llama3.2-1b"), head_dim)
    assert tcfg.resolved_head_dim == jcfg.resolved_head_dim == head_dim
    jmodel = j_build(jcfg, impl="pallas")
    rng = np.random.default_rng(head_dim)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32))
        + 0.02 * rng.standard_normal(a.shape).astype(np.float32),
        jmodel.init(jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tmodel = t_build(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(tree))

    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, PROMPT))
    max_len = PROMPT + STEPS
    prefill = jax.jit(functools.partial(jmodel.prefill, dtype=jnp.float32))
    decode = jax.jit(functools.partial(jmodel.decode_step, dtype=jnp.float32))
    jlog, jcache = prefill(params, jnp.asarray(toks),
                           jmodel.init_cache(B, max_len, jnp.float32))
    ops.reset_launch_counts()
    tcache = tmodel.init_cache(B, max_len, dtype=torch.float32)
    tlog, tcache = tmodel.prefill(torch.from_numpy(toks), tcache,
                                  dtype=torch.float32)
    np.testing.assert_allclose(_np(tlog), _np(jlog), atol=1e-4, rtol=1e-4)
    jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
    ttok = tlog.argmax(-1)
    for step in range(STEPS):
        assert np.array_equal(ttok.numpy(), np.asarray(jtok)), f"step {step}"
        jlog, jcache = decode(params, jtok, jcache)
        tlog, tcache = tmodel.decode_step(ttok, tcache, dtype=torch.float32)
        np.testing.assert_allclose(_np(tlog), _np(jlog), atol=1e-4, rtol=1e-4)
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ttok = tlog.argmax(-1)
    for kv in ("k", "v"):
        assert tcache["kv"][kv].shape[-1] == head_dim
        np.testing.assert_allclose(_np(tcache["kv"][kv]), _np(jcache["kv"][kv]),
                                   atol=1e-5, rtol=1e-5)
