"""The port's kernels (attention, selective scan) against the reference
package's; the grouped matmul's are in ``test_torch_moe.py``.

On the CPU the port's wrappers run their kernels' plain PyTorch versions;
these must match the Pallas kernels (run in interpret mode, as
``test_kernels.py`` runs them) and the reference's jnp oracles on every case
of ``test_kernels.py``, at its tolerances (2e-5 in float32, 2e-2 in
bfloat16; 1e-5 for the scan).  The CUDA kernels themselves run only on the card:
``test_torch_cuda.py`` holds them against the plain versions there.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_bhsd  # noqa: E402
from repro.kernels.flash_decode import flash_decode_bhd  # noqa: E402
from repro.kernels.selective_scan import selective_scan_bqcn  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import moe_gmm as tgmm  # noqa: E402
from repro_torch.kernels import selective_scan as tss  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_kernels import (  # noqa: E402
    ATTN_CASES, DECODE_CASES, GMM_CASES, SCAN_CASES,
)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}

# the head widths of h2o-danube3-4b (120: H=32, Kv=8) and paligemma-3b (256:
# H=8, Kv=1), in the layout of ATTN_CASES, under the causal, sliding-window
# and prefix-LM masks, and bidirectional; test_torch_cuda.py holds the CUDA
# kernels to the same cases
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

# (B, H, Kv, S, D, mask: see _decode_mask) at the same widths: cache
# occupancy, and a sliding window's ring of live slots wrapping past the end
WIDE_DECODE_CASES = [
    (2, 32, 8, 256, 120, "prefix"),
    (2, 32, 8, 256, 120, "ring"),
    (2, 8, 1, 256, 256, "prefix"),
    (2, 8, 1, 256, 256, "ring"),
]

# Head widths and query-group sizes the served models do not use, from
# public models' attention: the smoke configs' 32, SigLIP-so400m's 72,
# phi-2's 80, Phi-3-mini's 96, 160, Nemotron-4-340B's 192 at G = 12,
# Llama-3.1-405B's G = 16, StarCoder's multi-query G = 48 and falcon-7b's
# G = 71, under the causal, sliding-window, prefix-LM and bidirectional
# masks (layout of ATTN_CASES); test_torch_cuda.py holds the CUDA kernels
# to the same cases
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

# the same widths and groups in decode (layout of WIDE_DECODE_CASES):
# cache occupancy, a ring, and no valid slot at all
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


def _pair(rng, shape, dtype_name):
    """The same values as a jnp array and a torch tensor (bf16 rounding of
    float32 is round-to-nearest-even in both)."""
    jdt, tdt, _ = DTYPES[dtype_name]
    x = rng.standard_normal(shape, dtype=np.float32)
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _check_attention(case, dtype, seed):
    """The port's wrapper on the CPU (its plain version) against the Pallas
    kernel in interpret mode and the reference's oracle, on the same
    seeded inputs."""
    B, H, Kv, Sq, Skv, D, causal, window, prefix = case
    tol = DTYPES[dtype][2]
    rng = np.random.default_rng(seed)
    jq, tq = _pair(rng, (B, H, Sq, D), dtype)
    jk, tk = _pair(rng, (B, Kv, Skv, D), dtype)
    jv, tv = _pair(rng, (B, Kv, Skv, D), dtype)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    pallas = flash_attention_bhsd(jq, jk, jv, block_q=64, block_kv=64,
                                  interpret=True, **kw)
    oracle = jref.flash_attention_ref(jq, jk, jv, **kw)
    # the port's wrapper in the model layout (B, S, heads, D), on the CPU
    got = ops.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                              tv.transpose(1, 2), **kw).transpose(1, 2)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol, rtol=tol)
    np.testing.assert_allclose(
        _np(tref.flash_attention_ref(tq, tk, tv, **kw)), _np(oracle),
        atol=tol, rtol=tol)


@pytest.mark.parametrize("case", ATTN_CASES + WIDE_ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas_and_ref(case, dtype):
    _check_attention(case, dtype, (ATTN_CASES + WIDE_ATTN_CASES).index(case))


@pytest.mark.parametrize("case", ANY_ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas_at_any_width_and_group(case, dtype):
    _check_attention(case, dtype, 300 + ANY_ATTN_CASES.index(case))


def _attention_with_p_in_bf16(q, k, v, *, causal, window, prefix_len):
    """Attention as the tensor-core kernel rounds it (test only): fp32
    scores of the bf16 inputs, P = exp(s - row max) rounded to bf16 before
    P.V (products summed in fp32), each row divided by the fp32 sum of the
    unrounded P.  q (B, H, Sq, D); k, v (B, Kv, Skv, D)."""
    B, H, Sq, D = q.shape
    Kv, Skv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Kv, H // Kv, Sq, D)
    s = torch.einsum("bkgqd,bkmd->bkgqm", qg, k.float()) / math.sqrt(D)
    qp, kp = torch.arange(Sq)[:, None], torch.arange(Skv)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        mask &= (qp >= kp) | (kp < prefix_len)
    if window is not None:
        mask &= qp - kp < window
    s = torch.where(mask, s, torch.tensor(tref.NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum("bkgqm,bkmd->bkgqd", p.to(torch.bfloat16).float(),
                       v.float()) / p.sum(-1, keepdim=True)
    return out.reshape(B, H, Sq, D).to(q.dtype)


def _check_p_in_bf16(case, seed):
    B, H, Kv, Sq, Skv, D, causal, window, prefix = case
    rng = np.random.default_rng(seed)
    jq, tq = _pair(rng, (B, H, Sq, D), "bfloat16")
    jk, tk = _pair(rng, (B, Kv, Skv, D), "bfloat16")
    jv, tv = _pair(rng, (B, Kv, Skv, D), "bfloat16")
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    pallas = flash_attention_bhsd(jq, jk, jv, block_q=64, block_kv=64,
                                  interpret=True, **kw)
    got = _attention_with_p_in_bf16(tq, tk, tv, **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(pallas), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("case", ATTN_CASES + WIDE_ATTN_CASES)
def test_bf16_rounding_of_p_stays_within_the_reference_tolerance(case):
    """The bf16 CUDA kernel rounds P to bf16 before P.V, where the Pallas
    kernel keeps it in fp32; with that rounding the result stays within the
    reference's bf16 tolerance (2e-2) of the Pallas kernel."""
    _check_p_in_bf16(case, (ATTN_CASES + WIDE_ATTN_CASES).index(case))


@pytest.mark.parametrize("case", ANY_ATTN_CASES)
def test_bf16_rounding_of_p_at_any_width_and_group(case):
    _check_p_in_bf16(case, 300 + ANY_ATTN_CASES.index(case))


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_matches_pallas_and_ref(case, dtype):
    B, H, Kv, S, D, n_valid = case
    tol = DTYPES[dtype][2]
    rng = np.random.default_rng(100 + DECODE_CASES.index(case))
    jq, tq = _pair(rng, (B, H, D), dtype)
    jk, tk = _pair(rng, (B, Kv, S, D), dtype)
    jv, tv = _pair(rng, (B, Kv, S, D), dtype)
    valid = np.broadcast_to(np.arange(S)[None, :] < n_valid, (B, S))
    valid = valid.astype(np.int8)
    pallas = flash_decode_bhd(jq, jk, jv, jnp.asarray(valid), block_kv=128,
                              interpret=True)
    oracle = jref.flash_decode_ref(jq, jk, jv, jnp.asarray(valid))
    got = ops.flash_decode(tq[:, None], tk.transpose(1, 2), tv.transpose(1, 2),
                           kv_valid=torch.from_numpy(valid))[:, 0]
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol, rtol=tol)


def _decode_mask(kind, B, S):
    """(B, S) int8 masks of the shapes flash_decode must honour: a prefix
    (cache occupancy), a ring (a sliding window's live slots wrapping past
    the end), one valid slot in the last tile, no valid slot at all, and an
    empty row beside a partial one."""
    pos = np.arange(S)[None, :].repeat(B, 0)
    if kind == "prefix":
        valid = pos < np.array([[137], [300]])[:B]
    elif kind == "ring":
        valid = (pos - (S - 100)) % S < 230
    elif kind == "last":
        valid = pos == S - 1
    elif kind == "none":
        valid = np.zeros((B, S), bool)
    elif kind == "empty beside partial":
        valid = pos < np.array([[0], [75]])[:B]
    else:
        raise ValueError(kind)
    return valid.astype(np.int8)


def _check_decode(case, dtype, seed):
    B, H, Kv, S, D, kind = case
    tol = DTYPES[dtype][2]
    rng = np.random.default_rng(seed)
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


@pytest.mark.parametrize("case", WIDE_DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_matches_pallas_and_ref_at_wide_heads(case, dtype):
    """Decode at head widths 120 and 256 (h2o-danube3-4b's and
    paligemma-3b's heads) under an occupancy mask and a ring."""
    _check_decode(case, dtype, 170 + WIDE_DECODE_CASES.index(case))


@pytest.mark.parametrize("case", ANY_DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_matches_pallas_at_any_width_and_group(case, dtype):
    """Decode at the widths and query groups of ANY_DECODE_CASES."""
    _check_decode(case, dtype, 400 + ANY_DECODE_CASES.index(case))


def _decode_over_listed_tiles(q, k, v, valid, splits, tile):
    """flash_decode's tile-skip rule in plain PyTorch (test only).  Per
    batch row, the tiles of ``tile`` slots that hold a valid slot (every
    tile when none does) are listed in order and divided among ``splits``
    blocks, whole tiles each; a block attends over its tiles' slots alone
    (masked slots score -1e30), and the blocks' (m, l, acc) are merged by
    log-sum-exp in block order, rows normalised by max(l, 1e-20).  q
    (B, H, D); k, v (B, Kv, S, D); valid (B, S).  fp32 throughout.  Returns
    the output and the number of slots attended per row."""
    B, H, D = q.shape
    Kv, S = k.shape[1], k.shape[2]
    n_tiles = -(-S // tile)
    out, attended = torch.empty(B, H, D), []
    for b in range(B):
        listed = [t for t in range(n_tiles)
                  if valid[b, t * tile:(t + 1) * tile].any()]
        listed = listed or list(range(n_tiles))
        per = -(-len(listed) // splits)
        qg = q[b].float().reshape(Kv, H // Kv, D)
        parts = []
        for r0 in range(0, len(listed), per):
            slots = torch.cat([torch.arange(t * tile, min(S, (t + 1) * tile))
                               for t in listed[r0:r0 + per]])
            sc = torch.einsum("kgd,kmd->kgm", qg, k[b][:, slots].float())
            sc = torch.where(valid[b, slots].bool(), sc / math.sqrt(D),
                             torch.tensor(tref.NEG_INF))
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            acc = torch.einsum("kgm,kmd->kgd", p, v[b][:, slots].float())
            parts.append((m, p.sum(-1), acc))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        l = sum(l * torch.exp(m - mx) for m, l, _ in parts)
        acc = sum(a * torch.exp(m - mx)[..., None] for m, _, a in parts)
        out[b] = (acc / l.clamp_min(1e-20)[..., None]).reshape(H, D)
        attended.append(sum(min(S, (t + 1) * tile) - t * tile for t in listed))
    return out.to(q.dtype), attended


@pytest.mark.parametrize("kind", ["prefix", "ring", "last", "none",
                                  "empty beside partial"])
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_tile_skip_matches_pallas_and_ref(kind, splits, dtype):
    """Attending over the 64-slot tiles that hold a valid slot (all of them
    in a row with none), split and merged as the CUDA kernel does, gives the
    reference's result.  S is a multiple of the Pallas block, so the
    reference pads no slot into the all-masked mean."""
    B, H, Kv, S, D = 2, 8, 2, 512, 64
    tol = DTYPES[dtype][2]
    rng = np.random.default_rng(150 + splits)
    jq, tq = _pair(rng, (B, H, D), dtype)
    jk, tk = _pair(rng, (B, Kv, S, D), dtype)
    jv, tv = _pair(rng, (B, Kv, S, D), dtype)
    valid = _decode_mask(kind, B, S)
    got, attended = _decode_over_listed_tiles(tq, tk, tv, torch.from_numpy(valid),
                                              splits, tfd.TILE)
    pallas = flash_decode_bhd(jq, jk, jv, jnp.asarray(valid), block_kv=128,
                              interpret=True)
    oracle = tref.flash_decode_ref(tq, tk, tv, torch.from_numpy(valid))
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol, rtol=tol)
    # the rule skips: only a row with no valid slot takes every tile
    for b in range(B):
        n_valid_tiles = int(np.any(valid[b].reshape(-1, tfd.TILE), 1).sum())
        assert attended[b] == tfd.TILE * (n_valid_tiles or S // tfd.TILE)


@pytest.mark.parametrize("kind", ["prefix", "ring", "last", "none",
                                  "empty beside partial"])
def test_flash_decode_tile_skip_at_head_width_256(kind):
    """paligemma-3b's decode heads (H=8, Kv=1, D=256, bf16) over the 64-slot
    tiles that hold a valid slot, divided among the splits ``num_splits``
    gives one batch row on 132 SMs, merged as the kernel does: the
    reference's result."""
    B, H, Kv, S, D = 2, 8, 1, 512, 256
    tol = DTYPES["bfloat16"][2]
    splits = tfd.num_splits(1, Kv, S, 132)
    assert splits == 8
    rng = np.random.default_rng(160)
    jq, tq = _pair(rng, (B, H, D), "bfloat16")
    jk, tk = _pair(rng, (B, Kv, S, D), "bfloat16")
    jv, tv = _pair(rng, (B, Kv, S, D), "bfloat16")
    valid = _decode_mask(kind, B, S)
    got, attended = _decode_over_listed_tiles(tq, tk, tv, torch.from_numpy(valid),
                                              splits, tfd.TILE)
    pallas = flash_decode_bhd(jq, jk, jv, jnp.asarray(valid), block_kv=128,
                              interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol, rtol=tol)
    for b in range(B):
        n_valid_tiles = int(np.any(valid[b].reshape(-1, tfd.TILE), 1).sum())
        assert attended[b] == tfd.TILE * (n_valid_tiles or S // tfd.TILE)


def _scan_inputs(rng, B, Q, C, N):
    """a in (0, 1) like exp(delta * A), b small, as ``test_kernels.py``."""
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, Q, C, N), dtype=np.float32)))
    b = 0.1 * rng.standard_normal((B, Q, C, N), dtype=np.float32)
    h0 = rng.standard_normal((B, C, N), dtype=np.float32)
    return a, b, h0


@pytest.mark.parametrize("case", SCAN_CASES)
def test_selective_scan_plain_matches_pallas_and_ref(case):
    B, Q, C, N = case
    a, b, h0 = _scan_inputs(np.random.default_rng(200 + SCAN_CASES.index(case)),
                            B, Q, C, N)
    ja, jb, jh0 = jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0)
    pallas = selective_scan_bqcn(ja, jb, jh0, block_c=64, interpret=True)
    oracle = jref.selective_scan_ref(ja, jb, jh0)
    ta, tb, th0 = torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(h0)
    got = ops.selective_scan(ta, tb, th0)
    assert got.dtype == torch.float32 and got.shape == (B, Q, C, N)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(tss.plain(ta, tb, th0)), _np(oracle),
                               atol=1e-5, rtol=1e-5)


def test_selective_scan_chunk_views_match_whole_scan():
    """Scanning chunk views of a (B, S, C, N) tensor, each from the last h
    of the one before (the way ``mamba1_full`` calls it), gives the scan of
    the whole sequence; the reference's associative form agrees."""
    a, b, h0 = _scan_inputs(np.random.default_rng(7), 2, 23, 16, 8)
    ta, tb, th0 = torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(h0)
    whole = ops.selective_scan(ta, tb, th0)
    h, parts = th0, []
    for c0 in range(0, 23, 8):
        hs = ops.selective_scan(ta[:, c0:c0 + 8], tb[:, c0:c0 + 8], h)
        parts.append(hs)
        h = hs[:, -1]
    torch.testing.assert_close(torch.cat(parts, dim=1), whole, atol=0, rtol=0)
    a_s, b_s = jax.lax.associative_scan(
        lambda l, r: (l[0] * r[0], l[1] * r[0] + r[1]),
        (jnp.asarray(a), jnp.asarray(b)), axis=1)
    assoc = b_s + a_s * jnp.asarray(h0)[:, None]
    np.testing.assert_allclose(_np(whole), _np(assoc), atol=1e-5, rtol=1e-5)


def test_cpu_path_counts_no_launch():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 64, 4, 64), dtype=np.float32))
    valid = torch.ones((1, 64), dtype=torch.bool)
    before = tuple(fn.launches for fn in ops.KERNEL_WRAPPERS)
    ops.flash_attention(q, q, q)
    ops.flash_decode(q[:, :1], q, q, kv_valid=valid)
    ops.selective_scan(q, q, q[:, 0])
    ops.moe_gmm(q[0], q[0].transpose(1, 2))
    ops.moe_ffn(q[0], q[0].transpose(1, 2), None, q[0])
    assert tuple(fn.launches for fn in ops.KERNEL_WRAPPERS) == before


def test_kernel_launch_refuses_cpu_tensors():
    """The launchers never run a plain version: a CPU tensor is refused
    before any build is attempted, at every head width the reference's
    kernels take; a width below 1 is refused by rule."""
    q = torch.zeros((1, 8, 4, 64))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.launch(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        tfd.launch(q[:, :1], q, q, torch.ones((1, 8), dtype=torch.bool))
    # past 256, and not a multiple of 8: taken (the reference's BlockSpecs
    # carry D whole), so refused only for the device; the meta route counts
    for D in (264, 36):
        x = torch.zeros((1, 8, 4, D))
        with pytest.raises(ValueError, match="CUDA"):
            tfa.launch(x, x, x)
        with pytest.raises(ValueError, match="CUDA"):
            tfd.launch(x[:, :1], x, x, torch.ones((1, 8), dtype=torch.bool))
        m = x.to("meta")
        assert ops.flash_attention(m, m, m).shape == x.shape
        assert tfa.supports(D)
    x = torch.zeros((1, 8, 4, 0))
    with pytest.raises(ValueError, match="head_dim 0"):
        tfa.launch(x, x, x)
    with pytest.raises(ValueError, match="head_dim 0"):
        tfd.launch(x[:, :1], x, x, torch.ones((1, 8), dtype=torch.bool))
    with pytest.raises(ValueError, match="head_dim 0"):
        ops.flash_attention(x.to("meta"), x.to("meta"), x.to("meta"))
    assert not tfa.supports(0)
    assert all(tfa.supports(D) for D in range(1, 1025))
    with pytest.raises(ValueError, match="CUDA"):
        tss.launch(q, q, q[:, 0])
    with pytest.raises(ValueError, match="h0"):
        tss.launch(q, q, q)
    with pytest.raises(TypeError):
        tss.launch(q.half(), q.half(), q[:, 0])
    with pytest.raises(ValueError, match="unit stride"):
        tss.launch(q.transpose(2, 3), q.transpose(2, 3), q[:, 0].transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA"):
        tgmm.launch(q[0], q[0].transpose(1, 2).contiguous())


def test_wrappers_refuse_mixed_devices():
    q = torch.zeros((1, 8, 4, 64))
    with pytest.raises(ValueError, match="devices"):
        ops.flash_attention(q, q, q.to("meta"))


def test_decode_splits_fill_the_card():
    # llama3.2-1b at batch 1: 8 kv heads alone would leave 124 of 132 SMs idle
    s = tfd.num_splits(1, 8, 2048, 132)
    assert 8 * s >= 132 and s <= 2048 // tfd.TILE   # whole tiles per split
    assert tfd.num_splits(64, 8, 2048, 132) == 1
    assert tfd.num_splits(1, 8, 40, 132) == 1      # short cache: one tile
    assert tfd.num_splits(1, 8, 100, 132) == 2     # two tiles, two splits


def test_head_width_256_card_cases_are_checked_by_chip_smoke():
    """The card tests of paligemma-3b's head width (the warp-specialised
    prefill, the unpadded decode) are ``chip_smoke.py``'s D = 256 checks,
    case for case, at the same log-sum-exp tolerance."""
    import importlib.util
    from pathlib import Path

    import test_torch_cuda

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.PALI_FA_CASES == test_torch_cuda.PALI_ATTN_CASES
    assert smoke.PALI_FD_CASES == test_torch_cuda.PALI_DECODE_CASES
    assert smoke.PALI_LSE_RTOL == test_torch_cuda.LSE_RTOL_F32
    assert smoke.PALI_D == test_torch_cuda.PALI_D == 256


def test_decode_splits_at_head_width_256():
    """paligemma-3b's one kv head at batch 1 over 2,048 slots: 32 splits,
    and 600 valid slots list 10 tiles, one block each; a split never holds
    a part of a tile."""
    splits = tfd.num_splits(1, 1, 2048, 132)
    assert splits == 2048 // tfd.TILE == 32
    listed = -(-600 // tfd.TILE)
    per = -(-listed // splits)
    assert per == 1 and listed == 10


@pytest.mark.parametrize("dtype,D,S,want", [
    # bf16 at 256: two stages of a K and a V tile (32 KiB each), the
    # bitmap's word and 32 list entries
    (torch.bfloat16, 256, 2048, 2 * 2 * 64 * 256 * 2 + 4 * (1 + 32)),
    (torch.bfloat16, 256, 32768, 2 * 2 * 64 * 256 * 2 + 4 * (16 + 512)),
    # bf16 at 112 and 120: rows padded to 128 elements
    (torch.bfloat16, 112, 2048, 2 * 2 * 64 * 128 * 2 + 4 * (1 + 32)),
    (torch.bfloat16, 64, 1000, 2 * 2 * 64 * 64 * 2 + 4 * (1 + 16)),
    # the width classes: rows padded to 64 (D = 8, 32), 192 (160, 192)
    (torch.bfloat16, 8, 2048, 2 * 2 * 64 * 64 * 2 + 4 * (1 + 32)),
    (torch.bfloat16, 160, 2048, 2 * 2 * 64 * 192 * 2 + 4 * (1 + 32)),
    (torch.bfloat16, 200, 2048, 2 * 2 * 64 * 256 * 2 + 4 * (1 + 32)),
    # fp32 rows wider than 128 take one stage; narrower ones two
    (torch.float32, 136, 2048, 2 * 64 * 136 * 4 + 4 * (1 + 32)),
    (torch.float32, 8, 2048, 2 * 2 * 64 * 8 * 4 + 4 * (1 + 32)),
    # fp32 at 256: two stages would pass 160 KiB, so one
    (torch.float32, 256, 2048, 2 * 64 * 256 * 4 + 4 * (1 + 32)),
    (torch.float32, 120, 2048, 2 * 2 * 64 * 120 * 4 + 4 * (1 + 32)),
])
def test_decode_shared_memory_the_wrapper_asks_for(dtype, D, S, want):
    assert tfd.smem_bytes(dtype, D, S) == want <= 200 * 1024


@pytest.mark.parametrize("dtype,D,want", [
    # bf16 at 256, the warp-specialised kernel: the Q tile and three stages
    # of K and V, 64 x 256 each, and 7 mbarriers: 224 KiB and 56 bytes
    (torch.bfloat16, 256, 2 * 64 * 256 * 7 + 8 * 7),
    # bf16 up to 128: a Q tile and three stages at the tile width
    (torch.bfloat16, 128, 2 * 64 * 128 * 7),
    (torch.bfloat16, 120, 2 * 64 * 128 * 7),
    (torch.bfloat16, 112, 2 * 64 * 128 * 7),
    (torch.bfloat16, 64, 2 * 64 * 64 * 7),
    # the width classes: 64 (D = 8 .. 64), 128 (72 .. 128), then the
    # warp-specialised kernel's 192 (136 .. 192) and 256 (200 .. 256)
    (torch.bfloat16, 8, 2 * 64 * 64 * 7),
    (torch.bfloat16, 72, 2 * 64 * 128 * 7),
    (torch.bfloat16, 136, 2 * 64 * 192 * 7 + 8 * 7),
    (torch.bfloat16, 192, 2 * 64 * 192 * 7 + 8 * 7),
    (torch.bfloat16, 200, 2 * 64 * 256 * 7 + 8 * 7),
    (torch.float32, 256, 4 * (64 * 257 * 2 + 64 * 256 + 64 * 65)),
    (torch.float32, 72, 4 * (64 * 73 * 2 + 64 * 72 + 64 * 65)),
    (torch.float32, 64, 4 * (64 * 65 * 2 + 64 * 64 + 64 * 65)),
])
def test_prefill_shared_memory_the_wrapper_asks_for(dtype, D, want):
    """What the launch asks for (the kernel refuses a number that is not its
    own), within the 227 KiB a block may use."""
    assert tfa.smem_bytes(dtype, D) == want <= 232_448


@pytest.mark.parametrize("dtype,D,G,want", [
    # the served widths' own kernels hold 8 heads (qwen3-moe-30b's G = 8)
    (torch.bfloat16, 128, 8, 8),
    (torch.bfloat16, 64, 4, 8),
    (torch.bfloat16, 256, 8, 8),
    # their width classes past G = 8, and the other widths: the 16 rows
    # of the products, up to 192; 8 heads on the columns past it; fp32 8
    (torch.bfloat16, 128, 16, 16),
    (torch.bfloat16, 64, 71, 16),
    (torch.bfloat16, 192, 12, 16),
    (torch.bfloat16, 80, 1, 16),
    (torch.bfloat16, 256, 16, 8),
    (torch.bfloat16, 200, 2, 8),
    (torch.float32, 128, 48, 8),
    (torch.float32, 72, 1, 8),
])
def test_decode_group_tile(dtype, D, G, want):
    assert tfd.group_tile(dtype, D, G) == want


def test_decode_merge_weights_fit_the_shared_memory_asked_for():
    """The last block's per-split weights and sums (2 x group x splits
    floats) reuse the K/V ring, and the launch asks for more where they
    pass it: fp32 at D = 8 over 32,768 slots, 264 splits (one kv head on
    132 SMs, two blocks each) of 8 heads."""
    S, splits = 32768, tfd.num_splits(1, 1, 32768, 132)
    assert splits == 264
    ring = 2 * 2 * 64 * 8 * 4
    want = 8 * 8 * splits + 4 * (16 + 512)
    assert 8 * 8 * splits > ring
    assert tfd.smem_bytes(torch.float32, 8, S, 8, splits) == want
    # the served shapes: the ring, as before
    assert (tfd.smem_bytes(torch.bfloat16, 64, 2048, 8, 33)
            == tfd.smem_bytes(torch.bfloat16, 64, 2048))


def test_build_names_libraries_by_source_hash(tmp_path, monkeypatch):
    p = build.library_path("flash_attention")
    assert p.parent == build.BUILD_DIR and p.suffix == ".so"
    assert p != build.library_path("flash_decode")
    assert "selective_scan" in build.KERNELS and "moe_gmm" in build.KERNELS
    assert sorted(p.stem for p in build.CSRC.glob("*.cu")) == sorted(build.KERNELS)
    with pytest.raises(KeyError):
        build.build(["no_such_kernel"])
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    # the shared tensor-core header is part of its includers' names
    header = build.CSRC / "mma_sm90.cuh"
    for name in ("flash_attention", "flash_decode", "moe_gmm"):
        assert header in build.sources(name)
    assert build.sources("selective_scan") == [build.CSRC / "selective_scan.cu"]
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {n: build.library_path(n) for n in build.KERNELS}
    assert before == {n: build.library_path(n) for n in build.KERNELS}
    (csrc / "mma_sm90.cuh").write_text(header.read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in build.KERNELS}
    assert {n for n in build.KERNELS if after[n] != before[n]} == {
        "flash_attention", "flash_decode", "moe_gmm"}


def test_card_test_cases_are_the_reference_cases():
    """``test_torch_cuda.py`` runs on the card, where JAX is absent, so it
    keeps its own copy of the reference's kernel test cases and of this
    file's cases at the wide head widths."""
    import test_torch_cuda

    assert test_torch_cuda.ATTN_CASES == ATTN_CASES
    assert test_torch_cuda.DECODE_CASES == DECODE_CASES
    assert test_torch_cuda.WIDE_ATTN_CASES == WIDE_ATTN_CASES
    assert test_torch_cuda.WIDE_DECODE_CASES == WIDE_DECODE_CASES
    assert test_torch_cuda.ANY_ATTN_CASES == ANY_ATTN_CASES
    assert test_torch_cuda.ANY_DECODE_CASES == ANY_DECODE_CASES
    assert test_torch_cuda.SCAN_CASES == SCAN_CASES
    assert test_torch_cuda.GMM_CASES == GMM_CASES


def test_card_only_cases_are_checked_by_chip_smoke():
    """The card-only cases (the tensor-core kernels at qwen3-moe-30b's
    shapes and at public models' attention shapes, flash_decode's tile
    skipping, the grouped matmul with rows) are also among
    ``chip_smoke.py``'s checks, run on every chip run."""
    import importlib.util
    from pathlib import Path

    import test_torch_cuda

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    fa = {(B, H, Kv, S, S, D, causal, window, prefix)
          for dt, B, H, Kv, S, D, causal, window, prefix in smoke.FA_CASES
          if dt == torch.bfloat16}
    assert set(test_torch_cuda.QWEN_ATTN_CASES) <= fa
    assert set(test_torch_cuda.PUBLIC_ATTN_CASES) <= fa
    assert len(test_torch_cuda.PUBLIC_ATTN_CASES) == len(smoke.PUBLIC_SHAPES)
    gmm = {(E, C, D, F, layout)
           for _, dt, E, C, D, F, layout in smoke.GMM_CASES
           if dt == torch.bfloat16}
    assert set(test_torch_cuda.QWEN_GMM_CASES) <= gmm
    assert set(test_torch_cuda.CARD_ROWS_GMM_CASES) <= gmm
    fd = {(B, H, Kv, S, D, mask)
          for dt, B, H, Kv, S, D, mask in smoke.FD_CASES if dt == torch.bfloat16}
    assert set(test_torch_cuda.CARD_DECODE_CASES) <= fd
