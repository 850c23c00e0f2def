"""The port's attention kernels against the reference package's.

On the CPU the port's wrappers run their kernels' plain PyTorch versions;
these must match the Pallas kernels (run in interpret mode, as
``test_kernels.py`` runs them) and the reference's jnp oracles on every case
of ``test_kernels.py``, at its tolerances (2e-5 in float32, 2e-2 in
bfloat16).  The CUDA kernels themselves run only on the card:
``test_torch_cuda.py`` holds them against the plain versions there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_bhsd  # noqa: E402
from repro.kernels.flash_decode import flash_decode_bhd  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_kernels import ATTN_CASES, DECODE_CASES  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


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


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas_and_ref(case, dtype):
    B, H, Kv, Sq, Skv, D, causal, window, prefix = case
    tol = DTYPES[dtype][2]
    rng = np.random.default_rng(ATTN_CASES.index(case))
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


def test_cpu_path_counts_no_launch():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 64, 4, 64), dtype=np.float32))
    valid = torch.ones((1, 64), dtype=torch.bool)
    before = (ops.flash_attention.launches, ops.flash_decode.launches)
    ops.flash_attention(q, q, q)
    ops.flash_decode(q[:, :1], q, q, kv_valid=valid)
    assert (ops.flash_attention.launches, ops.flash_decode.launches) == before


def test_kernel_launch_refuses_cpu_tensors():
    """The launchers never run a plain version: a CPU tensor is refused
    before any build is attempted."""
    q = torch.zeros((1, 8, 4, 64))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.launch(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        tfd.launch(q[:, :1], q, q, torch.ones((1, 8), dtype=torch.bool))
    with pytest.raises(ValueError, match="head_dim"):
        tfa.launch(q[..., :32], q[..., :32], q[..., :32])


def test_wrappers_refuse_mixed_devices():
    q = torch.zeros((1, 8, 4, 64))
    with pytest.raises(ValueError, match="devices"):
        ops.flash_attention(q, q, q.to("meta"))


def test_decode_splits_fill_the_card():
    # llama3.2-1b at batch 1: 8 kv heads alone would leave 124 of 132 SMs idle
    s = tfd.num_splits(1, 8, 2048, 132)
    assert 8 * s >= 132 and -(-2048 // s) >= tfd.MIN_SPLIT
    assert tfd.num_splits(64, 8, 2048, 132) == 1
    assert tfd.num_splits(1, 8, 40, 132) == 2      # short cache: few splits


def test_build_names_libraries_by_source_hash():
    p = build.library_path("flash_attention")
    assert p.parent == build.BUILD_DIR and p.suffix == ".so"
    assert p != build.library_path("flash_decode")
    with pytest.raises(KeyError):
        build.build(["no_such_kernel"])
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_card_test_cases_are_the_reference_cases():
    """``test_torch_cuda.py`` runs on the card, where JAX is absent, so it
    keeps its own copy of the reference's kernel test cases."""
    import test_torch_cuda

    assert test_torch_cuda.ATTN_CASES == ATTN_CASES
    assert test_torch_cuda.DECODE_CASES == DECODE_CASES
