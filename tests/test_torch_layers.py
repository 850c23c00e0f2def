"""The port's layers and attention module against the reference package's,
in float32 on the CPU, with the same numpy-made inputs and weights.

Layers match at 1e-5; attention (outputs and cache contents, prefill and
decode) at 2e-5, the reference's own kernel tolerance.  The reference runs
attention through its Pallas kernels in interpret mode (``impl="pallas"``),
the port through its kernel wrappers (``impl="kernel"``, which take the
plain versions for CPU tensors) and through the plain versions directly
(``impl="plain"``).  The model-level oracles ``naive_attention`` and
``decode_attention`` are held against the reference's separately.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

TOL_LAYERS = 1e-5
TOL_ATTN = 2e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rms_norm():
    rng = np.random.default_rng(0)
    jx, tx = _both(rng.standard_normal((2, 5, 64), dtype=np.float32) * 3)
    jw, tw = _both(rng.standard_normal(64, dtype=np.float32))
    _close(tlayers.rms_norm(tx, tw, 1e-5), jlayers.rms_norm(jx, jw, 1e-5),
           TOL_LAYERS)


@pytest.mark.parametrize("pos_shape", ["shared", "per_batch"])
def test_apply_rope(pos_shape):
    rng = np.random.default_rng(1)
    jx, tx = _both(rng.standard_normal((2, 9, 4, 32), dtype=np.float32))
    pos = np.arange(100, 109, dtype=np.int32)
    if pos_shape == "per_batch":
        pos = np.stack([pos, pos * 3])
    jp, tp = _both(pos)
    _close(tlayers.apply_rope(tx, tp, 500_000.0),
           jlayers.apply_rope(jx, jp, 500_000.0), TOL_LAYERS)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "paligemma-3b",
                                  "whisper-medium"])
def test_mlp_apply(arch):
    """SwiGLU (llama), GeGLU (paligemma) and the plain gelu MLP (whisper)."""
    cfg = j_smoke(arch)
    rng = np.random.default_rng(2)
    bp = jlayers.mlp_blueprint(cfg)
    w = {k: rng.standard_normal(s.shape, dtype=np.float32) * 0.1
         for k, s in bp.items()}
    jx, tx = _both(rng.standard_normal((2, 3, cfg.d_model), dtype=np.float32))
    got = tlayers.mlp_apply({k: torch.from_numpy(v) for k, v in w.items()},
                            t_smoke(arch), tx)
    want = jlayers.mlp_apply({k: jnp.asarray(v) for k, v in w.items()}, cfg, jx)
    _close(got, want, TOL_LAYERS)


@pytest.mark.parametrize("variant", ["tied_padded", "untied", "softcap"])
def test_logits_from_hidden(variant):
    cfg = j_smoke("llama3.2-1b")
    if variant == "tied_padded":
        cfg = dataclasses.replace(cfg, vocab_size=500)   # 12 padded entries
    elif variant == "untied":
        cfg = dataclasses.replace(cfg, tie_embeddings=False)
    else:
        cfg = dataclasses.replace(cfg, logit_softcap=30.0)
    rng = np.random.default_rng(3)
    jh, th = _both(rng.standard_normal((2, 4, cfg.d_model), dtype=np.float32))
    je, te = _both(rng.standard_normal((cfg.padded_vocab, cfg.d_model),
                                       dtype=np.float32))
    ju, tu = _both(rng.standard_normal((cfg.d_model, cfg.padded_vocab),
                                       dtype=np.float32))
    got = tlayers.logits_from_hidden(th, cfg, embedding=te, unembed=tu)
    want = jlayers.logits_from_hidden(jh, cfg, embedding=je, unembed=ju)
    _close(got, want, TOL_LAYERS)


def test_embed_tokens():
    rng = np.random.default_rng(4)
    je, te = _both(rng.standard_normal((64, 16), dtype=np.float32))
    toks = rng.integers(0, 64, size=(2, 7))
    got = tlayers.embed_tokens(te, torch.from_numpy(toks), torch.bfloat16)
    want = jlayers.embed_tokens(je, jnp.asarray(toks), jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    _close(got, want, 0.0)


# ---------------------------------------------------------------------------
# attention_apply
# ---------------------------------------------------------------------------

# (arch, kv heads override, prompt length, prefix length)
ATTN_MODULE_CASES = [
    ("llama3.2-1b", None, 24, 0),        # GQA 4:1 (smoke Kv=1)
    ("llama3.2-1b", 2, 24, 0),           # G=2, Kv=2
    ("qwen2.5-3b", None, 20, 0),         # qkv bias
    ("qwen3-moe-30b", None, 20, 0),      # qk norm
    ("h2o-danube3-4b", None, 80, 0),     # sliding window 64: ring cache
    ("paligemma-3b", None, 24, 8),       # prefix-LM
]


def _attn_weights(cfg, rng):
    bp = jattn.attention_blueprint(cfg)
    return {k: rng.standard_normal(s.shape, dtype=np.float32) * 0.1
            for k, s in bp.items()}


@pytest.mark.parametrize("case", ATTN_MODULE_CASES)
def test_attention_apply_prefill_then_decode(case):
    arch, kv, S, prefix = case
    jcfg, tcfg = j_smoke(arch), t_smoke(arch)
    if kv is not None:
        jcfg = dataclasses.replace(jcfg, num_kv_heads=kv)
        tcfg = dataclasses.replace(tcfg, num_kv_heads=kv)
    rng = np.random.default_rng(ATTN_MODULE_CASES.index(case))
    w = _attn_weights(jcfg, rng)
    jp = {k: jnp.asarray(v) for k, v in w.items()}
    tp = {k: torch.from_numpy(v) for k, v in w.items()}
    B, max_len = 2, S + 8
    slots = min(max_len, jcfg.sliding_window or max_len)
    cshape = (B, slots, jcfg.num_kv_heads, jcfg.resolved_head_dim)

    x = rng.standard_normal((B, S, jcfg.d_model), dtype=np.float32)
    jcache = {"k": jnp.zeros(cshape), "v": jnp.zeros(cshape)}
    want, jcache = jattn.attention_apply(
        jp, jcfg, jnp.asarray(x), positions=jnp.arange(S), mode="full",
        layer_cache=jcache, cache_len=jnp.asarray(0, jnp.int32),
        prefix_len=prefix, impl="pallas",
    )
    for impl in ("kernel", "plain"):
        tcache = {"k": torch.zeros(cshape), "v": torch.zeros(cshape)}
        got, tcache = tattn.attention_apply(
            tp, tcfg, torch.from_numpy(x), positions=torch.arange(S),
            mode="full", layer_cache=tcache, cache_len=0, prefix_len=prefix,
            impl=impl,
        )
        _close(got, want, TOL_ATTN)
        _close(tcache["k"], jcache["k"], TOL_ATTN)
        _close(tcache["v"], jcache["v"], TOL_ATTN)

        # two decode steps against the cache the prefill wrote
        jc = dict(jcache)
        for t in range(S, S + 2):
            x1 = np.random.default_rng(t).standard_normal(
                (B, 1, jcfg.d_model), dtype=np.float32)
            want1, jc = jattn.attention_apply(
                jp, jcfg, jnp.asarray(x1), positions=jnp.asarray([t]),
                mode="decode", layer_cache=jc,
                cache_len=jnp.asarray(t, jnp.int32), impl="pallas",
            )
            got1, tcache = tattn.attention_apply(
                tp, tcfg, torch.from_numpy(x1), positions=torch.tensor([t]),
                mode="decode", layer_cache=tcache, cache_len=t, impl=impl,
            )
            _close(got1, want1, TOL_ATTN)
            _close(tcache["k"], jc["k"], TOL_ATTN)
            _close(tcache["v"], jc["v"], TOL_ATTN)


def test_naive_attention_matches_reference_with_kv_valid():
    cfg = j_smoke("llama3.2-1b")
    rng = np.random.default_rng(7)
    B, S, H, Kv, D = 2, 16, 4, 2, 32
    jq, tq = _both(rng.standard_normal((B, S, H, D), dtype=np.float32))
    jk, tk = _both(rng.standard_normal((B, S, Kv, D), dtype=np.float32))
    jv, tv = _both(rng.standard_normal((B, S, Kv, D), dtype=np.float32))
    valid = rng.random((B, S)) < 0.8
    valid[:, 0] = True
    pos = np.arange(S)
    kw = dict(causal=True, window=cfg.sliding_window, prefix_len=3)
    got = tattn.naive_attention(tq, tk, tv, q_pos=torch.from_numpy(pos),
                                kv_pos=torch.from_numpy(pos),
                                kv_valid=torch.from_numpy(valid), **kw)
    want = jattn.naive_attention(jq, jk, jv, q_pos=jnp.asarray(pos),
                                 kv_pos=jnp.asarray(pos),
                                 kv_valid=jnp.asarray(valid), **kw)
    _close(got, want, TOL_ATTN)


def test_decode_refuses_a_full_cache():
    cfg = t_smoke("llama3.2-1b")
    w = _attn_weights(j_smoke("llama3.2-1b"), np.random.default_rng(8))
    tp = {k: torch.from_numpy(v) for k, v in w.items()}
    shape = (1, 4, cfg.num_kv_heads, cfg.resolved_head_dim)
    cache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    with pytest.raises(ValueError, match="cache full"):
        tattn.attention_apply(tp, cfg, torch.zeros(1, 1, cfg.d_model),
                              positions=torch.tensor([4]), mode="decode",
                              layer_cache=cache, cache_len=4)


def test_decode_attention_matches_reference():
    rng = np.random.default_rng(9)
    B, S, H, Kv, D = 2, 40, 8, 2, 32
    jq, tq = _both(rng.standard_normal((B, 1, H, D), dtype=np.float32))
    jk, tk = _both(rng.standard_normal((B, S, Kv, D), dtype=np.float32))
    jv, tv = _both(rng.standard_normal((B, S, Kv, D), dtype=np.float32))
    valid = rng.random((B, S)) < 0.6
    valid[:, 0] = True
    got = tattn.decode_attention(tq, tk, tv, kv_valid=torch.from_numpy(valid))
    want = jattn.decode_attention(jq, jk, jv, kv_valid=jnp.asarray(valid))
    _close(got, want, TOL_ATTN)
