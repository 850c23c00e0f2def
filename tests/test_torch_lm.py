"""The port's TransformerLM against the reference's, with the reference's
weights carried over by ``params_from_jax``.

In float32 the reference runs its Pallas kernels in interpret mode
(``impl="pallas"``) and the port its kernel wrappers (plain versions on the
CPU): prefill logits agree within 1e-4, caches within 1e-5, and greedy
decoding picks identical tokens for 8 steps.  One bfloat16 case is held to
the reference's own bf16 prefill/decode tolerance
(``tests/test_models_smoke.py``): 0.02 + 0.004 * max |logit|.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import param_count as j_param_count  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.base import param_count  # noqa: E402
from repro_torch.models.lm import lm_blueprint  # noqa: E402
from repro_torch.models.registry import build_model as t_build  # noqa: E402

B, S, MAX_LEN, STEPS = 2, 12, 24, 8


def _pair_models(variant):
    arch = "paligemma-3b" if variant == "prefix" else "llama3.2-1b"
    jcfg, tcfg = j_smoke(arch), t_smoke(arch)
    if variant == "kv2":
        jcfg = dataclasses.replace(jcfg, num_kv_heads=2)
        tcfg = dataclasses.replace(tcfg, num_kv_heads=2)
    jmodel = j_build(jcfg, impl="pallas")
    params = jmodel.init(jax.random.PRNGKey(0))
    tmodel = t_build(tcfg, device="cpu")
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), params)
    tmodel.load_state_dict(params_from_jax(tree))
    return jcfg, jmodel, params, tmodel


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("variant", ["smoke", "kv2", "prefix"])
def test_prefill_decode_match_reference_f32(variant):
    """Smoke llama3.2-1b (G=4, Kv=1), a Kv=2 variant (G=2, Kv>1), and smoke
    paligemma-3b with a prefix embedding (prefix-LM mask, GeGLU)."""
    jcfg, jmodel, params, tmodel = _pair_models(variant)
    toks = _tokens(jcfg)
    n_pre = jcfg.frontend_seq if variant == "prefix" else 0
    front = np.random.default_rng(9).standard_normal(
        (B, n_pre, jcfg.d_model), dtype=np.float32)
    jfront = jnp.asarray(front) if n_pre else None
    tfront = torch.from_numpy(front) if n_pre else None
    max_len = MAX_LEN + n_pre
    prefill = jax.jit(functools.partial(jmodel.prefill, dtype=jnp.float32))
    decode = jax.jit(functools.partial(jmodel.decode_step, dtype=jnp.float32))

    jlog, jcache = prefill(params, jnp.asarray(toks),
                           jmodel.init_cache(B, max_len, jnp.float32),
                           prefix_embed=jfront)
    tcache = tmodel.init_cache(B, max_len, dtype=torch.float32)
    tlog, tcache = tmodel.prefill(torch.from_numpy(toks), tcache,
                                  prefix_embed=tfront, dtype=torch.float32)
    np.testing.assert_allclose(_np(tlog), _np(jlog), atol=1e-4, rtol=1e-4)
    for kv in ("k", "v"):
        np.testing.assert_allclose(_np(tcache["kv"][kv]), _np(jcache["kv"][kv]),
                                   atol=1e-5, rtol=1e-5)
    assert int(tcache["len"]) == int(jcache["len"]) == S + n_pre

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
        np.testing.assert_allclose(_np(tcache["kv"][kv]), _np(jcache["kv"][kv]),
                                   atol=1e-5, rtol=1e-5)


def test_prefill_decode_match_reference_bf16():
    jcfg, jmodel, params, tmodel = _pair_models("kv2")
    toks = _tokens(jcfg, seed=1)
    jlog, jcache = jmodel.prefill(params, jnp.asarray(toks),
                                  jmodel.init_cache(B, MAX_LEN))
    tlog, tcache = tmodel.prefill(torch.from_numpy(toks),
                                  tmodel.init_cache(B, MAX_LEN))
    assert tlog.dtype == torch.bfloat16
    for step in range(3):
        want = _np(jlog)
        tol = 0.02 + 0.004 * float(np.abs(want).max())
        assert float(np.abs(_np(tlog) - want).max()) <= tol, f"step {step}"
        # feed both the reference's token, so a bf16 near-tie cannot fork
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        jlog, jcache = jmodel.decode_step(params, jtok, jcache)
        tlog, tcache = tmodel.decode_step(torch.tensor(np.asarray(jtok)),
                                          tcache)


def test_forward_hidden_matches_reference():
    jcfg, jmodel, params, tmodel = _pair_models("kv2")
    toks = _tokens(jcfg, seed=2)
    want, _ = jmodel.forward(params, jnp.asarray(toks), dtype=jnp.float32)
    got = tmodel(torch.from_numpy(toks), dtype=torch.float32)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)


def test_impl_plain_matches_impl_kernel_on_cpu():
    _, _, _, tmodel = _pair_models("smoke")
    toks = torch.from_numpy(_tokens(tmodel.cfg, seed=3))
    got = tmodel.prefill(toks, tmodel.init_cache(B, MAX_LEN, torch.float32),
                         dtype=torch.float32)[0]
    tmodel.impl = "plain"
    want = tmodel.prefill(toks, tmodel.init_cache(B, MAX_LEN, torch.float32),
                          dtype=torch.float32)[0]
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2.5-3b", "command-r-35b",
                                  "h2o-danube3-4b", "paligemma-3b",
                                  "falcon-mamba-7b", "phi3.5-moe-42b",
                                  "qwen3-moe-30b", "zamba2-7b"])
def test_param_count_matches_reference(arch):
    """Blueprint counts only: nothing is allocated at full width."""
    assert param_count(lm_blueprint(t_config(arch))) == j_param_count(
        j_build(j_config(arch)).blueprint())


def test_llama_3_2_1b_full_width_count():
    assert param_count(lm_blueprint(t_config("llama3.2-1b"))) == 1_235_814_400


def test_falcon_mamba_7b_full_width_count():
    assert param_count(lm_blueprint(t_config("falcon-mamba-7b"))) == 7_272_665_088


def test_qwen3_moe_30b_full_width_count():
    assert param_count(lm_blueprint(t_config("qwen3-moe-30b"))) == 30_532_646_912


def test_encdec_smoke_builds_on_cpu():
    """The encoder-decoder family is ported: whisper-medium's smoke config
    builds an ``EncDecLM`` on the CPU and prefills to finite logits."""
    from repro_torch.models.whisper import EncDecLM, encdec_blueprint

    cfg = t_smoke("whisper-medium")
    assert cfg.name.removesuffix("-smoke") in ARCH_IDS
    model = t_build(cfg, device="cpu")
    assert isinstance(model, EncDecLM)
    assert model.num_params() == param_count(encdec_blueprint(cfg))
    cache = model.init_cache(1, 16, dtype=torch.float32)
    frames = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, cfg.frontend_seq, cfg.d_model), dtype=np.float32))
    logits, _ = model.prefill(frames, torch.arange(5)[None], cache,
                              dtype=torch.float32)
    assert logits.shape == (1, 1, cfg.padded_vocab)
    assert bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())


def test_hybrid_smoke_builds_on_cpu():
    """The hybrid family is ported: zamba2-7b's smoke config (one
    super-block, no prelude) and a 14-layer one (two prelude layers, two
    super-blocks) build on the CPU and prefill to finite logits."""
    for cfg in (t_smoke("zamba2-7b"),
                t_config("zamba2-7b").scaled(num_layers=14)):
        model = t_build(cfg, device="cpu")
        assert len(model.prelude) == cfg.hybrid_prelude
        assert len(model.blocks) == cfg.hybrid_blocks >= 1
        assert model.num_params() == param_count(lm_blueprint(cfg))
        cache = model.init_cache(1, 16, dtype=torch.float32)
        logits, _ = model.prefill(torch.arange(5)[None], cache,
                                  dtype=torch.float32)
        assert logits.shape == (1, 1, cfg.padded_vocab)
        assert bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())


def test_falcon_mamba_smoke_builds_and_serves_on_cpu():
    """The SSM family is ported: its smoke model serves the fleet across
    the preemption, one prefill length recorded per prefill, and on the CPU
    no kernel is launched."""
    from repro_torch.kernels import ops
    from repro_torch.serving.live import make_prompts, serve_fleet

    cfg = t_smoke("falcon-mamba-7b")
    model = t_build(cfg, device="cpu", ssm_chunk=4)
    prompts = make_prompts(cfg, n=4, min_len=3, max_len=11, seed=2, device="cpu")
    ops.reset_launch_counts()
    res = serve_fleet(model, prompts, replicas=2, out_tokens=5, kill_step=2,
                      dtype=torch.float32, log=lambda s: None)
    assert sorted(res.completed) == sorted(prompts)
    assert all(len(t) == 6 for t in res.completed.values())
    assert res.retried and res.prefills == len(prompts) + len(res.retried)
    assert sorted(res.prefill_lens) == sorted(
        [len(p) for p in prompts.values()]
        + [len(prompts[r]) for r in res.retried])
    assert all(fn.launches == 0 for fn in ops.KERNEL_WRAPPERS)


def test_init_is_seeded():
    cfg = t_smoke("llama3.2-1b")
    a = t_build(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    b = t_build(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    for (na, pa), (nb, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert na == nb and torch.equal(pa, pb)
    wq = a.layers[0].attn.wq
    assert wq.shape == (cfg.d_model, cfg.num_heads, cfg.resolved_head_dim)
    # truncated normal at fan-in scale: |w| <= 2 / sqrt(d_model)
    assert float(wq.abs().max()) <= 2.0 / cfg.d_model ** 0.5 + 1e-6
