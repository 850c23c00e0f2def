"""The port's Mamba-1 path against the reference's (``repro.models.ssm`` and
``TransformerLM`` on falcon-mamba's smoke config: 2 layers, d_model 128,
d_inner 256, ssm_state 16).

The reference runs its selective-scan Pallas kernel in interpret mode
(``impl="pallas"``) or its associative scan (``"jnp"``); the port runs its
kernel wrapper (the plain version on the CPU).  In float32 mixer outputs and
logits agree within 1e-4, SSM states within 1e-5 (the reference's scan
tolerance), and greedy decoding picks identical tokens.  One bfloat16 case
is held to the reference's own bf16 tolerance (``tests/test_models_smoke.py``):
0.02 + 0.004 * max |logit|.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.registry import build_model as t_build  # noqa: E402

ARCH = "falcon-mamba-7b"
B, STEPS = 2, 8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _mixer_params(cfg, seed=0):
    """Mixer parameters as numpy, with A_log, dt_bias, conv bias and D drawn
    too (the blueprint's zeros / ones would leave those paths untested)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in jssm.mamba1_blueprint(cfg).items():
        fan_in = int(np.prod(spec.shape[:-1])) if len(spec.shape) > 1 else 1
        out[name] = (rng.standard_normal(spec.shape) / np.sqrt(fan_in)
                     ).astype(np.float32)
    out["A_log"] = np.log(np.broadcast_to(
        np.arange(1, cfg.ssm_state + 1, dtype=np.float32),
        (cfg.d_inner, cfg.ssm_state))).copy()
    return out


def _both(params):
    return ({k: jnp.asarray(v) for k, v in params.items()},
            {k: torch.from_numpy(v) for k, v in params.items()})


# ---------------------------------------------------------------------------
# mixer level
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_prev", [False, True])
def test_causal_conv1d_matches_reference(with_prev):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 9, 32), dtype=np.float32)
    w = rng.standard_normal((4, 32), dtype=np.float32)
    bias = rng.standard_normal((32,), dtype=np.float32)
    prev = rng.standard_normal((B, 3, 32), dtype=np.float32) if with_prev else None
    jy, jprev = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(bias),
                                   None if prev is None else jnp.asarray(prev))
    ty, tprev = tssm.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(bias),
                                   None if prev is None else torch.from_numpy(prev))
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(_np(tprev), _np(jprev), atol=0, rtol=0)


# (S, chunk): one chunk; chunk > S; several chunks with a ragged tail
FULL_CASES = [(12, 256), (12, 16), (23, 8)]


@pytest.mark.parametrize("case", FULL_CASES)
@pytest.mark.parametrize("j_impl", ["pallas", "jnp"])
def test_mamba1_full_matches_reference(case, j_impl):
    S, chunk = case
    cfg = j_smoke(ARCH)
    jp, tp = _both(_mixer_params(cfg))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    state = {k: rng.standard_normal(s, dtype=np.float32)
             for k, s in jssm.mamba1_state_shapes(cfg, B).items()}
    jy, jst = jssm.mamba1_full(jp, cfg, jnp.asarray(x), chunk=chunk,
                               state={k: jnp.asarray(v) for k, v in state.items()},
                               impl=j_impl)
    before = ops.selective_scan.launches
    ty, tst = tssm.mamba1_full(tp, t_smoke(ARCH), torch.from_numpy(x),
                               chunk=chunk,
                               state={k: torch.from_numpy(v) for k, v in state.items()})
    assert ops.selective_scan.launches == before      # CPU: plain version
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-4, rtol=1e-4)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(_np(tst[k]), _np(jst[k]), atol=1e-5, rtol=1e-5)


def test_mamba1_full_plain_equals_kernel_path_and_zero_state():
    """``impl="plain"`` and ``"kernel"`` agree on the CPU, and no state is
    the zero state."""
    cfg = t_smoke(ARCH)
    _, tp = _both(_mixer_params(cfg, seed=3))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, 19, cfg.d_model), dtype=np.float32))
    zero = {k: torch.zeros(s) for k, s in tssm.mamba1_state_shapes(cfg, B).items()}
    got, got_st = tssm.mamba1_full(tp, cfg, x, chunk=8)
    want, want_st = tssm.mamba1_full(tp, cfg, x, chunk=8, state=zero, impl="plain")
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    torch.testing.assert_close(got_st["ssm"], want_st["ssm"], atol=0, rtol=0)
    with pytest.raises(ValueError, match="impl"):
        tssm.mamba1_full(tp, cfg, x, impl="pallas")


def test_mamba1_decode_matches_reference():
    cfg = j_smoke(ARCH)
    jp, tp = _both(_mixer_params(cfg, seed=5))
    rng = np.random.default_rng(6)
    jst = {k: jnp.asarray(rng.standard_normal(s, dtype=np.float32))
           for k, s in jssm.mamba1_state_shapes(cfg, B).items()}
    tst = {k: torch.from_numpy(np.array(v)) for k, v in jst.items()}
    for step in range(3):
        x = rng.standard_normal((B, 1, cfg.d_model), dtype=np.float32)
        jy, jst = jssm.mamba1_decode(jp, cfg, jnp.asarray(x), jst)
        ty, tst = tssm.mamba1_decode(tp, t_smoke(ARCH), torch.from_numpy(x), tst)
        np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-4, rtol=1e-4)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(_np(tst[k]), _np(jst[k]),
                                       atol=1e-5, rtol=1e-5, err_msg=f"step {step}")


# ---------------------------------------------------------------------------
# model level: falcon-mamba smoke
# ---------------------------------------------------------------------------


def _pair_models(ssm_chunk):
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    jmodel = j_build(jcfg, impl="pallas", ssm_chunk=ssm_chunk)
    params = jmodel.init(jax.random.PRNGKey(0))
    tmodel = t_build(tcfg, device="cpu", ssm_chunk=ssm_chunk)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), params)
    tmodel.load_state_dict(params_from_jax(tree))
    return jcfg, jmodel, params, tmodel


def _tokens(cfg, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _assert_states(tcache, jcache):
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(_np(tcache["ssm_state"][k]),
                                   _np(jcache["ssm_state"][k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


# (prompt length, ssm_chunk): one chunk; three chunks with a ragged tail
@pytest.mark.parametrize("case", [(12, 256), (21, 8)])
def test_prefill_decode_match_reference_f32(case):
    S, chunk = case
    jcfg, jmodel, params, tmodel = _pair_models(chunk)
    toks = _tokens(jcfg, S)
    prefill = jax.jit(functools.partial(jmodel.prefill, dtype=jnp.float32))
    decode = jax.jit(functools.partial(jmodel.decode_step, dtype=jnp.float32))

    jlog, jcache = prefill(params, jnp.asarray(toks),
                           jmodel.init_cache(B, S + STEPS, jnp.float32))
    tcache = tmodel.init_cache(B, S + STEPS, dtype=torch.float32)
    tlog, tcache = tmodel.prefill(torch.from_numpy(toks), tcache,
                                  dtype=torch.float32)
    np.testing.assert_allclose(_np(tlog), _np(jlog), atol=1e-4, rtol=1e-4)
    _assert_states(tcache, jcache)
    assert int(tcache["len"]) == int(jcache["len"]) == S

    jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
    ttok = tlog.argmax(-1)
    for step in range(STEPS):
        assert np.array_equal(ttok.numpy(), np.asarray(jtok)), f"step {step}"
        jlog, jcache = decode(params, jtok, jcache)
        tlog, tcache = tmodel.decode_step(ttok, tcache, dtype=torch.float32)
        np.testing.assert_allclose(_np(tlog), _np(jlog), atol=1e-4, rtol=1e-4)
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ttok = tlog.argmax(-1)
    _assert_states(tcache, jcache)
    assert int(tcache["len"]) == S + STEPS


def test_prefill_decode_match_reference_bf16():
    jcfg, jmodel, params, tmodel = _pair_models(8)
    toks = _tokens(jcfg, 13, seed=1)
    jlog, jcache = jmodel.prefill(params, jnp.asarray(toks),
                                  jmodel.init_cache(B, 24))
    tlog, tcache = tmodel.prefill(torch.from_numpy(toks), tmodel.init_cache(B, 24))
    assert tlog.dtype == torch.bfloat16
    assert tcache["ssm_state"]["ssm"].dtype == torch.float32
    for step in range(3):
        want = _np(jlog)
        tol = 0.02 + 0.004 * float(np.abs(want).max())
        assert float(np.abs(_np(tlog) - want).max()) <= tol, f"step {step}"
        # feed both the reference's token, so a bf16 near-tie cannot fork
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        jlog, jcache = jmodel.decode_step(params, jtok, jcache)
        tlog, tcache = tmodel.decode_step(torch.tensor(np.asarray(jtok)), tcache)


def test_forward_hidden_matches_reference():
    jcfg, jmodel, params, tmodel = _pair_models(8)
    toks = _tokens(jcfg, 17, seed=2)
    want, _ = jmodel.forward(params, jnp.asarray(toks), dtype=jnp.float32)
    got = tmodel(torch.from_numpy(toks), dtype=torch.float32)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)


def test_params_from_jax_carries_the_mixer_leaves():
    """``decoder/mixer/*`` (nested one level below the layer) arrive under
    ``layers.<i>.mixer.*``: the load is strict and every leaf is equal."""
    _, _, params, tmodel = _pair_models(256)
    sd = tmodel.state_dict()
    assert {k for k in sd if ".mixer." in k} == {
        f"layers.{i}.mixer.{n}" for i in range(2)
        for n in jssm.mamba1_blueprint(j_smoke(ARCH))}
    for name in ("in_proj", "A_log", "out_proj"):
        np.testing.assert_array_equal(
            sd[f"layers.1.mixer.{name}"].numpy(),
            np.asarray(params["decoder"]["mixer"][name][1], np.float32))


def test_init_cache_is_fp32_state_per_layer():
    tmodel = t_build(t_smoke(ARCH), device="cpu")
    cfg = tmodel.cfg
    cache = tmodel.init_cache(3, 64, dtype=torch.bfloat16)
    assert int(cache["len"]) == 0 and set(cache) == {"len", "ssm_state"}
    assert cache["len"].shape == () and cache["len"].dtype == torch.int32
    st = cache["ssm_state"]
    assert st["conv"].shape == (2, 3, cfg.ssm_conv - 1, cfg.d_inner)
    assert st["ssm"].shape == (2, 3, cfg.d_inner, cfg.ssm_state)
    assert st["conv"].dtype == st["ssm"].dtype == torch.float32
