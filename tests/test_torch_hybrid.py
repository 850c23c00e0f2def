"""The port's Mamba-2/SSD mixer and zamba2's hybrid stack against the
reference's (``repro.models.ssm`` and ``TransformerLM``), and the two
attention kernels' plain versions at zamba2's head width, 112.

The hybrid smoke config is zamba2-7b scaled to 14 layers: 2 prelude Mamba-2
layers and 2 super-blocks of (shared attention + 5 Mamba-2 layers), d_model
128, 8 SSM heads of 32, state 16, attention 4 heads of 32.  Weights are the
reference's ``init_params``, carried across by ``params_from_jax``.  In
float32 mixer outputs, prefill logits and caches agree within 1e-4 and
greedy decoding picks identical tokens; the reference runs its attention
Pallas kernels in interpret mode, the port its wrappers (plain versions on
the CPU).  The plain kernels at D = 112 are held to the Pallas kernels in
interpret mode at the reference's tolerances (2e-5 in float32, 2e-2 in
bfloat16).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_bhsd  # noqa: E402
from repro.kernels.flash_decode import flash_decode_bhd  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import param_count as j_param_count  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.base import param_count  # noqa: E402
from repro_torch.models.lm import lm_blueprint  # noqa: E402
from repro_torch.models.registry import build_model as t_build  # noqa: E402

ARCH = "zamba2-7b"
LAYERS = 14                   # 2 prelude layers + 2 super-blocks
B, STEPS = 2, 16
TOL = 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _cfgs():
    return (j_config(ARCH).scaled(num_layers=LAYERS),
            t_config(ARCH).scaled(num_layers=LAYERS))


def _mixer_params(cfg, seed=0):
    """Mixer parameters as numpy, with A_log, dt_bias, conv bias, D and the
    norm drawn too (the blueprint's zeros / ones would leave those paths
    untested)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in jssm.mamba2_blueprint(cfg).items():
        fan_in = int(np.prod(spec.shape[:-1])) if len(spec.shape) > 1 else 1
        out[name] = (rng.standard_normal(spec.shape) / np.sqrt(fan_in)
                     ).astype(np.float32)
    H = cfg.ssm_heads
    out["A_log"] = np.log(np.linspace(1.0, 8.0, H, dtype=np.float32))
    out["dt_bias"] = rng.uniform(-3.0, -1.0, H).astype(np.float32)
    out["norm"] = (1.0 + 0.1 * rng.standard_normal(cfg.d_inner)).astype(np.float32)
    return out


def _both(params):
    return ({k: jnp.asarray(v) for k, v in params.items()},
            {k: torch.from_numpy(v) for k, v in params.items()})


def _states(cfg, rng):
    return {k: rng.standard_normal(s, dtype=np.float32)
            for k, s in jssm.mamba2_state_shapes(cfg, B).items()}


# ---------------------------------------------------------------------------
# mixer level
# ---------------------------------------------------------------------------

# (S, chunk, carried state): S a multiple of the chunk; S not a multiple (the
# reference pads the last chunk, the port runs it at its true length); one
# chunk longer than S; each from zeros or from a carried state
FULL_CASES = [(16, 8, False), (16, 8, True), (21, 8, False), (21, 8, True),
              (12, 256, True)]


@pytest.mark.parametrize("case", FULL_CASES)
def test_mamba2_full_matches_reference(case):
    S, chunk, carried = case
    jcfg, tcfg = _cfgs()
    jp, tp = _both(_mixer_params(jcfg))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, jcfg.d_model), dtype=np.float32)
    state = _states(jcfg, rng) if carried else None
    jy, jst = jssm.mamba2_full(
        jp, jcfg, jnp.asarray(x), chunk=chunk,
        state=None if state is None else {k: jnp.asarray(v) for k, v in state.items()})
    ty, tst = tssm.mamba2_full(
        tp, tcfg, torch.from_numpy(x), chunk=chunk,
        state=None if state is None else {k: torch.from_numpy(v) for k, v in state.items()})
    assert ty.shape == (B, S, tcfg.d_model)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=TOL, rtol=TOL)
    for k in ("conv", "ssm"):
        assert tuple(tst[k].shape) == tuple(jst[k].shape), k
        np.testing.assert_allclose(_np(tst[k]), _np(jst[k]), atol=TOL, rtol=TOL,
                                   err_msg=k)


def test_mamba2_ragged_last_chunk_equals_one_chunk():
    """The last chunk run at its true length gives what one chunk over the
    whole sequence gives: the chunking changes no output and no state."""
    _, tcfg = _cfgs()
    _, tp = _both(_mixer_params(tcfg, seed=3))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, 23, tcfg.d_model), dtype=np.float32))
    got, got_st = tssm.mamba2_full(tp, tcfg, x, chunk=8)
    want, want_st = tssm.mamba2_full(tp, tcfg, x, chunk=23)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    torch.testing.assert_close(got_st["ssm"], want_st["ssm"], atol=TOL, rtol=TOL)
    torch.testing.assert_close(got_st["conv"], want_st["conv"], atol=0, rtol=0)
    with pytest.raises(ValueError, match="chunk"):
        tssm.mamba2_full(tp, tcfg, x, chunk=0)


def test_mamba2_decode_matches_reference_and_full():
    """Eight decode steps from a carried state against the reference's, and
    against one ``mamba2_full`` over the same eight tokens from that state."""
    jcfg, tcfg = _cfgs()
    jp, tp = _both(_mixer_params(jcfg, seed=5))
    rng = np.random.default_rng(6)
    start = _states(jcfg, rng)
    xs = rng.standard_normal((B, 8, jcfg.d_model), dtype=np.float32)
    jst = {k: jnp.asarray(v) for k, v in start.items()}
    tst = {k: torch.from_numpy(v) for k, v in start.items()}
    ys = []
    for step in range(8):
        x = xs[:, step:step + 1]
        jy, jst = jssm.mamba2_decode(jp, jcfg, jnp.asarray(x), jst)
        ty, tst = tssm.mamba2_decode(tp, tcfg, torch.from_numpy(x), tst)
        np.testing.assert_allclose(_np(ty), _np(jy), atol=TOL, rtol=TOL,
                                   err_msg=f"step {step}")
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(_np(tst[k]), _np(jst[k]), atol=TOL,
                                       rtol=TOL, err_msg=f"{k} step {step}")
        ys.append(ty)
    full, full_st = tssm.mamba2_full(
        tp, tcfg, torch.from_numpy(xs), chunk=4,
        state={k: torch.from_numpy(v) for k, v in start.items()})
    torch.testing.assert_close(torch.cat(ys, 1), full, atol=TOL, rtol=TOL)
    for k in ("conv", "ssm"):
        torch.testing.assert_close(tst[k], full_st[k], atol=TOL, rtol=TOL)


def test_mamba2_state_shapes_match_reference():
    jcfg, tcfg = _cfgs()
    assert tssm.mamba2_state_shapes(tcfg, 3) == jssm.mamba2_state_shapes(jcfg, 3)
    assert tssm.mamba2_blueprint(tcfg).keys() == jssm.mamba2_blueprint(jcfg).keys()


# ---------------------------------------------------------------------------
# model level: the hybrid smoke config
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _pair_models():
    jcfg, tcfg = _cfgs()
    assert (tcfg.hybrid_prelude, tcfg.hybrid_blocks) == (2, 2)
    jmodel = j_build(jcfg, impl="pallas", ssm_chunk=8)
    params = jmodel.init(jax.random.PRNGKey(0))
    tmodel = t_build(tcfg, device="cpu", ssm_chunk=8)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), params)
    tmodel.load_state_dict(params_from_jax(tree))
    return jcfg, jmodel, params, tree, tmodel


def _tokens(cfg, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _assert_hybrid_caches(tcache, jcache):
    groups = ("prelude_state", "block_state", "attn_kv")
    assert set(tcache) == set(jcache) == {"len", *groups}
    for g in groups:
        assert sorted(tcache[g]) == sorted(jcache[g])
        for k, t in tcache[g].items():
            assert tuple(t.shape) == tuple(jcache[g][k].shape), (g, k)
            np.testing.assert_allclose(_np(t), _np(jcache[g][k]), atol=TOL,
                                       rtol=TOL, err_msg=f"{g}/{k}")
    assert int(tcache["len"]) == int(jcache["len"])


def test_hybrid_prefill_decode_match_reference_f32():
    """Prefill logits, 16 greedy tokens and every cache group of the
    reference, S = 21 (three SSD chunks of 8, the last ragged)."""
    jcfg, jmodel, params, _, tmodel = _pair_models()
    S = 21
    toks = _tokens(jcfg, S)
    prefill = jax.jit(functools.partial(jmodel.prefill, dtype=jnp.float32))
    decode = jax.jit(functools.partial(jmodel.decode_step, dtype=jnp.float32))
    jlog, jcache = prefill(params, jnp.asarray(toks),
                           jmodel.init_cache(B, S + STEPS, jnp.float32))
    tcache = tmodel.init_cache(B, S + STEPS, dtype=torch.float32)
    tlog, tcache = tmodel.prefill(torch.from_numpy(toks), tcache,
                                  dtype=torch.float32)
    np.testing.assert_allclose(_np(tlog), _np(jlog), atol=TOL, rtol=TOL)
    _assert_hybrid_caches(tcache, jcache)

    jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
    ttok = tlog.argmax(-1)
    for step in range(STEPS):
        assert np.array_equal(ttok.numpy(), np.asarray(jtok)), f"step {step}"
        jlog, jcache = decode(params, jtok, jcache)
        tlog, tcache = tmodel.decode_step(ttok, tcache, dtype=torch.float32)
        np.testing.assert_allclose(_np(tlog), _np(jlog), atol=TOL, rtol=TOL)
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ttok = tlog.argmax(-1)
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    _assert_hybrid_caches(tcache, jcache)
    assert int(tcache["len"]) == S + STEPS


def test_hybrid_forward_hidden_matches_reference():
    jcfg, jmodel, params, _, tmodel = _pair_models()
    toks = _tokens(jcfg, 17, seed=2)
    want, _ = jmodel.forward(params, jnp.asarray(toks), dtype=jnp.float32)
    got = tmodel(torch.from_numpy(toks), dtype=torch.float32)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL)


def test_hybrid_weights_are_shared_once_and_mapped_explicitly():
    """``shared_attn`` exists once, the prelude and blocks map leaf for
    leaf: ``prelude/<path>[i]``, ``blocks/<path>[i][j]``."""
    jcfg, _, params, _, tmodel = _pair_models()
    sd = tmodel.state_dict()
    assert not any(k.startswith("layers.") for k in sd)
    assert {k for k in sd if k.startswith("shared_attn.")} == {
        f"shared_attn.{k}" for k in ("ln1", "ln2", "attn.wq", "attn.wk",
                                     "attn.wv", "attn.wo", "mlp.wi", "mlp.wg",
                                     "mlp.wo")}
    dec = params["decoder"]
    np.testing.assert_array_equal(
        sd["blocks.1.3.mixer.in_proj"].numpy(),
        np.asarray(dec["blocks"]["mixer"]["in_proj"][1, 3], np.float32))
    np.testing.assert_array_equal(
        sd["prelude.1.mixer.A_log"].numpy(),
        np.asarray(dec["prelude"]["mixer"]["A_log"][1], np.float32))
    np.testing.assert_array_equal(
        sd["shared_attn.attn.wq"].numpy(),
        np.asarray(dec["shared_attn"]["attn"]["wq"], np.float32))
    assert len(tmodel.prelude) == 2 and len(tmodel.blocks) == 2
    assert all(len(g) == jcfg.hybrid_attn_every - 1 for g in tmodel.blocks)


def test_params_from_jax_refuses_a_misshaped_hybrid_tree():
    _, tcfg = _cfgs()
    tree = _pair_models()[3]
    dec = tree["decoder"]
    # blocks stacked once, not twice: the leaves disagree on their second axis
    once = {**tree, "decoder": {**dec, "blocks": jax.tree_util.tree_map(
        lambda a: a.reshape((-1,) + a.shape[2:]), dec["blocks"])}}
    with pytest.raises(ValueError, match="blocks"):
        params_from_jax(once)
    tmodel = t_build(tcfg, device="cpu", ssm_chunk=8)
    # shared_attn stacked per block: its leaves have the wrong shape
    stacked = {**tree, "decoder": {**dec, "shared_attn": jax.tree_util.tree_map(
        lambda a: np.stack([a, a]), dec["shared_attn"])}}
    with pytest.raises(RuntimeError, match="size mismatch for shared_attn"):
        tmodel.load_state_dict(params_from_jax(stacked))
    # a leaf missing from the tree
    missing = {**tree, "decoder": {**dec, "prelude": {
        "ln1": dec["prelude"]["ln1"], "mixer": {
            k: v for k, v in dec["prelude"]["mixer"].items() if k != "D"}}}}
    with pytest.raises(RuntimeError, match=r"prelude\.0\.mixer\.D"):
        tmodel.load_state_dict(params_from_jax(missing))
    tmodel.load_state_dict(params_from_jax(tree))


def test_zamba2_7b_full_width_count():
    """The full-width blueprint: the reference's count, nothing allocated."""
    n = param_count(lm_blueprint(t_config(ARCH)))
    assert n == 5_622_728_000
    assert n == j_param_count(j_build(j_config(ARCH)).blueprint())


def test_hybrid_cache_layout_and_helpers():
    """The hybrid cache's groups and shapes, ``cache_capacity`` at its
    attention slots, ``cache_batch``, and ``reset_cache`` zeroing every
    group in place."""
    tmodel = _pair_models()[4]
    cfg = tmodel.cfg
    cache = tmodel.init_cache(3, 40, dtype=torch.bfloat16)
    assert set(cache) == {"len", "prelude_state", "block_state", "attn_kv"}
    assert cache["attn_kv"]["k"].shape == (2, 3, 40, cfg.num_kv_heads,
                                           cfg.resolved_head_dim)
    assert cache["attn_kv"]["k"].dtype == torch.bfloat16
    assert cache["block_state"]["ssm"].shape == (2, 5, 3, 8, 32, 16)
    assert cache["prelude_state"]["conv"].shape == (2, 3, 3, 256 + 2 * 16)
    assert cache["block_state"]["conv"].dtype == torch.float32
    assert tmodel.cache_capacity(cache) == 40
    assert tmodel.cache_batch(cache) == 3
    no_prelude = t_build(t_config(ARCH).scaled(), device="cpu")
    assert "prelude_state" not in no_prelude.init_cache(1, 8)
    for g in ("prelude_state", "block_state", "attn_kv"):
        for t in cache[g].values():
            t.fill_(1)
    cache["len"].fill_(7)
    tensors = [t for g in ("prelude_state", "block_state", "attn_kv")
               for t in cache[g].values()]
    tmodel.reset_cache(cache)
    assert int(cache["len"]) == 0
    assert all(bool(t.eq(0).all()) for t in tensors)
    assert [t for g in ("prelude_state", "block_state", "attn_kv")
            for t in cache[g].values()] == tensors


def test_zamba2_smoke_fleet_serves_on_cpu():
    """The hybrid smoke model serves the fleet across the preemption, and on
    the CPU no kernel is launched."""
    from repro_torch.serving.live import make_prompts, serve_fleet

    cfg = t_config(ARCH).scaled(num_layers=LAYERS)
    model = t_build(cfg, device="cpu", ssm_chunk=4)
    prompts = make_prompts(cfg, n=4, min_len=3, max_len=11, seed=2, device="cpu")
    ops.reset_launch_counts()
    res = serve_fleet(model, prompts, replicas=2, out_tokens=5, kill_step=2,
                      max_len=32, dtype=torch.float32, log=lambda s: None)
    assert sorted(res.completed) == sorted(prompts)
    assert all(len(t) == 6 for t in res.completed.values())
    assert res.retried and res.prefills == len(prompts) + len(res.retried)
    assert all(fn.launches == 0 for fn in ops.KERNEL_WRAPPERS)


# ---------------------------------------------------------------------------
# the attention kernels' plain versions at D = 112 (zamba2's head width)
# ---------------------------------------------------------------------------

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}

ATTN_112_CASES = [
    # (B, H, Kv, S, D, causal, window, prefix)
    (1, 4, 4, 128, 112, True, None, 0),
    (2, 4, 2, 192, 112, True, None, 0),          # GQA
    (1, 4, 4, 256, 112, True, 96, 0),            # sliding window
    (1, 4, 4, 128, 112, True, None, 32),         # prefix-LM
]

DECODE_112_CASES = [
    # (B, H, Kv, S, D, valid slots)
    (1, 4, 4, 256, 112, 256),
    (2, 8, 2, 512, 112, 300),
    (1, 32, 32, 384, 112, 100),                  # zamba2's 32 / 32 heads
]


def _pair(rng, shape, dtype_name):
    jdt, tdt, _ = DTYPES[dtype_name]
    x = rng.standard_normal(shape, dtype=np.float32)
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("case", ATTN_112_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_plain_at_d112_matches_pallas(case, dtype):
    B_, H, Kv, S, D, causal, window, prefix = case
    tol = DTYPES[dtype][2]
    rng = np.random.default_rng(ATTN_112_CASES.index(case))
    jq, tq = _pair(rng, (B_, H, S, D), dtype)
    jk, tk = _pair(rng, (B_, Kv, S, D), dtype)
    jv, tv = _pair(rng, (B_, Kv, S, D), dtype)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    pallas = flash_attention_bhsd(jq, jk, jv, block_q=64, block_kv=64,
                                  interpret=True, **kw)
    got = ops.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                              tv.transpose(1, 2), **kw).transpose(1, 2)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(
        _np(got), _np(jref.flash_attention_ref(jq, jk, jv, **kw)),
        atol=tol, rtol=tol)
    assert tfa.supports(D)


@pytest.mark.parametrize("case", DECODE_112_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_decode_plain_at_d112_matches_pallas(case, dtype):
    B_, H, Kv, S, D, n_valid = case
    tol = DTYPES[dtype][2]
    rng = np.random.default_rng(200 + DECODE_112_CASES.index(case))
    jq, tq = _pair(rng, (B_, H, D), dtype)
    jk, tk = _pair(rng, (B_, Kv, S, D), dtype)
    jv, tv = _pair(rng, (B_, Kv, S, D), dtype)
    valid = np.broadcast_to(np.arange(S)[None, :] < n_valid, (B_, S))
    valid = valid.astype(np.int8)
    pallas = flash_decode_bhd(jq, jk, jv, jnp.asarray(valid), block_kv=128,
                              interpret=True)
    got = ops.flash_decode(tq[:, None], tk.transpose(1, 2), tv.transpose(1, 2),
                           kv_valid=torch.from_numpy(valid))[:, 0]
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(
        _np(got), _np(jref.flash_decode_ref(jq, jk, jv, jnp.asarray(valid))),
        atol=tol, rtol=tol)
    assert tfa.supports(D)


def test_zamba2_card_cases_are_checked_by_chip_smoke():
    """The card tests' D = 112 cases are also among ``chip_smoke.py``'s
    checks, in both dtypes, and its fleet serves zamba2-7b at its
    full-width count."""
    import importlib.util
    from pathlib import Path

    import test_torch_cuda

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for dtype in (torch.bfloat16, torch.float32):
        fa = {(B_, H, Kv, S, S, D, causal, window, prefix)
              for dt, B_, H, Kv, S, D, causal, window, prefix in smoke.FA_CASES
              if dt == dtype}
        assert set(test_torch_cuda.ZAMBA_ATTN_CASES) <= fa
        fd = {(B_, H, Kv, S, D, mask)
              for dt, B_, H, Kv, S, D, mask in smoke.FD_CASES if dt == dtype}
        assert {c for c in test_torch_cuda.CARD_DECODE_CASES if c[4] == 112} <= fd
    assert "zamba2-7b" in smoke.SERVED
    assert smoke.FULL_PARAMS["zamba2-7b"] == param_count(
        lm_blueprint(t_config(ARCH)))
