"""The port's Whisper encoder-decoder (``repro_torch.models.whisper``)
against the reference's (``repro.models.whisper``).

The smoke config is whisper-medium scaled: 2 encoder and 2 decoder layers,
d_model 128, 4 heads of 32, 16 audio frames, vocabulary 512.  Weights are
the reference's ``init_params`` with the LayerNorms' scales and biases and
the self-attention biases redrawn (their ones / zeros would leave those
paths untested), carried across by ``params_from_jax``.  Inputs come from
numpy seeds.  The reference runs ``impl="blockwise"``; the port its kernel
wrappers, which take the kernels' plain versions on the CPU.  In float32
encoder output, prefill logits and every cache tensor agree within 1e-4
and 16 greedy decode steps pick identical tokens.

The cross-attention forms the port sends through the attention kernels
(non-causal with Sq != Skv in prefill, decode over an all-valid cache whose
length is off the 64-slot tiles) are held, through the plain versions, to
the Pallas kernels in interpret mode and to the reference's
``blockwise_attention`` / ``decode_attention`` at the reference's kernel
tolerances (2e-5 in float32, 2e-2 in bfloat16).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.kernels.flash_attention import flash_attention_bhsd  # noqa: E402
from repro.kernels.flash_decode import flash_decode_bhd  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import param_count as j_param_count  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.steps import build_serve_step  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import whisper as twhisper  # noqa: E402
from repro_torch.models.base import param_count  # noqa: E402
from repro_torch.models.registry import build_model as t_build  # noqa: E402

ARCH = "whisper-medium"
B, S, STEPS, MAX_LEN = 2, 7, 16, 32
TOL = 1e-4
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _redraw(tree, rng):
    """LayerNorm scales near 1, their biases and the self-attention biases
    small: nonzero where ``init_params`` leaves ones and zeros."""
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out[name] = _redraw(value, rng)
        elif name == "scale":
            out[name] = (1.0 + 0.1 * rng.standard_normal(value.shape)).astype(np.float32)
        elif name in ("bias", "bq", "bk", "bv"):
            out[name] = (0.1 * rng.standard_normal(value.shape)).astype(np.float32)
        else:
            out[name] = value
    return out


@functools.lru_cache(maxsize=None)
def _pair_models():
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    jmodel = j_build(jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jmodel.init(jax.random.PRNGKey(0)))
    tree = _redraw(tree, np.random.default_rng(3))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tmodel = t_build(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(tree))
    return jcfg, jmodel, params, tree, tmodel


def _inputs(cfg, seed=0, steps=S):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, cfg.frontend_seq, cfg.d_model), dtype=np.float32)
    return frames, rng.integers(0, cfg.vocab_size, (B, steps))


def _pair(rng, shape, dtype_name):
    jdt, tdt, _ = DTYPES[dtype_name]
    x = rng.standard_normal(shape, dtype=np.float32)
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


# ---------------------------------------------------------------------------
# layers: LayerNorm and the sinusoidal positions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 2e-2)])
def test_layer_norm_matches_reference(dtype, tol):
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng, (3, 5, 96), dtype)
    p = {"scale": rng.standard_normal(96).astype(np.float32),
         "bias": rng.standard_normal(96).astype(np.float32)}
    want = jlayers.layer_norm(3.0 * jx + 1.0,
                              {k: jnp.asarray(v) for k, v in p.items()})
    got = tlayers.layer_norm(3.0 * tx + 1.0,
                             {k: torch.from_numpy(v) for k, v in p.items()})
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    assert set(tlayers.layernorm_spec(96)) == set(jlayers.layernorm_spec(96))


@pytest.mark.parametrize("n,d", [(16, 128), (1500, 1024), (448, 64)])
def test_sinusoidal_positions_match_reference(n, d):
    want = np.asarray(jwhisper.sinusoidal_positions(n, d))
    got = twhisper.sinusoidal_positions(n, d)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    # the angles reach n radians, where one float32 ulp is n * 2^-23: two
    # correct float32 evaluations of pos / 10000^(2i/d) may differ by it
    np.testing.assert_allclose(got.numpy(), want, atol=n * 2.0**-23, rtol=0)
    # the closed form at a device position is the table's row
    at = torch.tensor([0, n // 2, n - 1])
    torch.testing.assert_close(twhisper.sinusoid_at(at, d), got[at], atol=0, rtol=0)


def test_whisper_medium_full_width_count():
    """The full-width blueprint: the reference's count, nothing allocated."""
    n = param_count(twhisper.encdec_blueprint(t_config(ARCH)))
    assert n == 758_255_616
    assert n == j_param_count(j_build(j_config(ARCH)).blueprint())


def test_blueprint_matches_reference_leaf_for_leaf():
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)

    def shapes(bp):
        return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(leaf.shape)
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    bp, is_leaf=lambda x: hasattr(x, "logical"))[0]}

    want = shapes(j_build(jcfg).blueprint())
    got = shapes(twhisper.encdec_blueprint(tcfg))
    assert got == want
    assert "decoder/cross_attn/bq" not in got and "decoder/self_attn/bq" in got


# ---------------------------------------------------------------------------
# the cross-attention forms, through the kernels' plain versions
# ---------------------------------------------------------------------------

CROSS_CASES = [
    # (B, H, Kv, Sq, Skv, D): decoder prompts against encoder frames
    (1, 4, 4, 1, 100, 32),
    (2, 4, 4, 4, 150, 64),
    (1, 4, 4, 63, 130, 64),
    (1, 4, 2, 65, 70, 64),       # GQA, Sq just past one 64-row tile
]


@pytest.mark.parametrize("case", CROSS_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cross_attention_prefill_matches_pallas_and_blockwise(case, dtype):
    B_, H, Kv, Sq, Skv, D = case
    tol = DTYPES[dtype][2]
    rng = np.random.default_rng(CROSS_CASES.index(case))
    jq, tq = _pair(rng, (B_, Sq, H, D), dtype)
    jk, tk = _pair(rng, (B_, Skv, Kv, D), dtype)
    jv, tv = _pair(rng, (B_, Skv, Kv, D), dtype)
    got = ops.flash_attention(tq, tk, tv, causal=False)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = flash_attention_bhsd(
        jq.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3),
        jv.transpose(0, 2, 1, 3), causal=False, block_q=64, block_kv=64,
        interpret=True).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol, rtol=tol)
    blockwise = jattn.blockwise_attention(
        jq, jk, jv, q_pos=jnp.arange(Sq, dtype=jnp.int32),
        kv_pos=jnp.arange(Skv, dtype=jnp.int32), causal=False,
        q_block=64, kv_block=64)
    np.testing.assert_allclose(_np(got), _np(blockwise), atol=tol, rtol=tol)


CROSS_DECODE_CASES = [
    # (B, H, Kv, S, D): all slots valid, S off the 64-slot tiles
    (1, 4, 4, 100, 32),
    (2, 4, 4, 16, 32),
    (2, 16, 16, 1500, 64),       # whisper-medium's cross cache
]


@pytest.mark.parametrize("case", CROSS_DECODE_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cross_attention_decode_matches_decode_attention(case, dtype):
    B_, H, Kv, S_, D = case
    tol = DTYPES[dtype][2]
    rng = np.random.default_rng(50 + CROSS_DECODE_CASES.index(case))
    jq, tq = _pair(rng, (B_, 1, H, D), dtype)
    jk, tk = _pair(rng, (B_, S_, Kv, D), dtype)
    jv, tv = _pair(rng, (B_, S_, Kv, D), dtype)
    valid = np.ones((B_, S_), bool)
    got = ops.flash_decode(tq, tk, tv, kv_valid=torch.from_numpy(valid))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = jattn.decode_attention(jq, jk, jv, kv_valid=jnp.asarray(valid))
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    pallas = flash_decode_bhd(jq[:, 0], jk.transpose(0, 2, 1, 3),
                              jv.transpose(0, 2, 1, 3),
                              jnp.asarray(valid.astype(np.int8)), block_kv=64,
                              interpret=True)
    np.testing.assert_allclose(_np(got[:, 0]), _np(pallas), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------


def test_encode_matches_reference_f32():
    jcfg, jmodel, params, _, tmodel = _pair_models()
    frames, _ = _inputs(jcfg, seed=1)
    want = jmodel.encode(params, jnp.asarray(frames))
    got = tmodel.encode(torch.from_numpy(frames))
    assert got.shape == (B, jcfg.frontend_seq, jcfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL)


def _assert_caches(tcache, jcache):
    assert set(tcache) == set(jcache) | {"cross_valid"}
    assert int(tcache["len"]) == int(jcache["len"])
    for name, t, want in (("kv.k", tcache["kv"]["k"], jcache["kv"]["k"]),
                          ("kv.v", tcache["kv"]["v"], jcache["kv"]["v"]),
                          ("cross_k", tcache["cross_k"], jcache["cross_k"]),
                          ("cross_v", tcache["cross_v"], jcache["cross_v"])):
        assert tuple(t.shape) == tuple(want.shape), name
        np.testing.assert_allclose(_np(t), _np(want), atol=TOL, rtol=TOL,
                                   err_msg=name)
    assert bool(tcache["cross_valid"].all())


def test_prefill_and_16_greedy_steps_match_reference_f32():
    """Prefill logits and all four cache tensors, then 16 greedy decode
    steps: identical tokens, logits and caches within 1e-4."""
    jcfg, jmodel, params, _, tmodel = _pair_models()
    frames, toks = _inputs(jcfg)
    prefill = jax.jit(functools.partial(jmodel.prefill, dtype=jnp.float32))
    decode = jax.jit(functools.partial(jmodel.decode_step, dtype=jnp.float32))
    jlog, jcache = prefill(params, jnp.asarray(frames), jnp.asarray(toks),
                           jmodel.init_cache(B, MAX_LEN, jnp.float32))
    tcache = tmodel.init_cache(B, MAX_LEN, dtype=torch.float32)
    tlog, tcache = tmodel.prefill(torch.from_numpy(frames), torch.from_numpy(toks),
                                  tcache, dtype=torch.float32)
    assert tlog.shape == (B, 1, jcfg.padded_vocab)
    np.testing.assert_allclose(_np(tlog), _np(jlog), atol=TOL, rtol=TOL)
    _assert_caches(tcache, jcache)

    jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
    ttok = tlog.argmax(-1)
    for step in range(STEPS):
        assert np.array_equal(ttok.numpy(), np.asarray(jtok)), f"step {step}"
        jlog, jcache = decode(params, jtok, jcache)
        tlog, tcache = tmodel.decode_step(ttok, tcache, dtype=torch.float32)
        np.testing.assert_allclose(_np(tlog), _np(jlog), atol=TOL, rtol=TOL,
                                   err_msg=f"step {step}")
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ttok = tlog.argmax(-1)
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    _assert_caches(tcache, jcache)
    assert int(tcache["len"]) == S + STEPS


def test_decode_logits_match_a_full_prefill():
    """The reference's own check (``test_models_smoke.py``): each decode
    step's logits equal those of a prefill over the prompt so far."""
    jcfg, _, _, _, tmodel = _pair_models()
    frames, toks = _inputs(jcfg, seed=2, steps=S + 4)
    frames, toks = torch.from_numpy(frames), torch.from_numpy(toks)

    def fresh():
        return tmodel.init_cache(B, MAX_LEN, dtype=torch.float32)

    _, cache = tmodel.prefill(frames, toks[:, :S], fresh(), dtype=torch.float32)
    for t in range(S, S + 4):
        want, _ = tmodel.prefill(frames, toks[:, :t + 1], fresh(), dtype=torch.float32)
        got, cache = tmodel.decode_step(toks[:, t:t + 1], cache, dtype=torch.float32)
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


def test_cpu_serve_step_equals_decode_step_loop():
    """The eager serve step is ``decode_step`` plus ``argmax``, bit for
    bit, from the same prefill."""
    jcfg, _, _, _, tmodel = _pair_models()
    frames, toks = _inputs(jcfg, seed=4)
    frames, toks = torch.from_numpy(frames), torch.from_numpy(toks)
    step_cache = tmodel.init_cache(B, MAX_LEN, dtype=torch.float32)
    step = build_serve_step(tmodel, step_cache, dtype=torch.float32)
    assert step.graph is None and step.tokens.shape == (B, 1)
    loop_cache = tmodel.init_cache(B, MAX_LEN, dtype=torch.float32)
    with torch.inference_mode():
        logits, _ = tmodel.prefill(frames, toks, loop_cache, dtype=torch.float32)
        tmodel.prefill(frames, toks, step_cache, dtype=torch.float32)
        tok = logits.argmax(-1)
        step.tokens.copy_(tok)
        for i in range(STEPS):
            logits, _ = tmodel.decode_step(tok, loop_cache, dtype=torch.float32)
            tok = logits.argmax(-1)
            assert torch.equal(step(), tok), f"step {i}"
            assert torch.equal(step.logits, logits)
    assert int(step_cache["len"]) == int(loop_cache["len"]) == S + STEPS


def test_cache_layout_written_in_place_and_reset():
    """The cache's tensors and shapes; prefill writes the cross K/V into
    the tensors the cache was made with (a captured step reads those);
    ``reset_cache`` zeroes length and self K/V in place and keeps the mask."""
    jcfg, _, _, _, tmodel = _pair_models()
    cfg = tmodel.cfg
    cache = tmodel.init_cache(B, MAX_LEN, dtype=torch.float32)
    L, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    assert cache["kv"]["k"].shape == (L, B, MAX_LEN, kv, hd)
    assert cache["cross_k"].shape == (L, B, cfg.frontend_seq, kv, hd)
    assert cache["cross_valid"].shape == (B, cfg.frontend_seq)
    assert cache["cross_valid"].dtype == torch.bool
    assert tmodel.cache_batch(cache) == B and tmodel.cache_capacity(cache) == MAX_LEN
    tensors = [cache["len"], cache["kv"]["k"], cache["kv"]["v"],
               cache["cross_k"], cache["cross_v"], cache["cross_valid"]]
    frames, toks = _inputs(jcfg, seed=5)
    with torch.inference_mode():
        tmodel.prefill(torch.from_numpy(frames), torch.from_numpy(toks), cache,
                       dtype=torch.float32)
    assert [cache["len"], cache["kv"]["k"], cache["kv"]["v"], cache["cross_k"],
            cache["cross_v"], cache["cross_valid"]] == tensors
    assert bool(cache["cross_k"].ne(0).any()) and int(cache["len"]) == S
    tmodel.reset_cache(cache)
    assert int(cache["len"]) == 0
    assert all(bool(t.eq(0).all()) for t in tensors[1:3])
    assert bool(cache["cross_valid"].all())
    with pytest.raises(ValueError, match="cross cache"):
        tmodel.prefill(torch.zeros(B, cfg.frontend_seq + 1, cfg.d_model),
                       torch.from_numpy(toks), cache, dtype=torch.float32)


def test_cpu_fleet_carries_frames_across_the_preemption():
    """The smoke model serves the fleet across the preemption: every
    prefill, a retry's too, gets its request's own frames, every request's
    tokens are the greedy tokens of its frames and prompt, and on the CPU
    no kernel is launched."""
    from repro_torch.serving.live import make_frames, make_prompts, serve_fleet

    cfg = t_smoke(ARCH)
    model = _pair_models()[4]
    prompts = make_prompts(cfg, n=4, min_len=3, max_len=11, seed=2, device="cpu")
    frames = make_frames(cfg, prompts, seed=6, device="cpu")
    assert all(f.shape == (1, cfg.frontend_seq, cfg.d_model) for f in frames.values())
    seen = []

    def recording(f, tokens, cache, **kw):
        seen.append((f, tokens))
        return type(model).prefill(model, f, tokens, cache, **kw)

    ops.reset_launch_counts()
    model.prefill = recording
    try:
        res = serve_fleet(model, prompts, replicas=2, out_tokens=5, kill_step=2,
                          max_len=32, dtype=torch.float32, log=lambda s: None,
                          frames=frames)
    finally:
        del model.prefill
    assert sorted(res.completed) == sorted(prompts)
    assert res.retried and res.prefills == len(prompts) + len(res.retried)
    assert all(fn.launches == 0 for fn in ops.KERNEL_WRAPPERS)
    assert len(seen) == res.prefills
    for rid in prompts:
        calls = [f for f, t in seen if torch.equal(t[0], prompts[rid])]
        assert len(calls) == 1 + (rid in res.retried), rid
        assert all(f is frames[rid] for f in calls), rid

    def greedy(f, prompt):
        cache = model.init_cache(1, 32, dtype=torch.float32)
        logits, _ = model.prefill(f, prompt[None], cache, dtype=torch.float32)
        out = [int(logits.argmax(-1))]
        for _ in range(5):
            logits, _ = model.decode_step(logits.argmax(-1), cache, dtype=torch.float32)
            out.append(int(logits.argmax(-1)))
        return out

    with torch.inference_mode():
        for rid, toks in res.completed.items():
            assert toks == greedy(frames[rid], prompts[rid]), rid


def test_cli_serves_the_smoke_model_on_cpu(capsys):
    from repro_torch.serving.live import main

    main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    assert "served 8 requests / 136 tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# weight conversion
# ---------------------------------------------------------------------------


def test_params_from_jax_maps_encoder_decoder_and_norms():
    _, _, _, tree, tmodel = _pair_models()
    sd = params_from_jax(tree)
    assert set(sd) == set(tmodel.state_dict())
    assert not any(k.startswith("layers.") for k in sd)
    np.testing.assert_array_equal(sd["encoder.1.attn.bq"].numpy(),
                                  tree["encoder"]["attn"]["bq"][1])
    np.testing.assert_array_equal(sd["decoder.0.cross_attn.wk"].numpy(),
                                  tree["decoder"]["cross_attn"]["wk"][0])
    np.testing.assert_array_equal(sd["decoder.1.ln_x.scale"].numpy(),
                                  tree["decoder"]["ln_x"]["scale"][1])
    for name in ("enc_norm", "dec_norm"):
        for leaf in ("scale", "bias"):
            np.testing.assert_array_equal(sd[f"{name}.{leaf}"].numpy(),
                                          tree[name][leaf])
    assert sd["embed"].dtype == torch.float32
    assert params_from_jax(tree, torch.bfloat16)["enc_norm.bias"].dtype == torch.bfloat16


def test_params_from_jax_refuses_unknown_and_misshaped_subtrees():
    tree = _pair_models()[3]
    with pytest.raises(ValueError, match="unexpected subtree 'adapter'"):
        params_from_jax({**tree, "adapter": {"w": np.zeros((2, 2), np.float32)}})
    with pytest.raises(ValueError, match="unexpected subtree '(enc|dec)_norm'"):
        # a decoder-only tree has no LayerNorm subtrees
        params_from_jax({k: v for k, v in tree.items() if k != "encoder"})
    enc = tree["encoder"]
    ragged = {**tree, "encoder": {**enc, "ln1": {
        "scale": enc["ln1"]["scale"][:1], "bias": enc["ln1"]["bias"]}}}
    with pytest.raises(ValueError, match="encoder"):
        params_from_jax(ragged)


def test_whisper_card_cases_are_checked_by_chip_smoke():
    """The card tests' whisper-medium cases are also among ``chip_smoke.py``'s
    checks, in both dtypes; its fleet serves whisper-medium at its
    full-width count and demands 72 flash_attention launches a prefill and
    48 flash_decode a decode step."""
    import importlib.util
    import types
    from pathlib import Path

    import test_torch_cuda

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for dtype in (torch.bfloat16, torch.float32):
        fa = {(B_, H, Kv, Sq, Skv, D, causal, None, 0)
              for dt, B_, H, Kv, Sq, Skv, D, causal in smoke.WHISPER_FA_CASES
              if dt == dtype}
        assert fa == set(test_torch_cuda.WHISPER_ATTN_CASES)
        fd = {(B_, H, Kv, S_, D, mask)
              for dt, B_, H, Kv, S_, D, mask in smoke.FD_CASES if dt == dtype}
        assert set(test_torch_cuda.WHISPER_DECODE_CASES) <= fd
    assert "whisper-medium" in smoke.SERVED
    assert smoke.FULL_PARAMS[ARCH] == param_count(
        twhisper.encdec_blueprint(t_config(ARCH)))
    assert smoke.FLEET_SHAPES[ARCH] == (4, 224, 448)
    model = types.SimpleNamespace(cfg=t_config(ARCH))
    want = smoke.expected_launches(model, types.SimpleNamespace(
        prefills=3, decode_steps=5, prefill_lens=[4, 100, 224]))
    assert want == {"flash_attention": 72 * 3, "flash_decode": 48 * 5,
                    "selective_scan": 0, "moe_gmm": 0,
                    "scenario_scan": 0}
