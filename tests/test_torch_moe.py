"""The port's MoE path against the reference's: the grouped matmul's plain
version against the Pallas kernel (interpret mode) and the jnp oracle,
``ops.moe_ffn``, routing and capacity, ``moe_apply`` against the reference's
``impl="pallas"`` and ``"einsum"`` paths, and the qwen3-moe-30b and
phi3.5-moe-42b smoke models (2 layers, d_model 128, 8 experts; top-8 and
top-2) against the reference's ``TransformerLM``.

Tolerances: the grouped matmul at the reference's own (1e-4 in float32,
5e-2 in bfloat16, ``tests/test_kernels.py``); ``moe_ffn`` and ``moe_apply``
(y and the aux loss) within 1e-4 in float32; the models as
``test_torch_lm.py``: prefill and decode logits within 1e-4, caches within
1e-5, identical greedy tokens for 8 steps, and one bfloat16 case within
0.02 + 0.004 * max |logit|.  Inputs and weights come from numpy seeds or
from the reference's ``init`` through ``params_from_jax``.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.moe_gmm import moe_gmm_ecf  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import moe_gmm as tgmm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.registry import build_model as t_build  # noqa: E402
from test_kernels import GMM_CASES  # noqa: E402

GMM_TOL = {"float32": (jnp.float32, torch.float32, 1e-4),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
B, STEPS = 2, 8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# ---------------------------------------------------------------------------
# grouped matmul and expert FFN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", GMM_CASES)
@pytest.mark.parametrize("dtype", list(GMM_TOL))
def test_moe_gmm_plain_matches_pallas_and_ref(case, dtype):
    E, C, D, F = case
    jdt, tdt, tol = GMM_TOL[dtype]
    rng = np.random.default_rng(300 + GMM_CASES.index(case))
    x = rng.standard_normal((E, C, D), dtype=np.float32)
    w = rng.standard_normal((E, D, F), dtype=np.float32)
    jx, jw = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    pallas = moe_gmm_ecf(jx, jw, block_c=64, block_d=64, block_f=64,
                         interpret=True)
    oracle = jref.moe_gmm_ref(jx, jw)
    before = ops.moe_gmm.launches
    got = ops.moe_gmm(tx, tw)
    assert ops.moe_gmm.launches == before        # CPU: the plain version
    assert got.dtype == tdt and got.shape == (E, C, F)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(tref.moe_gmm_ref(tx, tw)), _np(oracle),
                               atol=tol, rtol=tol)


# rows[e] of an 8-expert case: empty, full and partly filled experts
ROWS_PATTERN = (0, None, 3, 0, 1, None, 17, 0)     # None: all C rows


def _rows_case(rng, C, dtype_name, garbage=False):
    """x (8, C, 128) like the dispatch buffer: rows at or past rows[e] are
    zeros, or random when ``garbage``; w (8, 128, 96); rows (8,) int32."""
    jdt, tdt, _ = GMM_TOL[dtype_name]
    E, D, F = len(ROWS_PATTERN), 128, 96
    rows = np.array([C if r is None else min(r, C) for r in ROWS_PATTERN],
                    np.int32)
    x = rng.standard_normal((E, C, D), dtype=np.float32)
    if not garbage:
        x[np.arange(C)[None, :] >= rows[:, None]] = 0.0
    w = rng.standard_normal((E, D, F), dtype=np.float32)
    return ((jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)),
            (torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)),
            torch.from_numpy(rows))


@pytest.mark.parametrize("C", [1, 5, 24])
@pytest.mark.parametrize("dtype", list(GMM_TOL))
def test_moe_gmm_plain_with_rows_matches_pallas(C, dtype):
    """With the occupancy ``rows`` of a dispatch-like x (zeros past
    rows[e]; empty, full and partial experts), the grouped matmul is the
    reference's on the whole buffer, and equals the port's without rows."""
    tol = GMM_TOL[dtype][2]
    (jx, jw), (tx, tw), rows = _rows_case(np.random.default_rng(700 + C), C,
                                          dtype)
    pallas = moe_gmm_ecf(jx, jw, block_c=64, block_d=64, block_f=64,
                         interpret=True)
    before = ops.moe_gmm.launches
    got = ops.moe_gmm(tx, tw, rows)
    assert ops.moe_gmm.launches == before        # CPU: the plain version
    assert got.dtype == tx.dtype and got.shape == (8, C, 96)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol, rtol=tol)
    torch.testing.assert_close(got, ops.moe_gmm(tx, tw), atol=0, rtol=0)
    torch.testing.assert_close(got, tref.moe_gmm_ref(tx, tw, rows), atol=0,
                               rtol=0)


@pytest.mark.parametrize("dtype", list(GMM_TOL))
def test_moe_gmm_rows_past_the_occupancy_come_out_zero(dtype):
    """Rows at or past rows[e] are zeros whatever x holds there; the rows
    before are the product's."""
    C = 24
    _, (tx, tw), rows = _rows_case(np.random.default_rng(9), C, dtype,
                                   garbage=True)
    got = ops.moe_gmm(tx, tw, rows)
    full = ops.moe_gmm(tx, tw)
    live = torch.arange(C)[None, :] < rows[:, None]
    assert bool(full[~live].ne(0).any())         # the garbage was not zero
    assert bool(got[~live].eq(0).all())
    torch.testing.assert_close(got[live], full[live], atol=0, rtol=0)
    # the expert FFN hands rows to each product: past them, zeros too
    y = ops.moe_ffn(tx, tw, tw, tw.transpose(1, 2), rows=rows)
    assert bool(y[~live].eq(0).all())


def _ffn_weights(rng, E, D, F, gated):
    """Weights at fan-in scale, so every stage stays O(1)."""
    wi = rng.standard_normal((E, D, F), dtype=np.float32) / np.sqrt(D)
    wg = (rng.standard_normal((E, D, F), dtype=np.float32) / np.sqrt(D)
          if gated else None)
    wo = rng.standard_normal((E, F, D), dtype=np.float32) / np.sqrt(F)
    return wi, wg, wo


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False),
                                       ("gelu", True)])
def test_moe_ffn_matches_reference(act, gated):
    E, C, D, F = 4, 32, 64, 96
    rng = np.random.default_rng(17)
    xe = rng.standard_normal((E, C, D), dtype=np.float32)
    wi, wg, wo = _ffn_weights(rng, E, D, F, gated)
    j = [None if a is None else jnp.asarray(a) for a in (xe, wi, wg, wo)]
    t = [None if a is None else torch.from_numpy(a) for a in (xe, wi, wg, wo)]
    want = jops.moe_ffn(*j, act=act, interpret=True)
    got = ops.moe_ffn(*t, act=act)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
    plain = ops.moe_ffn(*t, act=act, impl="plain")
    torch.testing.assert_close(got, plain, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# routing and capacity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("E,k", [(8, 8), (16, 2), (128, 8)])
def test_route_topk_matches_reference(E, k):
    logits = np.random.default_rng(E + k).standard_normal(
        (37, E), dtype=np.float32)
    jw, jidx = jmoe.route_topk(jnp.asarray(logits), k)
    tw, tidx = tmoe.route_topk(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b", "phi3.5-moe-42b"])
def test_capacity_matches_reference(arch):
    from repro.configs import get_config as j_config
    from repro_torch.configs import get_config as t_config

    for jcfg, tcfg in ((j_config(arch), t_config(arch)),
                       (j_smoke(arch), t_smoke(arch))):
        for n in (1, 2, 7, 24, 975, 16_384):
            assert tmoe._capacity(tcfg, n) == jmoe._capacity(jcfg, n)
    assert tmoe._capacity(t_config("qwen3-moe-30b"), 1) == 1
    assert tmoe._capacity(t_config("qwen3-moe-30b"), 975) == 77


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------


def _moe_case(name):
    """(config pair, B, S, chunk_tokens) of a moe_apply case."""
    arch = "phi3.5-moe-42b" if name == "phi3.5-smoke" else "qwen3-moe-30b"
    jcfg, tcfg = j_smoke(arch), t_smoke(arch)
    change = {
        "top2-drops": dict(experts_per_token=2, capacity_factor=0.5),
        "chunked": dict(experts_per_token=2, capacity_factor=1.0),
        "fp8-dispatch": dict(moe_dispatch_dtype="float8_e4m3fn"),
    }.get(name, {})
    jcfg = dataclasses.replace(jcfg, **change)
    tcfg = dataclasses.replace(tcfg, **change)
    chunk = 8 if name == "chunked" else 16_384
    return jcfg, tcfg, 2, 16, chunk


def _moe_params(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in jmoe.moe_blueprint(cfg).items():
        fan_in = spec.shape[-2]
        out[name] = (rng.standard_normal(spec.shape) / np.sqrt(fan_in)
                     ).astype(np.float32)
    return out


MOE_CASES = ["qwen3-smoke", "top2-drops", "phi3.5-smoke", "chunked",
             "fp8-dispatch"]


@pytest.mark.parametrize("name", MOE_CASES)
@pytest.mark.parametrize("j_impl", ["pallas", "einsum"])
def test_moe_apply_matches_reference(name, j_impl):
    jcfg, tcfg, b, s, chunk = _moe_case(name)
    params = _moe_params(jcfg, MOE_CASES.index(name))
    x = np.random.default_rng(40).standard_normal((b, s, jcfg.d_model),
                                                  dtype=np.float32)
    jy, jaux = jmoe.moe_apply({k: jnp.asarray(v) for k, v in params.items()},
                              jcfg, jnp.asarray(x), impl=j_impl,
                              return_aux=True, chunk_tokens=chunk)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    before = ops.moe_gmm.launches
    ty, taux = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x), return_aux=True,
                              chunk_tokens=chunk)
    assert ops.moe_gmm.launches == before        # CPU: the plain version
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-4, rtol=1e-4)
    py, paux = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x), impl="plain",
                              return_aux=True, chunk_tokens=chunk)
    torch.testing.assert_close(py, ty, atol=0, rtol=0)
    assert tmoe.moe_apply(tp, tcfg, torch.from_numpy(x),
                          chunk_tokens=chunk)[1] is None


@pytest.mark.parametrize("name", MOE_CASES)
def test_moe_apply_hands_the_occupancy_to_the_expert_ffn(name, monkeypatch):
    """``moe_apply`` passes each chunk's capacity count, clamped to C, as
    ``rows``: int32 on the input's device, every row of xe[e] before it a
    token (nonzero) and every row from it on zero."""
    jcfg, tcfg, b, s, chunk = _moe_case(name)
    tp = {k: torch.from_numpy(v)
          for k, v in _moe_params(jcfg, MOE_CASES.index(name)).items()}
    x = torch.from_numpy(np.random.default_rng(41).standard_normal(
        (b, s, tcfg.d_model), dtype=np.float32))
    seen, ffn = [], ops.moe_ffn

    def record(xe, *args, rows=None, **kw):
        seen.append((xe, rows))
        return ffn(xe, *args, rows=rows, **kw)

    monkeypatch.setattr(tmoe.ops, "moe_ffn", record)
    tmoe.moe_apply(tp, tcfg, x, chunk_tokens=chunk)
    n_chunks = b * s // chunk if b * s > chunk else 1
    assert len(seen) == n_chunks
    chunks = x.reshape(len(seen), -1, tcfg.d_model)
    for (xe, rows), xc in zip(seen, chunks):
        E, C = xe.shape[:2]
        assert rows.dtype == torch.int32 and rows.shape == (E,)
        assert rows.device == x.device
        nonzero = xe.ne(0).any(-1)                       # (E, C)
        live = torch.arange(C)[None, :] < rows[:, None].long()
        assert torch.equal(nonzero, live)
        # the (token, k) pairs each expert was routed, up to its capacity
        idx = tmoe.route_topk(xc @ tp["router"], tcfg.experts_per_token)[1]
        routed = torch.bincount(idx.reshape(-1), minlength=E)
        assert torch.equal(rows.long(), routed.clamp(max=C))


def test_moe_cases_drop_and_chunk():
    """The cases do what their names say: top-2 at capacity factor 0.5 drops
    (token, k) pairs, and the chunked case runs chunk by chunk with capacity
    per chunk (here a smaller capacity, so its output differs from the
    unchunked one)."""
    jcfg, tcfg, b, s, _ = _moe_case("top2-drops")
    n = b * s
    assert tmoe._capacity(tcfg, n) * tcfg.num_experts < n * tcfg.experts_per_token
    jcfg, tcfg, b, s, chunk = _moe_case("chunked")
    assert b * s > chunk and (b * s) % chunk == 0
    tp = {k: torch.from_numpy(v) for k, v in _moe_params(jcfg, 3).items()}
    x = torch.from_numpy(np.random.default_rng(40).standard_normal(
        (b, s, tcfg.d_model), dtype=np.float32))
    whole = tmoe.moe_apply(tp, tcfg, x)[0]
    chunked = tmoe.moe_apply(tp, tcfg, x, chunk_tokens=chunk)[0]
    by_hand = torch.cat([tmoe.moe_apply(tp, tcfg, xc[None])[0][0]
                         for xc in x.reshape(-1, chunk, tcfg.d_model)])
    torch.testing.assert_close(chunked.reshape(-1, chunk, tcfg.d_model),
                               by_hand.reshape(-1, chunk, tcfg.d_model),
                               atol=0, rtol=0)
    assert tmoe._capacity(tcfg, chunk) < tmoe._capacity(tcfg, b * s) / 2
    assert not torch.equal(whole, chunked)
    with pytest.raises(ValueError, match="impl"):
        tmoe.moe_apply(tp, tcfg, x, impl="pallas")


# ---------------------------------------------------------------------------
# model level: qwen3-moe-30b and phi3.5-moe-42b smoke
# ---------------------------------------------------------------------------


def _pair_models(arch):
    jcfg, tcfg = j_smoke(arch), t_smoke(arch)
    jmodel = j_build(jcfg, impl="pallas")
    params = jmodel.init(jax.random.PRNGKey(0))
    tmodel = t_build(tcfg, device="cpu")
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), params)
    tmodel.load_state_dict(params_from_jax(tree))
    return jcfg, jmodel, params, tmodel


def _tokens(cfg, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b", "phi3.5-moe-42b"])
def test_prefill_decode_match_reference_f32(arch):
    S, max_len = 12, 24
    jcfg, jmodel, params, tmodel = _pair_models(arch)
    toks = _tokens(jcfg, S)
    prefill = jax.jit(functools.partial(jmodel.prefill, dtype=jnp.float32))
    decode = jax.jit(functools.partial(jmodel.decode_step, dtype=jnp.float32))

    jlog, jcache = prefill(params, jnp.asarray(toks),
                           jmodel.init_cache(B, max_len, jnp.float32))
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
        np.testing.assert_allclose(_np(tcache["kv"][kv]), _np(jcache["kv"][kv]),
                                   atol=1e-5, rtol=1e-5)
    assert int(tcache["len"]) == int(jcache["len"]) == S + STEPS


def test_prefill_decode_match_reference_bf16():
    jcfg, jmodel, params, tmodel = _pair_models("qwen3-moe-30b")
    toks = _tokens(jcfg, 13, seed=1)
    jlog, jcache = jmodel.prefill(params, jnp.asarray(toks),
                                  jmodel.init_cache(B, 24))
    tlog, tcache = tmodel.prefill(torch.from_numpy(toks),
                                  tmodel.init_cache(B, 24))
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


def test_impl_plain_matches_impl_kernel_on_cpu():
    _, _, _, tmodel = _pair_models("phi3.5-moe-42b")
    toks = torch.from_numpy(_tokens(tmodel.cfg, 12, seed=3))
    got = tmodel.prefill(toks, tmodel.init_cache(B, 24, torch.float32),
                         dtype=torch.float32)[0]
    tmodel.impl = "plain"
    want = tmodel.prefill(toks, tmodel.init_cache(B, 24, torch.float32),
                          dtype=torch.float32)[0]
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_params_from_jax_carries_the_expert_leaves():
    """The stacked (L, E, d, f) expert leaves and the (L, d, E) router
    arrive under ``layers.<i>.moe.*``: the load is strict and every leaf is
    equal."""
    jcfg, _, params, tmodel = _pair_models("qwen3-moe-30b")
    sd = tmodel.state_dict()
    assert {k for k in sd if ".moe." in k} == {
        f"layers.{i}.moe.{n}" for i in range(jcfg.num_layers)
        for n in jmoe.moe_blueprint(jcfg)}
    assert not any(".mlp." in k for k in sd)
    E, d, f = jcfg.num_experts, jcfg.d_model, jcfg.expert_d_ff
    assert params["decoder"]["moe"]["wi"].shape == (jcfg.num_layers, E, d, f)
    assert sd["layers.1.moe.router"].shape == (d, E)
    for name in ("router", "wi", "wg", "wo"):
        np.testing.assert_array_equal(
            sd[f"layers.1.moe.{name}"].numpy(),
            np.asarray(params["decoder"]["moe"][name][1], np.float32))


def test_qwen3_moe_smoke_serves_on_cpu_with_no_launch():
    """The smoke fleet completes every request across the preemption, and
    on the CPU no kernel is launched."""
    from repro_torch.serving.live import make_prompts, serve_fleet

    cfg = t_smoke("qwen3-moe-30b")
    model = t_build(cfg, device="cpu")
    prompts = make_prompts(cfg, n=4, min_len=3, max_len=11, seed=2, device="cpu")
    ops.reset_launch_counts()
    res = serve_fleet(model, prompts, replicas=2, out_tokens=5, kill_step=2,
                      dtype=torch.float32, log=lambda s: None)
    assert sorted(res.completed) == sorted(prompts)
    assert all(len(t) == 6 for t in res.completed.values())
    assert res.retried and res.prefills == len(prompts) + len(res.retried)
    assert all(fn.launches == 0 for fn in ops.KERNEL_WRAPPERS)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b", "phi3.5-moe-42b"])
def test_live_entry_point_serves_moe_smoke_on_cpu(arch, capsys):
    from repro_torch.serving import live

    live.main(["--arch", arch, "--smoke", "--device", "cpu"])
    assert "served 8 requests" in capsys.readouterr().out


def test_gmm_launch_refuses_what_the_kernel_does_not_take():
    """Checked before any build: a CPU tensor, mismatched shapes or types,
    and a last axis without unit stride."""
    x, w = torch.zeros((4, 3, 8)), torch.zeros((4, 8, 5))
    with pytest.raises(ValueError, match="CUDA"):
        tgmm.launch(x, w)
    with pytest.raises(ValueError, match="does not match"):
        tgmm.launch(x, w[:, :4])
    with pytest.raises(ValueError, match=r"\(E, C, D\)"):
        tgmm.launch(x[0], w)
    with pytest.raises(TypeError):
        tgmm.launch(x.half(), w.half())
    with pytest.raises(TypeError):
        tgmm.launch(x, w.bfloat16())
    with pytest.raises(ValueError, match="unit stride"):
        tgmm.launch(x, torch.zeros((4, 5, 8)).transpose(1, 2))
