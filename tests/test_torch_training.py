"""The port's train path (``repro_torch.training``, ``distributed.compression``,
the models' ``loss``, ``launch.steps.build_train_step``, the train CLI) and
its prefill step against the reference.

Inputs come from numpy seeds; weights from the reference's ``init``,
carried across by ``params_from_jax``, and gradients and updated
parameters come back through the same function, leaf by leaf.  Everything
runs in float32 on both sides (``dtype=float32`` for the loss; the
reference's train step gets a loss with float32 activations, as its
``make_loss_fn`` passes no dtype).  Smoke configs at B = 2, S = 16; zamba2
is the 14-layer config of ``test_torch_hybrid.py``.

Tolerances: the optimizer 1e-6 relative; compression to the bit; data to
the bit; ``blockwise_attention`` 2e-5 (the reference's float32 attention
tolerance), its input gradients 1e-4; the loss 1e-5 relative, every
gradient rtol 1e-4 / atol 1e-6; two train steps: loss and grad norm 1e-4
relative, every parameter's delta within 1e-4 of the reference's delta's
norm, per leaf (see ``test_train_step_matches_reference`` for the
elements whose first moments differ).
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.train_loop import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.distributed import compression as tcomp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    PrefillStep,
    build_prefill_step,
    build_train_step,
)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.lm import chunked_ce  # noqa: E402
from repro_torch.models.registry import build_model as t_build  # noqa: E402
from repro_torch.training import data as tdata  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training.train_loop import make_train_step  # noqa: E402

B, S = 2, 16
ARCHS = ["llama3.2-1b", "qwen3-moe-30b", "falcon-mamba-7b", "zamba2-7b",
         "paligemma-3b", "whisper-medium"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small ops.  Under the suite's parallel workers
    every worker's intra-op threads oversubscribe the cores and each small
    op waits on them (a 0.6 s test took 35 s); one thread a worker keeps
    them fast.  The count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().copy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _configs(arch):
    if arch == "zamba2-7b":
        return (j_config(arch).scaled(num_layers=14),
                t_config(arch).scaled(num_layers=14))
    return j_smoke(arch), t_smoke(arch)


def _tree_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """(jcfg, tcfg, reference model, its float32 params)."""
    jcfg, tcfg = _configs(arch)
    jmodel = j_build(jcfg)                         # impl="blockwise"
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    return jcfg, tcfg, jmodel, params


def _port(arch, *, remat=False):
    jcfg, tcfg, _, params = _reference(arch)
    model = t_build(tcfg, impl="blockwise", remat=remat, device="cpu")
    model.load_state_dict(params_from_jax(_tree_np(params)))
    return model.requires_grad_(True)


def _batch(cfg, seed=0):
    return tdata.make_batch(cfg, B, S, seed=seed, step=0, dtype=torch.float32,
                            device="cpu")


def _jbatch(batch):
    return {k: jnp.asarray(v.numpy().astype(np.int32 if k in ("tokens", "labels")
                                            else np.float32))
            for k, v in batch.items()}


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def _random_tree(seed, dtype):
    rng = np.random.default_rng(seed)
    shapes = {"w": (8, 12), "b": (12,), "e": (3, 4, 5)}
    return {k: rng.standard_normal(s, dtype=np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """Three steps of random gradients, warmup 2 (the first clipped):
    parameters, m and v within 1e-6 of each tensor's largest magnitude."""
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
                  grad_clip=1.0)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    p0 = _random_tree(0, dtype)
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in p0.items()}
    jst, tst = jopt.adamw_init(jp), topt.adamw_init(tp)
    for step in range(3):
        g = _random_tree(10 + step, dtype)
        jg = {k: jnp.asarray(v) * (3.0 if step == 0 else 0.1) for k, v in g.items()}
        tg = {k: torch.from_numpy(v) * (3.0 if step == 0 else 0.1) for k, v in g.items()}
        jp, jst = jopt.adamw_update(jopt.AdamWConfig(**cfg_kw), jg, jst, jp)
        tp, tst = topt.adamw_update(topt.AdamWConfig(**cfg_kw), tg, tst, tp)
        assert int(tst["step"]) == int(jst["step"]) == step + 1
        for k in p0:
            assert tp[k].dtype == tdt
            assert _rel(_np(tp[k]), _np(jp[k])) <= 1e-6, k
            for mom in ("m", "v"):
                assert tst[mom][k].dtype == torch.float32
                assert _rel(_np(tst[mom][k]), _np(jst[mom][k])) <= 1e-6, (mom, k)


def test_adamw_in_place_equals_functional():
    p0 = _random_tree(1, "float32")
    tp = {k: torch.from_numpy(v) for k, v in p0.items()}
    cfg = topt.AdamWConfig(warmup_steps=0)
    g = {k: torch.from_numpy(v) for k, v in _random_tree(2, "float32").items()}
    new_p, new_st = topt.adamw_update(cfg, g, topt.adamw_init(tp), tp)
    assert all(np.array_equal(_np(tp[k]), p0[k]) for k in p0)   # untouched
    st = topt.adamw_init(tp)
    topt.adamw_update_(cfg, g, st, tp)
    for k in p0:
        assert torch.equal(tp[k], new_p[k]) and torch.equal(st["m"][k], new_st["m"][k])


@pytest.mark.parametrize("step", [0, 3, 10, 55, 100, 250])
def test_lr_schedule_matches_reference(step):
    """Step 0, inside the warmup, its end, mid-decay, the end, past it."""
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    want = float(jopt.lr_schedule(jopt.AdamWConfig(**cfg), jnp.asarray(step)))
    got = float(topt.lr_schedule(topt.AdamWConfig(**cfg), torch.tensor(step)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-9)


def test_global_norm_and_clipping_match_reference():
    g = _random_tree(3, "float32")
    want = float(jopt.global_norm({k: jnp.asarray(v) for k, v in g.items()}))
    got = float(topt.global_norm(torch.from_numpy(v) for v in g.values()))
    assert got == pytest.approx(want, rel=1e-6)
    # a gradient of norm 100 clipped to 1: the first moment reflects it
    cfg = dict(lr=0.0, grad_clip=1.0, warmup_steps=0)
    _, st = topt.adamw_update(topt.AdamWConfig(**cfg), {"w": torch.full((3,), 100.0)},
                              topt.adamw_init({"w": torch.zeros(3)}),
                              {"w": torch.zeros(3)})
    _, jst = jopt.adamw_update(jopt.AdamWConfig(**cfg), {"w": jnp.full(3, 100.0)},
                               jopt.adamw_init({"w": jnp.zeros(3)}),
                               {"w": jnp.zeros(3)})
    np.testing.assert_allclose(_np(st["m"]["w"]), _np(jst["m"]["w"]), rtol=1e-6)
    assert float(st["m"]["w"].abs().max()) <= (1 - 0.9) * 1.0 + 1e-6


def test_adamw_descends_quadratic():
    cfg = topt.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                           weight_decay=0.0, grad_clip=10.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = topt.adamw_init(params)
    for _ in range(60):
        topt.adamw_update_(cfg, {"w": 2 * params["w"]}, opt, params)
    assert float(params["w"].abs().max()) < 0.5


@pytest.mark.parametrize("logical,shape,data,want", [
    (("embed", "mlp"), (1024, 4096), 16, ("zero", "mlp")),
    (("vocab", "embed"), (32000, 1024), 16, ("vocab", "zero")),
    ((None,), (7,), 16, (None,)),
])
def test_zero1_logical_matches_reference(logical, shape, data, want):
    assert topt.zero1_logical(logical, shape, data) == want
    assert jopt.zero1_logical(logical, shape, data) == want


def test_zero1_logical_tree_matches_reference():
    from repro.models import logical_axes
    from repro.models.base import abstract_params

    jmodel = j_build(j_smoke("llama3.2-1b"))
    bp = jmodel.blueprint()
    logical, ab = logical_axes(bp), abstract_params(bp, jnp.float32)
    want = jopt.zero1_logical_tree(logical, ab, 2)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), ab)
    got = topt.zero1_logical_tree(logical, shapes, 2)
    assert got == want


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


def test_ef_quantize_tree_bit_equal_to_reference():
    """Two steps with the error carried: g_hat and the error equal to the
    bit in float32."""
    rng = np.random.default_rng(4)
    grads = [{"a": rng.standard_normal((64,), dtype=np.float32),
              "b": np.zeros(8, np.float32),
              "c": rng.standard_normal((5, 7), dtype=np.float32) * 1e-3}
             for _ in range(2)]
    jerr = terr = None
    for g in grads:
        jg, jerr = jcomp.ef_quantize_tree({k: jnp.asarray(v) for k, v in g.items()}, jerr)
        tg, terr = tcomp.ef_quantize_tree({k: torch.from_numpy(v) for k, v in g.items()},
                                          terr)
        for k in g:
            assert np.array_equal(_np(tg[k]), _np(jg[k])), k
            assert np.array_equal(_np(terr[k]), _np(jerr[k])), k
    # stacked leaves: one scale over every layer's slice, as the reference's
    stack = rng.standard_normal((3, 6, 4), dtype=np.float32) * np.array(
        [1.0, 1e-2, 1e-4], np.float32)[:, None, None]
    jg, _ = jcomp.ef_quantize_tree({"w": jnp.asarray(stack)}, None)
    tg, _ = tcomp.ef_quantize_tree(
        {f"layers.{i}.w": torch.from_numpy(stack[i]) for i in range(3)}, None)
    for i in range(3):
        assert np.array_equal(_np(tg[f"layers.{i}.w"]), np.asarray(jg["w"])[i])
    assert tcomp.stacked_group("blocks.1.2.mixer.D") == "blocks.*.*.mixer.D"
    q, scale = tcomp.quantize_int8(torch.from_numpy(grads[0]["a"]))
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127
    assert tcomp.compression_ratio(4096) == jcomp.compression_ratio(4096)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-medium", "paligemma-3b"])
def test_make_batch_matches_reference(arch):
    jcfg, tcfg = _configs(arch)
    for step in (0, 3):
        want = jdata.make_batch(jcfg, 3, 10, seed=5, step=step)
        got = tdata.make_batch(tcfg, 3, 10, seed=5, step=step, device="cpu")
        assert set(got) == set(want)
        for k in ("tokens", "labels"):
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
        for k in set(got) - {"tokens", "labels"}:
            assert got[k].dtype == torch.bfloat16
            assert np.array_equal(_np(got[k]), _np(want[k])), k
    ab = tdata.abstract_batch(tcfg, 3, 10)
    assert {k: (tuple(v.shape), v.device.type) for k, v in ab.items()} == {
        k: (tuple(v.shape), "meta") for k, v in got.items()}
    stream = tdata.synthetic_batches(tcfg, 3, 10, seed=5, start_step=3, device="cpu")
    assert torch.equal(next(stream)["tokens"], got["tokens"])


# ---------------------------------------------------------------------------
# blockwise attention
# ---------------------------------------------------------------------------

ATTN_CASES = {
    # name: (Sq, Skv, H, Kv, causal, window, prefix, q_block, kv_block)
    "causal": (24, 24, 4, 2, True, None, 0, 8, 8),
    "window": (24, 24, 4, 2, True, 6, 0, 8, 16),
    "prefix": (24, 24, 4, 1, True, None, 6, 8, 8),
    "cross": (10, 33, 4, 4, False, None, 0, 4, 8),
    "triangle": (32, 32, 4, 2, True, None, 0, 4, 8),
    "triangle_prefix": (32, 32, 2, 2, True, None, 8, 4, 4),
}


def _qkv(Sq, Skv, H, Kv, D=8, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, Sq, H, D), dtype=np.float32),
            rng.standard_normal((2, Skv, Kv, D), dtype=np.float32),
            rng.standard_normal((2, Skv, Kv, D), dtype=np.float32))


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_blockwise_attention_matches_reference(case):
    """Outputs within 2e-5, and the gradients of sum(out * w) with respect
    to q, k and v within 1e-4 of ``jax.grad``'s."""
    Sq, Skv, H, Kv, causal, window, prefix, qb, kb = ATTN_CASES[case]
    q, k, v = _qkv(Sq, Skv, H, Kv)
    w = np.random.default_rng(1).standard_normal((2, Sq, H, 8), dtype=np.float32)
    kw = dict(causal=causal, window=window, prefix_len=prefix, q_block=qb,
              kv_block=kb)

    def jfn(q, k, v):
        out = jattn.blockwise_attention(
            q, k, v, q_pos=jnp.arange(Sq, dtype=jnp.int32),
            kv_pos=jnp.arange(Skv, dtype=jnp.int32), **kw)
        return jnp.sum(out * w), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tattn.blockwise_attention(tq, tk, tv, q_pos=torch.arange(Sq),
                                    kv_pos=torch.arange(Skv), **kw)
    np.testing.assert_allclose(_np(out), _np(jout), atol=2e-5, rtol=2e-5)
    (out * torch.from_numpy(w)).sum().backward()
    for t, want in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(_np(t.grad), _np(want), atol=1e-4, rtol=1e-4)
    if case.startswith("triangle"):     # the split ran, and equals no split
        flat = tattn.blockwise_attention(tq, tk, tv, q_pos=torch.arange(Sq),
                                         kv_pos=torch.arange(Skv),
                                         causal_split=0, **kw)
        np.testing.assert_allclose(_np(out), _np(flat), atol=2e-6, rtol=2e-6)


def test_blockwise_window_visits_each_block_once():
    """Where the window spans fewer KV blocks than the sequence, the
    reference's clipped block list visits block 0 more than once and
    leaves its own oracle; the port equals the oracle."""
    S, w = 64, 8
    q, k, v = _qkv(S, S, 2, 1)
    pos = jnp.arange(S, dtype=jnp.int32)
    naive = jattn.naive_attention(*map(jnp.asarray, (q, k, v)), q_pos=pos,
                                  kv_pos=pos, window=w)
    ref = jattn.blockwise_attention(*map(jnp.asarray, (q, k, v)), q_pos=pos,
                                    kv_pos=pos, window=w, q_block=8, kv_block=8)
    got = tattn.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                    q_pos=torch.arange(S), kv_pos=torch.arange(S),
                                    window=w, q_block=8, kv_block=8)
    np.testing.assert_allclose(_np(got), _np(naive), atol=2e-5, rtol=2e-5)
    assert float(np.abs(_np(ref) - _np(naive)).max()) > 0.1


# ---------------------------------------------------------------------------
# the Mamba-1 doubling scan, chunked CE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Q", [1, 5, 8, 13])
def test_doubling_scan_equals_the_plain_scan(Q):
    from repro_torch.kernels import selective_scan as _ss

    rng = np.random.default_rng(Q)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, Q, 3, 4)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, Q, 3, 4), dtype=np.float32))
    h0 = torch.from_numpy(rng.standard_normal((2, 3, 4), dtype=np.float32))
    want = _ss.plain(a, b, h0)
    np.testing.assert_allclose(_np(tssm.doubling_scan(a, b, h0)), _np(want),
                               atol=1e-6, rtol=1e-5)


def test_chunked_ce_is_the_mean_token_ce():
    """Against a full-vocabulary CE, with a ragged last chunk (where the
    reference would count its padded positions)."""
    cfg = t_smoke("llama3.2-1b")
    rng = np.random.default_rng(6)
    h = torch.from_numpy(rng.standard_normal((2, 11, cfg.d_model), dtype=np.float32))
    emb = torch.from_numpy(rng.standard_normal((cfg.padded_vocab, cfg.d_model),
                                               dtype=np.float32) * 0.1)
    lab = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 11)))
    logits = (h @ emb.T)[..., :cfg.vocab_size]
    want = torch.nn.functional.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                                             lab.reshape(-1))
    for chunk in (4, 11, 512):
        got = chunked_ce(h, lab, cfg, embedding=emb, unembed=None, chunk=chunk)
        assert float(got) == pytest.approx(float(want), rel=1e-6)


# ---------------------------------------------------------------------------
# loss and gradients against jax.value_and_grad
# ---------------------------------------------------------------------------


def _jloss_fn(arch):
    jcfg, _, jmodel, _ = _reference(arch)

    def fn(params, batch):
        if jcfg.is_encdec:
            return jmodel.loss(params, batch["frames"], batch["tokens"],
                               batch["labels"], dtype=jnp.float32)
        return jmodel.loss(params, batch["tokens"], batch["labels"],
                           prefix_embed=batch.get("patches"), dtype=jnp.float32)
    return fn


def _tloss(model, batch):
    if model.cfg.is_encdec:
        return model.loss(batch["frames"], batch["tokens"], batch["labels"],
                          dtype=torch.float32)
    return model.loss(batch["tokens"], batch["labels"],
                      prefix_embed=batch.get("patches"), dtype=torch.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    _, tcfg, _, params = _reference(arch)
    batch = _batch(tcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(_jloss_fn(arch)))(params, _jbatch(batch))
    want = params_from_jax(_tree_np(jgrads))
    grads = {}
    for remat in (False, True):
        model = _port(arch, remat=remat)
        loss = _tloss(model, batch)
        assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
        names, tensors = zip(*model.named_parameters())
        grads[remat] = dict(zip(names, torch.autograd.grad(loss, tensors)))
    assert set(grads[False]) == set(want)
    for k, g in grads[False].items():
        np.testing.assert_allclose(_np(g), _np(want[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
        assert torch.equal(grads[True][k], g), k
    if tcfg.is_moe:       # the aux loss is in the loss
        model = _port(arch)
        with torch.no_grad():
            _, aux = model.forward_aux(batch["tokens"], dtype=torch.float32)
        assert float(aux) > 0


# ---------------------------------------------------------------------------
# the train step against the reference's make_train_step
# ---------------------------------------------------------------------------

# microbatches 1 and 2, compression off and on, both accumulators
STEP_CASES = {
    "mb1": dict(microbatches=1),
    "mb2_compressed": dict(microbatches=2, compress_grads=True),
    "mb2_bf16_local": dict(microbatches=2, grad_accum="bf16_local"),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_reference(case):
    """Two steps, warmup 1 (so the first update is not zero): loss, grad
    norm and step within 1e-4 relative, and each parameter's delta from
    its start within 1e-4 of the reference's delta's norm, per leaf.

    Adam's first step moves an element by lr x g / (|g| + eps): where the
    gradient is at the float32 noise floor (|g| < 1e-6; the reference's jit
    and eager runs disagree there themselves) or where an int8 code sits on
    a rounding boundary and the two sides quantise it one step apart (two
    after a carried error), the gradients the optimizer sees differ there
    and so may the element's delta.  Such elements are told apart by the
    gradients recovered from the first moments; each must stay within 3 x
    (lr_1 + lr_2) of the reference's delta (the most two steps can move
    it), there may be at most max(2, 1 %) of a leaf's, and the norm test
    covers the rest.  With compression the grad norm may differ by the
    norm of the flipped codes' differences besides."""
    kw = STEP_CASES[case]
    arch = "llama3.2-1b"
    jcfg, tcfg, _, params = _reference(arch)
    jmodel = j_build(jcfg)
    jmodel.loss = functools.partial(type(jmodel).loss, jmodel, dtype=jnp.float32)
    ocfg = dict(warmup_steps=1, total_steps=10)
    jstep = jax.jit(j_make_train_step(jmodel, jcfg, jopt.AdamWConfig(**ocfg), **kw))
    jp, jst = params, jopt.adamw_init(params)

    model = _port(arch)
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    st = topt.adamw_init(dict(model.named_parameters()))
    step = make_train_step(model, topt.AdamWConfig(**ocfg), dtype=torch.float32, **kw)
    unstable = {k: np.zeros(p.shape, bool) for k, p in start.items()}
    prev = {k: (np.zeros(p.shape, np.float32),) * 2 for k, p in start.items()}
    last_code = dict.fromkeys(start, 0.0)
    for i in range(2):
        batch = tdata.make_batch(tcfg, 4, S, seed=1, step=i, dtype=torch.float32,
                                 device="cpu")
        jp, jst, jm = jstep(jp, jst, _jbatch(batch))
        m = step(st, batch)
        assert int(m["step"]) == int(jm["step"]) == i + 1
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
        jmom = params_from_jax(_tree_np(jst["m"]))
        # the step's gradients as the optimizer saw them, from m
        seen = {}
        for k in unstable:
            mt, mr = _np(st["m"][k]), _np(jmom[k])
            seen[k] = [(a - 0.9 * b) / 0.1 for a, b in zip((mt, mr), prev[k])]
            prev[k] = (mt, mr)
        # an int8 code step of each stacked leaf (the reference's scale)
        code = {}
        for k, (_, gr) in seen.items():
            group = tcomp.stacked_group(k)
            code[group] = max(code.get(group, 0.0), np.abs(gr).max() / 127)
        flipped = 0.0
        for k, u in unstable.items():
            gt, gr = seen[k]
            off = np.abs(gt - gr) > 1e-4 * np.abs(gr).max()
            if kw.get("compress_grads"):
                # a code on a rounding boundary rounds one step apart; its
                # carried error moves the next step's input by that step
                c = code[tcomp.stacked_group(k)]
                bound = 1.01 * (c + last_code[k])
                assert np.abs(gt - gr)[off].max(initial=0) <= bound, k
                last_code[k] = c
                flipped += float(np.square(gt - gr)[off].sum())
            u |= off
            if i == 0:      # g / (|g| + eps) where |g| is near eps
                ratio = [g / (np.abs(g) + 1e-8) for g in (gt, gr)]
                u |= np.abs(ratio[0] - ratio[1]) > 1e-3
        # |norm(a) - norm(b)| <= norm(a - b): the flipped codes' share
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= (
            1e-4 * float(jm["grad_norm"]) + flipped ** 0.5)
    assert ("ef_error" in st) == ("ef_error" in jst) == bool(kw.get("compress_grads"))
    lrs = sum(float(topt.lr_schedule(topt.AdamWConfig(**ocfg), torch.tensor(t)))
              for t in (1, 2))
    want = params_from_jax(_tree_np(jp))
    for k, p in model.named_parameters():
        d_got = _np(p) - _np(start[k])
        d_want = _np(want[k]) - _np(start[k])
        u = unstable[k]
        assert u.sum() <= max(2, 1e-2 * u.size), (k, int(u.sum()))
        assert np.abs(d_got - d_want)[u].max(initial=0) <= 3 * lrs, k
        assert (np.linalg.norm((d_got - d_want)[~u])
                <= 1e-4 * np.linalg.norm(d_want) + 1e-12), k


def test_build_train_step_trains_bf16_params_with_fp32_moments():
    cfg = t_smoke("llama3.2-1b")
    step = build_train_step(cfg, microbatches=2, device="cpu",
                            opt_cfg=topt.AdamWConfig(warmup_steps=1))
    model = step.model
    assert model.impl == "blockwise" and model.remat
    assert all(p.dtype == torch.bfloat16 and p.requires_grad
               for p in model.parameters())
    assert all(t.dtype == torch.float32 for t in step.opt_state["m"].values())
    before = {k: p.detach().clone() for k, p in step.params.items()}
    losses = []
    for i in range(3):
        m = step(tdata.make_batch(cfg, 4, S, step=i, device="cpu"))
        losses.append(float(m["loss"]))
        assert np.isfinite(float(m["grad_norm"]))
    assert int(m["step"]) == 3 and all(np.isfinite(losses))
    assert any(not torch.equal(before[k], p) for k, p in step.params.items())


def test_train_step_refuses_bad_settings():
    model = t_build(t_smoke("llama3.2-1b"), impl="blockwise", device="cpu")
    with pytest.raises(ValueError, match="no trainable"):
        make_train_step(model, topt.AdamWConfig())
    model.requires_grad_(True)
    with pytest.raises(ValueError, match="grad_accum"):
        make_train_step(model, topt.AdamWConfig(), grad_accum="f16")
    step = make_train_step(model, topt.AdamWConfig(), microbatches=3)
    with pytest.raises(ValueError, match="divisible"):
        step(topt.adamw_init(dict(model.named_parameters())),
             tdata.make_batch(model.cfg, 4, S, device="cpu"))


# ---------------------------------------------------------------------------
# the kernel wrappers refuse what needs a gradient
# ---------------------------------------------------------------------------


def test_kernel_wrappers_refuse_inputs_that_need_grad():
    q = torch.randn(1, 4, 2, 8, requires_grad=True)
    k, v = torch.randn(1, 4, 2, 8), torch.randn(1, 4, 2, 8)
    calls = {
        "flash_attention": lambda: ops.flash_attention(q, k, v),
        "flash_decode": lambda: ops.flash_decode(
            q[:, :1], k, v, kv_valid=torch.ones(1, 4, dtype=torch.bool)),
        "selective_scan": lambda: ops.selective_scan(
            torch.rand(1, 3, 2, 2, requires_grad=True), torch.rand(1, 3, 2, 2),
            torch.zeros(1, 2, 2)),
        "moe_gmm": lambda: ops.moe_gmm(torch.randn(2, 3, 4),
                                       torch.randn(2, 4, 5, requires_grad=True)),
        "moe_ffn": lambda: ops.moe_ffn(
            torch.randn(2, 3, 4), torch.randn(2, 4, 5, requires_grad=True), None,
            torch.randn(2, 5, 4)),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}: an input requires grad"):
            call()
        with torch.no_grad():
            assert call().grad_fn is None
    # a trainable model on the kernel path raises instead of losing the gradient
    model = t_build(t_smoke("llama3.2-1b"), device="cpu").requires_grad_(True)
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(RuntimeError, match="flash_attention"):
        model.loss(toks, toks, dtype=torch.float32)


# ---------------------------------------------------------------------------
# the prefill step (eager on the CPU)
# ---------------------------------------------------------------------------


def _cache_leaves(cache):
    for key, value in cache.items():
        if isinstance(value, torch.Tensor):
            yield key, value
        else:
            for name, t in value.items():
                yield f"{key}.{name}", t


@pytest.mark.parametrize("arch", ["llama3.2-1b", "falcon-mamba-7b",
                                  "qwen3-moe-30b", "whisper-medium", "paligemma-3b"])
def test_prefill_step_equals_model_prefill(arch):
    """Two calls of the step, the second over a cache the first filled,
    each equal to ``model.prefill`` into a fresh cache: logits and every
    cache tensor equal to the bit; no launch is counted on the CPU."""
    cfg = t_smoke(arch)
    model = t_build(cfg, device="cpu")
    extra = cfg.frontend_seq if cfg.frontend and not cfg.is_encdec else 0
    max_len = S + extra + 4
    cache = model.init_cache(1, max_len, dtype=torch.float32)
    step = build_prefill_step(model, cache, S, dtype=torch.float32)
    assert isinstance(step, PrefillStep) and step.graph is None
    ops.reset_launch_counts()
    rng = np.random.default_rng(8)
    for call in range(2):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, S)))
        front = torch.from_numpy(rng.standard_normal(
            (1, cfg.frontend_seq, cfg.d_model), dtype=np.float32))
        fresh = model.init_cache(1, max_len, dtype=torch.float32)
        if cfg.is_encdec:
            got = step(toks, frames=front)
            want, _ = model.prefill(front, toks, fresh, dtype=torch.float32)
        elif extra:
            got = step(toks, patches=front)
            want, _ = model.prefill(toks, fresh, prefix_embed=front,
                                    dtype=torch.float32)
        else:
            got = step(toks)
            want, _ = model.prefill(toks, fresh, dtype=torch.float32)
        assert got is step.logits and torch.equal(got, want), call
        for (k, t), (_, w) in zip(_cache_leaves(cache), _cache_leaves(fresh)):
            assert torch.equal(t, w), (call, k)
    assert all(fn.launches == 0 for fn in ops.KERNEL_WRAPPERS)
    with pytest.raises(ValueError, match="built for"):
        step(torch.zeros((1, S + 1), dtype=torch.long),
             **({"frames": front} if cfg.is_encdec else
                {"patches": front} if extra else {}))


def test_prefill_step_refuses_what_it_was_not_built_for():
    cfg = t_smoke("llama3.2-1b")
    model = t_build(cfg, device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        build_prefill_step(model, model.init_cache(1, 8), 9)
    step = build_prefill_step(model, model.init_cache(1, 8), 8)
    with pytest.raises(ValueError, match="has no patches"):
        step(torch.zeros((1, 8), dtype=torch.long),
             patches=torch.zeros((1, 2, cfg.d_model)))


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------


def test_train_cli_runs_and_resumes(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    argv = ["--device", "cpu", "--scale", "smoke", "--ckpt-dir", d,
            "--ckpt-every", "2", "--batch", "2", "--seq", "16"]
    assert train_cli.main(argv + ["--steps", "4"]) == 0
    first = capsys.readouterr().out
    assert "[train] step    0 loss" in first and "resumed" not in first
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000004"]
    assert train_cli.main(argv + ["--steps", "6", "--microbatches", "2"]) == 0
    second = capsys.readouterr().out
    assert "[train] resumed from step 4" in second
    assert "[train] 2 steps in" in second and "[train] step    5 loss" in second
