"""The cache length on the device, and the serve step, against the reference.

The port keeps ``cache["len"]`` as an int32 device tensor of shape (), as
the reference does: ``prefill`` sets it, ``decode_step`` builds its
positions, cache slot and valid mask from it and advances it in place.  At
smoke widths in float32, 40 greedy decode steps from the reference's
converted weights pick the reference's tokens, with caches within the
reference's 2e-5, for llama3.2-1b, qwen3-moe-30b, falcon-mamba-7b,
h2o-danube3-4b, whose 64-slot sliding-window ring wraps (32 prompt tokens
plus 40 steps), and zamba2-7b's hybrid at 14 layers (two prelude Mamba-2
layers, two super-blocks of the shared attention block and five Mamba-2
layers), whose cache holds Mamba-2 states and one KV slice per
application of the shared block.  On the CPU the serve step (``repro_torch.launch.steps``)
runs eagerly and equals ``decode_step`` plus ``argmax`` bit for bit; the
live replica keeps the length on the host, raises "cache full" from it, and
reuses its cache slots.  The captured step runs only on the card
(``tests/test_torch_cuda.py``).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.steps import ServeStep, build_serve_step  # noqa: E402
from repro_torch.models.registry import build_model as t_build  # noqa: E402
from repro_torch.serving.live import LiveReplica  # noqa: E402

ARCHS = ["llama3.2-1b", "qwen3-moe-30b", "falcon-mamba-7b", "h2o-danube3-4b",
         "zamba2-7b"]
HYBRID_LAYERS = 14          # zamba2: 2 prelude layers, 2 super-blocks
B, S, STEPS, MAX_LEN = 2, 32, 40, 80
TOL = 2e-5          # the reference's float32 attention / cache tolerance


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _configs(arch):
    if arch == "zamba2-7b":
        return (j_config(arch).scaled(num_layers=HYBRID_LAYERS),
                t_config(arch).scaled(num_layers=HYBRID_LAYERS))
    return j_smoke(arch), t_smoke(arch)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jcfg, tcfg = _configs(arch)
    jmodel = j_build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tmodel = t_build(tcfg, device="cpu")
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), params)
    tmodel.load_state_dict(params_from_jax(tree))
    return jcfg, jmodel, params, tmodel


def _tokens(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n))


def _leaves(cache):
    """Every tensor of a cache but the length, by "group/name"."""
    return {f"{g}/{n}": t for g, group in cache.items() if g != "len"
            for n, t in group.items()}


def _assert_caches(tcache, jcache):
    tl, jl = _leaves(tcache), _leaves(jcache)
    assert sorted(tl) == sorted(jl)
    for k in tl:
        np.testing.assert_allclose(_np(tl[k]), _np(jl[k]), atol=TOL, rtol=TOL,
                                   err_msg=k)
    assert int(tcache["len"]) == int(jcache["len"])


@pytest.mark.parametrize("arch", ARCHS)
def test_device_length_decode_matches_reference(arch):
    jcfg, jmodel, params, tmodel = _pair(arch)
    toks = _tokens(jcfg, S)
    prefill = jax.jit(functools.partial(jmodel.prefill, dtype=jnp.float32))
    decode = jax.jit(functools.partial(jmodel.decode_step, dtype=jnp.float32))
    jlog, jcache = prefill(params, jnp.asarray(toks),
                           jmodel.init_cache(B, MAX_LEN, jnp.float32))
    tcache = tmodel.init_cache(B, MAX_LEN, dtype=torch.float32)
    length = tcache["len"]
    assert length.shape == () and length.dtype == torch.int32
    tlog, tcache = tmodel.prefill(torch.from_numpy(toks), tcache,
                                  dtype=torch.float32)
    _assert_caches(tcache, jcache)
    if arch == "h2o-danube3-4b":             # the ring the steps wrap
        assert tcache["kv"]["k"].shape[2] == 64 < S + STEPS

    jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
    ttok = tlog.argmax(-1)
    for step in range(STEPS):
        assert np.array_equal(ttok.numpy(), np.asarray(jtok)), f"step {step}"
        jlog, jcache = decode(params, jtok, jcache)
        tlog, tcache = tmodel.decode_step(ttok, tcache, dtype=torch.float32)
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ttok = tlog.argmax(-1)
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    _assert_caches(tcache, jcache)
    assert tcache["len"] is length and int(length) == S + STEPS


def _prefilled(tmodel, arch, seed=3):
    toks = torch.from_numpy(_tokens(tmodel.cfg, 12, seed))
    cache = tmodel.init_cache(B, MAX_LEN, dtype=torch.float32)
    logits, cache = tmodel.prefill(toks, cache, dtype=torch.float32)
    return logits.argmax(-1), cache


def _clone(cache):
    return {"len": cache["len"].clone(),
            **{k: {n: t.clone() for n, t in v.items()}
               for k, v in cache.items() if k != "len"}}


@pytest.mark.parametrize("arch", ARCHS)
def test_cpu_serve_step_equals_decode_step(arch):
    tmodel = _pair(arch)[3]
    tok, cache = _prefilled(tmodel, arch)
    other = _clone(cache)
    ops.reset_launch_counts()
    step = build_serve_step(tmodel, other, dtype=torch.float32)
    assert isinstance(step, ServeStep) and step.graph is None
    assert int(other["len"]) == 12            # eager: nothing ran at build
    want = tok
    for i in range(6):
        got = step(tok) if i == 0 else step()   # then its own last token
        logits, cache = tmodel.decode_step(want, cache, dtype=torch.float32)
        want = logits.argmax(-1)
        assert torch.equal(got, want) and torch.equal(step.logits, logits)
        assert got is step.tokens
    for k, t in _leaves(cache).items():
        assert torch.equal(_leaves(other)[k], t), k
    assert int(other["len"]) == int(cache["len"]) == 12 + 6
    assert all(fn.launches == 0 for fn in ops.KERNEL_WRAPPERS)


def test_prefill_sets_and_reset_clears_the_device_length():
    tmodel = _pair("falcon-mamba-7b")[3]
    _, cache = _prefilled(tmodel, "falcon-mamba-7b")
    assert int(cache["len"]) == 12
    assert any(bool(t.abs().sum() > 0) for t in _leaves(cache).values())
    length = cache["len"]
    tmodel.reset_cache(cache)
    assert cache["len"] is length and int(length) == 0
    assert all(bool(t.eq(0).all()) for t in _leaves(cache).values())


def test_replica_raises_cache_full_from_its_host_length():
    tmodel = _pair("llama3.2-1b")[3]
    prompt = torch.from_numpy(_tokens(tmodel.cfg, 14)[0])
    rep = LiveReplica("r", tmodel, max_len=16, dtype=torch.float32, slots=1)
    assert tmodel.cache_capacity(rep.free[0][0]) == 16
    rep.submit(0, prompt, out_tokens=5)
    rep.step()
    rep.step()                                 # the cache now holds 16
    with pytest.raises(ValueError, match="cache full"):
        rep.step()
    with pytest.raises(RuntimeError, match="slots"):
        rep.submit(1, prompt, out_tokens=1)


def test_ring_replica_decodes_past_its_slots():
    tmodel = _pair("h2o-danube3-4b")[3]
    prompt = torch.from_numpy(_tokens(tmodel.cfg, 14)[0])
    rep = LiveReplica("r", tmodel, max_len=16, dtype=torch.float32, slots=1)
    assert tmodel.cache_capacity(rep.free[0][0]) is None
    rep.submit(0, prompt, out_tokens=8)
    done = []
    while not done:
        done = rep.step()
    assert len(done[0][1]) == 9 and int(rep.free[0][0]["len"]) == 22


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "llama3.2-1b"])
def test_replica_slot_reuse_gives_fresh_cache_tokens(arch):
    """One slot serves three requests in turn: each gets the tokens of a
    fresh cache (a Mamba prefill starts from the states it finds, so the
    slot must be emptied between requests)."""
    tmodel = _pair(arch)[3]
    prompts = {i: torch.from_numpy(_tokens(tmodel.cfg, 9 + i, seed=i)[0])
               for i in range(3)}
    want = {}
    for i, p in prompts.items():
        cache = tmodel.init_cache(1, 32, dtype=torch.float32)
        logits, cache = tmodel.prefill(p[None], cache, dtype=torch.float32)
        tok, out = logits.argmax(-1), []
        out.append(int(tok[0, 0]))
        for _ in range(4):
            logits, cache = tmodel.decode_step(tok, cache, dtype=torch.float32)
            tok = logits.argmax(-1)
            out.append(int(tok[0, 0]))
        want[i] = out
    rep = LiveReplica("r", tmodel, max_len=32, dtype=torch.float32, slots=1)
    got = {}
    for i, p in prompts.items():
        rep.submit(i, p, out_tokens=4)
        done = []
        while not done:
            done = rep.step()
        got.update(done)
    assert got == want


def test_hybrid_reset_and_capacity():
    """A hybrid cache: prefill fills every group, ``reset_cache`` empties
    them in place, and the replica raises "cache full" at the attention
    slots (the Mamba-2 states never fill)."""
    tmodel = _pair("zamba2-7b")[3]
    _, cache = _prefilled(tmodel, "zamba2-7b")
    assert int(cache["len"]) == 12
    groups = {k.split("/")[0] for k, t in _leaves(cache).items()
              if bool(t.abs().sum() > 0)}
    assert groups == {"prelude_state", "block_state", "attn_kv"}
    tensors = _leaves(cache)
    tmodel.reset_cache(cache)
    assert int(cache["len"]) == 0 and _leaves(cache) == tensors
    assert all(bool(t.eq(0).all()) for t in tensors.values())
    prompt = torch.from_numpy(_tokens(tmodel.cfg, 14)[0])
    rep = LiveReplica("r", tmodel, max_len=16, dtype=torch.float32, slots=1)
    assert tmodel.cache_capacity(rep.free[0][0]) == 16
    rep.submit(0, prompt, out_tokens=5)
    rep.step()
    rep.step()
    with pytest.raises(ValueError, match="cache full"):
        rep.step()
