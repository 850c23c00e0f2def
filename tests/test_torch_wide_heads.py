"""The four dense archs the card serves at their own head widths and heads
(paligemma-3b: head_dim 256, 8 heads, 1 KV head, an image prefix under the
prefix-LM mask; h2o-danube3-4b: 120, 32 / 8, a sliding-window ring;
qwen2.5-3b: 128, 16 / 2, QKV bias; command-r-35b: 128, 64 / 8, the parallel
attention + MLP block), cut to 2 layers of width 256 with d_ff and the
vocabulary cut, against the reference on the CPU.

Both models get the same numpy-seeded weights (the reference's init tree,
each leaf moved by seeded noise so that zero-initialised biases are not
zero), carried over by ``params_from_jax``.  The reference runs its Pallas
kernels in interpret mode (``impl="pallas"``), the port its kernel wrappers
(their plain versions on the CPU), in float32: prefill logits within 1e-4,
caches within 1e-5, 8 greedy tokens equal (the reference's model-level
tolerances, ``test_torch_lm.py``).  Also: a smoke paligemma fleet on the
CPU whose preempted run gives the tokens of an unpreempted one, and the
profile CLI on the CPU writing a row for paligemma-3b and h2o-danube3-4b
at their full widths.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.registry import build_model as t_build  # noqa: E402

B, STEPS = 2, 8
WIDE_ARCHS = ["paligemma-3b", "h2o-danube3-4b", "qwen2.5-3b", "command-r-35b"]
# prompt length, cache slots and (danube) window: the ring's window is cut
# to 16 slots, so the 20-token prompt is written wrapped and decode keeps
# wrapping it
PROMPT = {"h2o-danube3-4b": 20}
WINDOW = 16
PATCHES = 8                       # paligemma's image prefix, cut from 256


def _cut(cfg):
    """2 layers of width 256, d_ff 512, vocabulary 512; the arch's own
    heads, KV heads and head width (set in each config)."""
    kw = dict(num_layers=2, d_model=256, d_ff=512, vocab_size=512)
    if cfg.sliding_window is not None:
        kw["sliding_window"] = WINDOW
    if cfg.frontend:
        kw["frontend_seq"] = PATCHES
    return dataclasses.replace(cfg, **kw)


def _models(arch):
    jcfg, tcfg = _cut(j_config(arch)), _cut(t_config(arch))
    assert (tcfg.resolved_head_dim, tcfg.num_heads, tcfg.num_kv_heads) == (
        jcfg.resolved_head_dim, jcfg.num_heads, jcfg.num_kv_heads)
    jmodel = j_build(jcfg, impl="pallas")
    rng = np.random.default_rng(WIDE_ARCHS.index(arch))
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32))
        + 0.02 * rng.standard_normal(a.shape).astype(np.float32),
        jmodel.init(jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tmodel = t_build(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(tree))
    return jcfg, jmodel, params, tmodel


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("arch", WIDE_ARCHS)
def test_prefill_decode_match_reference(arch):
    jcfg, jmodel, params, tmodel = _models(arch)
    S = PROMPT.get(arch, 12)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, S))
    n_pre = jcfg.frontend_seq if jcfg.frontend else 0
    front = np.random.default_rng(9).standard_normal(
        (B, n_pre, jcfg.d_model), dtype=np.float32)
    jfront = jnp.asarray(front) if n_pre else None
    tfront = torch.from_numpy(front) if n_pre else None
    max_len = n_pre + S + STEPS
    prefill = jax.jit(functools.partial(jmodel.prefill, dtype=jnp.float32))
    decode = jax.jit(functools.partial(jmodel.decode_step, dtype=jnp.float32))

    jlog, jcache = prefill(params, jnp.asarray(toks),
                           jmodel.init_cache(B, max_len, jnp.float32),
                           prefix_embed=jfront)
    tcache = tmodel.init_cache(B, max_len, dtype=torch.float32)
    tlog, tcache = tmodel.prefill(torch.from_numpy(toks), tcache,
                                  prefix_embed=tfront, dtype=torch.float32)
    slots = tcache["kv"]["k"].shape[2]
    if jcfg.sliding_window is not None:
        assert slots == WINDOW < S        # the prefill wrote the ring wrapped
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
        assert tcache["kv"][kv].shape == jcache["kv"][kv].shape
        np.testing.assert_allclose(_np(tcache["kv"][kv]), _np(jcache["kv"][kv]),
                                   atol=1e-5, rtol=1e-5)
    assert int(tcache["len"]) == int(jcache["len"]) == n_pre + S + STEPS


def test_paligemma_fleet_carries_its_prefix_across_the_preemption():
    """A smoke paligemma fleet on the CPU, each request with its seeded
    image prefix: replica 0 preempted at step 2, its requests re-prefilled
    on the survivor with the same prefix, every request's tokens those of
    an unpreempted run (one replica), and those of a plain greedy decode of
    the request alone."""
    from repro_torch.serving.live import make_frames, make_prompts, serve_fleet

    cfg = t_smoke("paligemma-3b")
    model = t_build(cfg, device="cpu")
    prompts = make_prompts(cfg, n=4, min_len=3, max_len=9, seed=4, device="cpu")
    patches = make_frames(cfg, prompts, seed=5, device="cpu")
    kw = dict(out_tokens=5, max_len=cfg.frontend_seq + 16, dtype=torch.float32,
              log=lambda s: None, frames=patches)
    killed = serve_fleet(model, prompts, replicas=2, kill_step=2, **kw)
    whole = serve_fleet(model, prompts, replicas=1, kill_step=0, **kw)
    assert killed.retried and not whole.retried
    assert killed.completed == whole.completed
    with torch.inference_mode():
        for rid, prompt in prompts.items():
            cache = model.init_cache(1, cfg.frontend_seq + 16, dtype=torch.float32)
            logits, _ = model.prefill(prompt[None], cache,
                                      prefix_embed=patches[rid],
                                      dtype=torch.float32)
            toks = [int(logits.argmax(-1))]
            for _ in range(5):
                logits, _ = model.decode_step(logits.argmax(-1), cache,
                                              dtype=torch.float32)
                toks.append(int(logits.argmax(-1)))
            assert killed.completed[rid] == toks


def test_profiles_cli_writes_the_wide_head_rows(tmp_path):
    """``repro_torch.profiles.run --device cpu`` at paligemma-3b's and
    h2o-danube3-4b's full widths (head_dim 256 and 120): one row each."""
    from repro_torch.profiles import run as profiles_run
    from repro_torch.profiles.schema import ProfileTable

    out = tmp_path / "p.json"
    rc = profiles_run.main(["--device", "cpu", "--models", "paligemma-3b",
                            "h2o-danube3-4b", "--prefill-tokens", "32",
                            "--cache-tokens", "64", "--repeats", "1",
                            "--out", str(out)])
    assert rc == 0
    table = ProfileTable.load(str(out))
    assert sorted(table.entries) == ["h2o-danube3-4b|H100", "paligemma-3b|H100"]
    for e in table.entries.values():
        assert e.backend == "cpu" and e.mode == "eager"
        assert e.prefill_wall_s > 0 and e.decode_wall_s > 0
