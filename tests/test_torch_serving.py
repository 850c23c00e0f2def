"""The port's live fleet against the reference's live example.

``examples/serve_llm.py`` is loaded as a module; its ``LiveReplica`` runs the
reference model behind a test-local adapter that passes ``dtype=float32``,
and a copy of its ``main()`` loop drives two replicas with the preemption
at step 4.  The port's ``serve_fleet`` gets the same prompts and the
reference's weights (``params_from_jax``).  Both must complete every request
with identical tokens, retrying the same requests after the preemption.
"""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.registry import build_model as t_build  # noqa: E402
from repro_torch.serving.live import make_prompts, serve_fleet  # noqa: E402

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples",
                       "serve_llm.py")
N_REQ, PROMPT_LEN, OUT_TOKENS, KILL_STEP = 8, 12, 16, 4


def _load_example():
    spec = importlib.util.spec_from_file_location("serve_llm_example", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _F32Model:
    """The reference model with float32 activations and cache."""

    def __init__(self, model):
        self.model = model

    def init_cache(self, batch, max_len):
        return self.model.init_cache(batch, max_len, jnp.float32)

    def prefill(self, params, tokens, cache):
        return self.model.prefill(params, tokens, cache, dtype=jnp.float32)

    def decode_step(self, params, tokens, cache):
        return self.model.decode_step(params, tokens, cache, dtype=jnp.float32)


def _reference_fleet(example, cfg, model, params, prompts):
    """``examples/serve_llm.py`` ``main()``'s loop, with given prompts."""
    reps = [example.LiveReplica(f"replica-{i}", cfg, _F32Model(model), params)
            for i in range(2)]
    pending = list(prompts)
    completed, retried = {}, []
    step = 0
    while len(completed) < len(prompts):
        ready = [r for r in reps if r.alive]
        while pending and ready:
            req = pending.pop(0)
            target = min(ready, key=lambda r: len(r.inflight))
            target.submit(req, prompts[req], out_tokens=OUT_TOKENS)
        for r in ready:
            for req_id, out in r.step():
                completed[req_id] = out
        step += 1
        if step == KILL_STEP and reps[0].alive:
            failed = reps[0].kill()
            retried.extend(failed)
            pending = failed + pending
    return completed, retried


def test_serve_fleet_matches_reference_example():
    example = _load_example()
    jcfg = j_smoke("llama3.2-1b")
    jmodel = j_build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))

    tcfg = t_smoke("llama3.2-1b")
    tmodel = t_build(tcfg, device="cpu")
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), params)
    tmodel.load_state_dict(params_from_jax(tree))

    prompts = make_prompts(tcfg, n=N_REQ, min_len=PROMPT_LEN,
                           max_len=PROMPT_LEN, seed=7, device="cpu")
    want, want_retried = _reference_fleet(
        example, jcfg, jmodel, params,
        {i: jnp.asarray(p.numpy()) for i, p in prompts.items()})

    lines = []
    res = serve_fleet(tmodel, prompts, replicas=2, out_tokens=OUT_TOKENS,
                      max_len=96, kill_step=KILL_STEP, dtype=torch.float32,
                      log=lines.append)
    assert res.retried == want_retried and len(res.retried) > 0
    assert res.completed == want
    assert sorted(res.completed) == list(range(N_REQ))
    assert all(len(t) == OUT_TOKENS + 1 for t in res.completed.values())
    # every request prefilled once, plus once more per retry; the decode
    # steps are those of the completed requests plus the retried ones' lost
    # steps (KILL_STEP each: they were decoding since step 0)
    assert res.prefills == N_REQ + len(res.retried)
    assert res.decode_steps == N_REQ * OUT_TOKENS + KILL_STEP * len(res.retried)
    assert any("PREEMPTION" in line for line in lines)


def test_serve_fleet_counts_no_kernel_launch_on_cpu():
    from repro_torch.kernels import ops

    cfg = t_smoke("llama3.2-1b")
    model = t_build(cfg, device="cpu")
    prompts = make_prompts(cfg, n=3, min_len=4, max_len=9, seed=1, device="cpu")
    ops.reset_launch_counts()
    res = serve_fleet(model, prompts, replicas=2, out_tokens=3, max_len=16,
                      kill_step=1, dtype=torch.float32, log=lambda s: None)
    assert sorted(res.completed) == [0, 1, 2]
    assert ops.flash_attention.launches == ops.flash_decode.launches == 0
