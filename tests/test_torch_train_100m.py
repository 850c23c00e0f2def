"""The port's ~100M trainer (``repro_torch.launch.train_100m``)
against the reference's (``examples/train_100m.py``).

* The trainer's settings equal the reference's, read from the example's
  source with ``ast`` so that drift in either shows: the config, the
  flags and their defaults, the optimizer, the batches and the step.
* Two steps at a reduced depth and width from the reference's weights
  (``params_from_jax``) give the reference's jitted ``make_train_step``'s
  loss and grad norm within 1e-4 relative, the tolerance of
  ``tests/test_torch_training.py``; both sides in float32 (the reference's
  loss wrapped with ``dtype=float32``, the port's step built with it).
* On the CPU, 4 steps straight equal 2 steps, a checkpoint and a resume to
  step 4, bit for bit.
"""

import ast
import dataclasses
import functools
import inspect
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.train_loop import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train_100m  # noqa: E402
from repro_torch.training import data as tdata  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "examples", "train_100m.py")

# a reduced llama-100m: the trainer's settings, 2 layers of width 128
SMALL = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
             head_dim=32, d_ff=256, vocab_size=512)
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops under the suite's parallel workers: one intra-op thread a
    worker keeps them fast (as ``tests/test_torch_training.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _calls(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call)]


def _name(call):
    return ast.unparse(call.func)


def _keywords(call):
    return {k.arg: ast.unparse(k.value) for k in call.keywords}


def _only(calls, name):
    found = [c for c in calls if _name(c) == name]
    assert len(found) == 1, name
    return found[0]


def _flags(path):
    return {c.args[0].value: _keywords(c) for c in _calls(path)
            if _name(c) == "ap.add_argument"}


@functools.lru_cache(maxsize=None)
def _reference_config():
    """The example's ``dataclasses.replace(get_config(...), ...)``."""
    call = _only(_calls(EXAMPLE), "dataclasses.replace")
    base = call.args[0]
    assert _name(base) == "get_config"
    kw = {k.arg: ast.literal_eval(k.value) for k in call.keywords}
    return dataclasses.replace(j_config(ast.literal_eval(base.args[0])), **kw)


@pytest.mark.parametrize("part", ["config", "flags", "optimizer",
                                  "batches_and_step"])
def test_trainer_matches_reference(part):
    ref = _calls(EXAMPLE)
    port = _calls(inspect.getsourcefile(train_100m))
    if part == "config":
        assert (dataclasses.asdict(train_100m.config())
                == dataclasses.asdict(_reference_config()))
    elif part == "flags":
        want = _flags(EXAMPLE)
        got = _flags(inspect.getsourcefile(train_100m))
        assert got.pop("--device") == {"default": "'cuda'"}
        assert got == {k: (dict(v, default="'artifacts/train_100m_torch'")
                           if k == "--ckpt-dir" else v)
                       for k, v in want.items()}
    elif part == "optimizer":
        assert _keywords(_only(ref, "AdamWConfig")) == {
            "lr": "0.0003", "warmup_steps": "20",
            "total_steps": "max(args.steps, 100)"}
        opt = train_100m.build_step(
            dataclasses.replace(train_100m.config(), **SMALL), 7,
            device="cpu").opt_cfg
        assert dataclasses.asdict(opt) == dataclasses.asdict(
            jopt.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=100))
        assert train_100m.build_step(
            dataclasses.replace(train_100m.config(), **SMALL), 300,
            device="cpu").opt_cfg.total_steps == 300
    else:
        assert _keywords(_only(ref, "make_batch")) == {"seed": "1",
                                                       "step": "step"}
        assert _keywords(_only(port, "make_batch"))["seed"] == "1"
        assert _keywords(_only(ref, "make_train_step")) == {
            "microbatches": "1"}
        assert _keywords(_only(port, "TrainStep"))["microbatches"] == "1"
        assert _keywords(_only(ref, "build_model")) == {"remat": "False"}
        built = _keywords(_only(port, "build_model"))
        assert (built["remat"], built["impl"]) == ("False", "'blockwise'")
        # the reference's model default impl, and its loss's activations
        assert j_build(_reference_config()).impl == "blockwise"
        loss = inspect.signature(type(j_build(_reference_config())).loss)
        assert loss.parameters["dtype"].default == jnp.bfloat16
        assert inspect.signature(train_100m.build_step).parameters[
            "dtype"].default == torch.bfloat16


def _tree_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jbatch(batch):
    return {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in batch.items()}


def test_two_steps_match_reference():
    jcfg = dataclasses.replace(_reference_config(), **SMALL)
    cfg = dataclasses.replace(train_100m.config(), **SMALL)
    jmodel = j_build(jcfg, remat=False)
    jmodel.loss = functools.partial(type(jmodel).loss, jmodel,
                                    dtype=jnp.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    jstep = jax.jit(j_make_train_step(
        jmodel, jcfg, jopt.AdamWConfig(lr=3e-4, warmup_steps=20,
                                       total_steps=100), microbatches=1))
    jst = jopt.adamw_init(params)

    step = train_100m.build_step(cfg, 2, device="cpu", dtype=torch.float32)
    assert isinstance(step, tsteps.TrainStep)
    assert (step.model.impl, step.model.remat) == ("blockwise", False)
    step.model.load_state_dict(params_from_jax(_tree_np(params)))
    for i in range(2):
        batch = tdata.make_batch(cfg, B, S, seed=1, step=i,
                                 dtype=torch.float32, device="cpu")
        params, jst, jm = jstep(params, jst, _jbatch(batch))
        m = step(batch)
        assert int(m["step"]) == int(jm["step"]) == i + 1
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                      rel=1e-4)


def _run(cfg, ckpt_dir, steps):
    lines = []
    res = train_100m.train(cfg, steps=steps, batch=B, seq=S,
                           ckpt_dir=str(ckpt_dir), ckpt_every=2, device="cpu",
                           out=lines.append)
    return res, lines


def _state(res):
    st = res["step"].state()
    return {"params": st["params"], "m": st["opt_state"]["m"],
            "v": st["opt_state"]["v"],
            "step": {"step": st["opt_state"]["step"]}}


def test_resume_equals_straight_run(tmp_path):
    cfg = dataclasses.replace(train_100m.config(), **SMALL)
    straight, lines = _run(cfg, tmp_path / "straight", 4)
    assert not any(line.startswith("resumed") for line in lines)
    assert lines[0] == f"model llama-100m: {straight['step'].model.num_params() / 1e6:.1f}M params"
    assert [line.split(" -> ")[1] for line in lines
            if line.startswith("checkpointed -> ")] == [
        str(tmp_path / "straight" / f"step_{s:08d}") for s in (2, 4)]
    assert lines[-1] == "done"
    first, _ = _run(cfg, tmp_path / "cut", 2)
    resumed, lines = _run(cfg, tmp_path / "cut", 4)
    assert "resumed from checkpoint step 2" in lines
    assert (first["start"], resumed["start"]) == (0, 2)
    want, got = _state(straight), _state(resumed)
    for group in want:
        for k, t in want[group].items():
            assert torch.equal(got[group][k], t), (group, k)
    for k in ("loss", "grad_norm"):
        assert torch.equal(resumed["metrics"][k], straight["metrics"][k])


def test_trainer_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA: the trainer would run there")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_100m.main(["--ckpt-dir", "unused"])
