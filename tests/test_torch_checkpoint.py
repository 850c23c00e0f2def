"""The port's checkpoints (``repro_torch.distributed.checkpoint``): the
reference's four cases (``tests/test_distributed.py``) mirrored, plus a
missing leaf, the optimizer state of a train step, and the on-disk layout
against the reference's own reader."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed.checkpoint import (  # noqa: E402
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.launch.steps import build_train_step  # noqa: E402
from repro_torch.training import AdamWConfig, make_batch  # noqa: E402


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


def _tree():
    return {"params": {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                       "b": {"c": torch.full((4,), 1.5, dtype=torch.bfloat16)}}}


def test_checkpoint_roundtrip(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = _tree()
    save_checkpoint(d, 10, tree["params"])
    assert latest_step(d) == 10
    restored, step = restore_checkpoint(d, tree)
    assert step == 10
    assert torch.equal(restored["params"]["a"], tree["params"]["a"])
    c = restored["params"]["b"]["c"]
    assert c.dtype == torch.bfloat16 and torch.equal(c, tree["params"]["b"]["c"])


def test_checkpoint_atomicity_ignores_tmp(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = _tree()
    save_checkpoint(d, 1, tree["params"])
    # a stale tmp dir from a preempted writer must be ignored and collected
    os.makedirs(os.path.join(d, "step_00000002.tmp"))
    assert latest_step(d) == 1
    save_checkpoint(d, 3, tree["params"])
    assert latest_step(d) == 3
    assert not any(x.endswith(".tmp") for x in os.listdir(d))


@pytest.mark.parametrize("keep,want", [(2, [4, 5]), (3, [3, 4, 5])])
def test_checkpoint_prunes_old(tmp_path, keep, want):
    d = str(tmp_path / "ckpt")
    tree = _tree()
    for s in (1, 2, 3, 4, 5):
        kw = {} if keep == 3 else {"keep": keep}      # 3 is the default
        save_checkpoint(d, s, tree["params"], **kw)
    steps = sorted(int(x.split("_")[1]) for x in os.listdir(d)
                   if x.startswith("step"))
    assert steps == want


def test_checkpoint_shape_mismatch_raises(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, {"a": torch.zeros((2, 2))})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(d, {"params": {"a": torch.zeros((3, 3))}})


def test_checkpoint_missing_leaf_raises(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, {"a": torch.zeros((2, 2))})
    with pytest.raises(KeyError, match="params/b"):
        restore_checkpoint(d, {"params": {"a": torch.zeros((2, 2)),
                                          "b": torch.zeros(1)}})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), {"params": {}})


def test_checkpoint_layout_is_the_reference_one(tmp_path):
    """The manifest and the raw-byte leaves read back with numpy alone, as
    the reference's ``restore_checkpoint`` reads them."""
    d = str(tmp_path / "ckpt")
    tree = {"w": torch.randn(3, 5), "s": torch.tensor(7, dtype=torch.int32)}
    path = save_checkpoint(d, 42, tree, extra={"note": "x"})
    assert os.path.basename(path) == "step_00000042"
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 42 and manifest["extra"] == {"note": "x"}
    for entry in manifest["leaves"]:
        raw = np.load(os.path.join(path, entry["file"]))
        assert raw.dtype == np.uint8
        arr = np.frombuffer(raw.tobytes(), np.dtype(entry["dtype"])).reshape(
            entry["shape"])
        want = tree[entry["key"].split("/", 1)[1]].numpy()
        assert np.array_equal(arr, want), entry["key"]


def test_train_step_state_round_trips(tmp_path):
    """bf16 parameters, fp32 moments, the int32 step and the carried
    compression error of a train step: saved, restored into a fresh step,
    and the next step of both equal to the bit."""
    cfg = get_smoke_config("llama3.2-1b")
    kw = dict(microbatches=1, compress_grads=True, device="cpu",
              opt_cfg=AdamWConfig(warmup_steps=1))
    a = build_train_step(cfg, **kw)
    for i in range(2):
        a(make_batch(cfg, 2, 8, step=i, device="cpu"))
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 2, a.params, a.opt_state)
    b = build_train_step(cfg, **kw,
                         generator=torch.Generator().manual_seed(1))
    b.opt_state["ef_error"] = {k: torch.zeros_like(v)
                               for k, v in a.opt_state["ef_error"].items()}
    restored, step = restore_checkpoint(d, b.state())
    b.load(restored)
    assert step == 2 and int(b.opt_state["step"]) == 2
    batch = make_batch(cfg, 2, 8, step=2, device="cpu")
    ma, mb = a(batch), b(batch)
    assert float(ma["loss"]) == float(mb["loss"])
    for k, p in a.params.items():
        assert p.dtype == torch.bfloat16 and torch.equal(p, b.params[k]), k
