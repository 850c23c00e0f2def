"""The harness on the card at small sizes: a run through the hand-written
kernels in bf16 is correct against the plain reference, and the float8
control is not.  Marked ``cuda``; each test decides in its fixture whether
there is a card, and skips without one.

    python -m pytest -q -m cuda portbench/tests
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "portbench" / "tests")]

from portbench.core import check, client, runner  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("cell", ["qwen3moe-chat", "qwen3moe-code", "qwen25-chat"])
def test_small_run_on_the_card(card, cell):
    """d = 128, 2 layers, through the kernels in bf16: the served tokens'
    mean gap below the float32 reference's best logit is under a third of
    the float8 control's."""
    from test_portbench_reference import CELLS, small, small_mix

    w = CELLS[cell]
    cfg, mix = small(w["config"], d=128), small_mix(w["traffic"])
    state = runner.build(cfg, mix, 31, card)
    runner.warm(state, bool(mix.get("backlog")))
    reqs, prompts, backlog = runner.requests(state, 31, 3.0)
    win = client.run_window(state.serving, state.standby, reqs, prompts, 3.0,
                            mix["preempt_at"], None, backlog)
    sample = check.choose_sample(win, 31, mix["check"])
    found = check.gaps(cfg, state.W, sample, prompts, control=True)
    assert found["positions"] >= 20
    assert 3 * found["mean_logit_gap"] < found["control_mean_logit_gap"], found
