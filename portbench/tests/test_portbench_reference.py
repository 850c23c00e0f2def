"""The plain references against the port at small sizes on the CPU, the
control that the comparison must catch, and the comparison catching a
broken timed path.

    python -m pytest -q portbench/tests
"""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.core import check, client, faults, runner, spec  # noqa: E402
from portbench.core.model import build_program, make_weights, program_config  # noqa: E402
from portbench.reference import qwen3_moe  # noqa: E402

BENCH = spec.load_benchmark(ROOT)
CELLS = {w["name"]: w for w in BENCH["workloads"]}
LIMITS = {"compare": {"mean_logit_gap": 1e-4}, "min_positions": 10}   # float32 on the CPU


def small(name: str, d: int = 64, layers: int = 2) -> dict:
    """A configuration file's small version: every width cut, the rest
    as published."""
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    cfg.update(num_hidden_layers=layers, hidden_size=d, num_attention_heads=4,
               num_key_value_heads=2, head_dim=d // 4, vocab_size=500)
    cfg["program"] = dict(cfg["program"], vocab_pad_multiple=64)
    if "num_experts" in cfg:
        cfg.update(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32)
    else:
        cfg.update(intermediate_size=96)
    return cfg


def small_mix(name: str, rate: float = 4.0, requests: int = 8,
              head: int = 24) -> dict:
    mix = spec.traffic(name)
    mix["replicas"] = dict(mix["replicas"], slots=2, max_len=300)
    mix["prompt_tokens"] = dict(mix["prompt_tokens"], min=8, max=100)
    mix["output_tokens"] = dict(mix["output_tokens"], min=4, max=40)
    mix["arrivals"] = dict(mix["arrivals"], rate_per_s=rate)
    mix["check"] = dict(mix["check"], requests=requests, head=head)
    return mix


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["qwen3-moe-30b", "qwen2.5-3b"])
def test_config_files_are_the_ports_configs(name):
    """The benchmark's configuration maps to the port's own config of the
    model, field for field."""
    from repro_torch.configs import get_config

    assert program_config(spec.config(BENCH, name)) == get_config(name)


@pytest.mark.parametrize("name", ["qwen3-moe-30b", "qwen2.5-3b"])
def test_reference_matches_the_port(name):
    """Prefill's logits and eight decode steps' through the port's model on
    the benchmark's weights, against the reference over the whole
    sequence."""
    cfg = small(name)
    W = make_weights(cfg, 11, "cpu", torch.float32)
    model = build_program(cfg, W)
    prompt = torch.randint(0, 500, (1, 40), generator=torch.Generator().manual_seed(3))
    cache = model.init_cache(1, 64, dtype=torch.float32)
    with torch.inference_mode():
        lg, _ = model.prefill(prompt, cache, dtype=torch.float32)
        got, toks = [lg[0, 0]], []
        for _ in range(8):
            toks.append(got[-1][:500].argmax())
            lg, _ = model.decode_step(toks[-1].reshape(1, 1), cache, dtype=torch.float32)
            got.append(lg[0, 0])
    seq = torch.cat([prompt[0], torch.stack(toks)])
    ref = spec.reference(cfg["reference"]).logits(cfg, W, [seq], [40])[0]
    assert ref.shape == (9, 500)
    assert torch.allclose(torch.stack(got)[:, :500], ref, atol=1e-4, rtol=1e-4)


def test_moe_capacity_drops_as_the_port_does():
    """A 40-token prefill over 8 experts, top 2, has a capacity of
    ceil(40 * 2 / 8 * 1.25) = 13 tokens an expert: of 20 tokens sent to
    experts 0 and 1 the first 13 are kept, in token order."""
    idx = torch.tensor([[0, 1]] * 20 + [[2, 3]] * 20)
    keep = qwen3_moe.kept_pairs(idx, 40, 8, 1.25)
    assert int(keep.sum()) == 4 * 13
    assert bool(keep[:13].all()) and not bool(keep[13:20].any())


def _run(cell, seed=5, seconds=2.0, traced=False, **mix):
    w = CELLS[cell]
    return runner.run_cell(BENCH, cell, seed, seconds, traced, "cpu",
                           cfg=small(w["config"]), mix=small_mix(w["traffic"], **mix),
                           limits=LIMITS)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["checks"]["retried"]["value"] >= 1
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in spec.metrics_for(BENCH, cell, False)}


@pytest.mark.parametrize("cell", ["qwen25-chat", "qwen3moe-code"])
def test_a_traced_run_reads_its_counters_from_the_window(cell):
    """A traced run serves on past the window for its stretch; its host
    counters and its check cover the window's work alone, and it is
    correct as an untraced run is."""
    res = _run(cell, traced=True)
    assert res["correct"], res["checks"]
    for name in ("wasted_token_share", "decode_step_ms", "tpot_p99_ms"):
        assert res["metrics"][f"{name}.{cell}"]["value"] > 0
    if cell == "qwen3moe-code":
        assert res["metrics"]["ttft_p90_ms"]["value"] > 0
        assert res["metrics"]["prefill_ms_per_ktok"]["value"] > 0


@pytest.mark.parametrize("seed", [21, 22, 23])
@pytest.mark.parametrize("cell", ["qwen3moe-chat", "qwen25-chat"])
def test_the_float8_control_is_caught(cell, seed):
    """The reference in float8 put in the program's place reads a gap past
    the limit that the program's own tokens stay under."""
    w = CELLS[cell]
    cfg, mix = small(w["config"]), small_mix(w["traffic"])
    state = runner.build(cfg, mix, seed, torch.device("cpu"))
    runner.warm(state, bool(mix.get("backlog")))
    reqs, prompts, backlog = runner.requests(state, seed, 2.0)
    win = client.run_window(state.serving, state.standby, reqs, prompts, 2.0,
                            mix["preempt_at"], None, backlog)
    sample = check.choose_sample(win, seed, mix["check"])
    found = check.gaps(cfg, state.W, sample, prompts, control=True)
    assert found["mean_logit_gap"] <= LIMITS["compare"]["mean_logit_gap"] < found["control_mean_logit_gap"]


# ---------------------------------------------------------------------------
# the timed path broken underneath: the comparison must read false
# ---------------------------------------------------------------------------


def _stale_state(monkeypatch):
    """A decode step that leaves its state unchanged: the cache's length
    does not advance."""
    faults.plant("stale", monkeypatch.setattr)


def _half_batch(monkeypatch):
    """A replica's step that leaves out half of its requests in flight:
    they repeat their last token instead of decoding."""
    faults.plant("half", monkeypatch.setattr)


def _altered_token(monkeypatch):
    """Every fifth decode step's token altered where the step makes it."""
    faults.plant("alter", monkeypatch.setattr)


@pytest.mark.parametrize("fault", [_stale_state, _half_batch, _altered_token])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_broken_step_is_not_correct(cell, fault, monkeypatch):
    """Under load that keeps every slot busy, with every attempt compared.
    (At the cells' own sizes, against their committed limits, the same
    faults are read by ``readings.py --faults``.)"""
    fault(monkeypatch)
    res = _run(cell, rate=30.0, requests=100, head=100)
    assert not res["correct"], res["checks"]
    assert res["checks"]["mean_logit_gap"]["value"] > LIMITS["compare"]["mean_logit_gap"]
