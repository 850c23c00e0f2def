"""The harness on the CPU: traffic, metrics, the frozen formulas, the
benchmark's file against its format rules, the guard and the refusal without a
card.

    python -m pytest -q portbench/tests
"""

import ast
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.core import client, cost, endtoend, spec, traffic  # noqa: E402

BENCH = spec.load_benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


# ---------------------------------------------------------------------------
# traffic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mix", ["chat", "code"])
def test_same_seed_same_requests(mix):
    m = spec.traffic(mix)
    a = traffic.make_requests(m, 51, 2**31 + 12345, 151936)
    b = traffic.make_requests(m, 51, 2**31 + 12345, 151936)
    assert [(r.due_s, r.out_tokens, r.backlog) for r in a] == \
        [(r.due_s, r.out_tokens, r.backlog) for r in b]
    assert all((x.prompt == y.prompt).all() for x, y in zip(a, b))


@pytest.mark.parametrize("mix", ["chat", "code"])
def test_seeds_replay_the_mixs_schedule(mix):
    """Two seeds send the same set of requests, the same prompt and answer
    lengths and the same gaps between arrivals, each in its own order; the
    prompts' tokens differ."""
    m = spec.traffic(mix)
    a = traffic.make_requests(m, 51, 7, 151936)
    b = traffic.make_requests(m, 51, 8, 151936)

    def gaps(reqs):
        due = [r.due_s for r in reqs if not r.backlog]
        return sorted(round(y - x, 9) for x, y in zip([0.0] + due, due))

    def lengths(reqs):
        return sorted((r.backlog, len(r.prompt)) for r in reqs), \
            sorted((r.backlog, r.out_tokens) for r in reqs)

    assert gaps(a) == gaps(b) and lengths(a) == lengths(b)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]
    assert any((x.prompt[:16] != y.prompt[:16]).any() for x, y in zip(a, b))
    lo, hi = m["prompt_tokens"]["min"], m["prompt_tokens"]["max"]
    assert all(lo <= len(r.prompt) <= hi for r in a)
    assert all(r.due_s < 51 for r in a)
    n = sum(not r.backlog for r in a)
    assert n == traffic.arrivals_in(m, 51)
    assert abs(n - m["arrivals"]["rate_per_s"] * 51) <= 2


def test_the_order_seed_orders_the_same_quantiles():
    """The seed orders the mix's quantiles: a large seed and its neighbour
    draw the same answer lengths in other orders."""
    m = spec.traffic("code")
    a = traffic.make_requests(m, 51, 2**31 + 7, 151936)
    b = traffic.make_requests(m, 51, 2**31 + 8, 151936)
    assert sorted(r.out_tokens for r in a) == sorted(r.out_tokens for r in b)
    assert [r.out_tokens for r in a] != [r.out_tokens for r in b]


def test_arrivals_after_the_window_follow_it():
    """A traced run's arrivals past the window: no backlog, ids after the
    window's, due after it, and prompts of their own."""
    m = spec.traffic("chat")
    win = traffic.make_requests(m, 51, 9, 151936)
    more = traffic.make_requests(m, 4.0, 9, 151936, stream=1,
                                 first_rid=len(win), after_s=51.0)
    assert more and not any(r.backlog for r in more)
    assert [r.rid for r in more] == list(range(len(win), len(win) + len(more)))
    assert all(51.0 < r.due_s < 55.0 for r in more)
    assert len(more[0].prompt) != len(win[0].prompt) or \
        (more[0].prompt != win[0].prompt[:len(more[0].prompt)]).any()


def test_backlog_fills_the_serving_slots():
    m = spec.traffic("chat")
    reqs = traffic.make_requests(m, 51, 3, 151936)
    n = m["replicas"]["serving"] * m["replicas"]["slots"]
    assert sum(r.backlog for r in reqs) == n
    assert all(r.backlog for r in reqs[:n])


def test_stratified_lengths_follow_the_lognormal():
    """The quantile levels' median is the lognormal's, exp(mu)."""
    spec_ = {"mu": 5.0, "sigma": 0.8, "min": 1, "max": 10**6}
    import numpy as np

    v = traffic.lognormal_lengths(1001, spec_, np.random.default_rng(0))
    assert int(np.median(v)) == int(np.exp(5.0))


# ---------------------------------------------------------------------------
# end-to-end metrics over all samples
# ---------------------------------------------------------------------------


def _window(times_per_attempt, discarded=(), due=None, start=0.0, close=10.0):
    atts = [client.Attempt(i, "r", 10, t[0], list(t), list(range(len(t))),
                           len(t), discarded=i in discarded)
            for i, t in enumerate(times_per_attempt)]
    return client.Window(start, close, close - start, None, atts,
                         {a.rid: a for a in atts}, {}, [], [], due or {})


def test_rate_counts_every_token_over_the_whole_window():
    win = _window([[1.0, 2.0, 3.0], [4.0, 5.0]], discarded={1})
    assert endtoend.tokens_per_s(win) == pytest.approx(3 / 10.0)


def test_a_stall_moves_the_gap_tail_and_the_rate():
    """Every gap counts: ten 0.5 s stalls among 0.1 s gaps move the 95th
    percentile to the stall and lower the rate."""
    steady = [0.1 * i for i in range(1, 100)]
    stalled, t = [], 0.0
    for i in range(99):
        t += 0.6 if i % 10 == 5 else 0.1
        stalled.append(t)
    a, b = _window([steady]), _window([[x for x in stalled if x <= 10.0]])
    assert 1e3 * endtoend.percentile(endtoend.token_gaps(a), 95) == pytest.approx(100.0)
    assert 1e3 * endtoend.percentile(endtoend.token_gaps(b), 95) == pytest.approx(600.0)
    assert endtoend.tokens_per_s(b) < endtoend.tokens_per_s(a)


def test_first_token_time_counts_a_request_never_served():
    win = _window([[3.0, 4.0]], due={0: 1.0, 7: 2.0})
    got = sorted(endtoend.ttfts(win))
    assert got == pytest.approx([2.0, 8.0])


# ---------------------------------------------------------------------------
# frozen formulas against hand counts
# ---------------------------------------------------------------------------


def test_attention_pairs_by_hand():
    assert cost.attention_pairs(4, 4, True) == 10
    assert cost.attention_pairs(4, 4, False) == 16
    assert cost.attention_pairs(5, 5, True, window=2) == 9


def test_flash_decode_work_by_hand():
    # q and out 2 x 32 x 128 x 2 B, mask 3072 B, K and V 2 x 100 x 4 x 128 x 2 B
    w = cost.flash_decode_work(1, 32, 4, 3072, 128, 2, n_valid=100)
    assert w.bytes == 2 * 32 * 128 * 2 + 3072 + 2 * 100 * 4 * 128 * 2
    assert w.flops == 4 * 32 * 128 * 100


def test_moe_gmm_decode_work_by_hand():
    # 8 of 128 experts, one row each: their (2048, 768) weights, 8 rows of
    # x, the whole (128, 1, 768) output
    w = cost.moe_gmm_work(128, 1, 2048, 768, 2, n_rows=8, n_occupied=8)
    assert w.bytes == 2 * (8 * 2048 * 768 + 8 * 2048 + 128 * 768)
    assert w.flops == 2 * 8 * 2048 * 768
    assert w.bound_s() == pytest.approx(w.bytes / 3.35e12)


def test_flash_attention_work_by_hand():
    w = cost.flash_attention_work(1, 2, 1, 4, 4, 8, 2, causal=True)
    assert w.flops == 4 * 2 * 8 * 10
    assert w.bytes == 2 * (2 * 4 * 2 * 8 + 2 * 4 * 1 * 8)


def test_model_flops_by_hand():
    m = cost.ModelShape(layers=2, d_model=4, heads=2, kv_heads=1, head_dim=2,
                        d_ff=8, vocab=10)
    per_tok = 2 * (4 * (2 + 2) * 2 + 2 * 2 * 4 + 3 * 4 * 8)
    assert cost.decode_flops(m, 5) == 2 * (per_tok + 4 * 2 * 2 * 5) + 2 * 4 * 10
    assert cost.prefill_flops(m, 3) == 2 * (3 * per_tok + 4 * 2 * 2 * 6) + 2 * 4 * 10
    moe = cost.ModelShape(layers=1, d_model=4, heads=2, kv_heads=1, head_dim=2,
                          d_ff=0, vocab=10, experts=8, top_k=2, expert_ff=3)
    per_tok = 2 * (4 * 4 * 2 + 4 * 4 + 4 * 8 + 2 * 3 * 4 * 3)
    assert cost.decode_flops(moe, 1) == per_tok + 4 * 2 * 2 + 2 * 4 * 10


def test_model_shape_of_the_configurations():
    m = cost.model_shape(spec.config(BENCH, "qwen3-moe-30b"))
    assert (m.layers, m.heads, m.kv_heads, m.head_dim, m.experts, m.top_k,
            m.expert_ff) == (48, 32, 4, 128, 128, 8, 768)
    m = cost.model_shape(spec.config(BENCH, "qwen2.5-3b"))
    assert (m.layers, m.heads, m.kv_heads, m.head_dim, m.d_ff) == (36, 16, 2, 128, 11008)


# ---------------------------------------------------------------------------
# BENCHMARK.json against its format rules
# ---------------------------------------------------------------------------


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w[k] for w in BENCH["workloads"] for k in ("name", "config", "traffic")]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    units = [m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(UNIT.match(u) for u in units)
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + [c["source"] for c in BENCH["configs"]] + BENCH["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_name_is_unique_and_found_by_its_files():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        ref = json.loads((ROOT / c["file"]).read_text())["reference"]
        assert (ROOT / "portbench" / "reference" / f"{ref}.py").is_file()
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "portbench" / "checks" / f"{w['name']}.json").is_file()
    for m in BENCH["per_layer"]:
        assert spec.reader_file(m["name"]).is_file()
        assert callable(spec.reader(m["name"]))


def test_a_cells_metric_shares_its_reader():
    """``<metric>.<cell>`` reads ``metrics/<metric>.py``; a name with no
    reader at any of its prefixes is refused."""
    got = spec.reader_file("moe_gmm_roofline.decode.qwen3moe-chat")
    assert got.name == "moe_gmm_roofline.decode.py"
    assert spec.reader_file("decode_step_ms.qwen25-chat").name == "decode_step_ms.py"
    with pytest.raises(FileNotFoundError):
        spec.reader_file("no_such_metric.qwen25-chat")


def test_metrics_cover_every_cell():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for c in cells:
        got = [m["name"] for m in spec.metrics_for(BENCH, c, False)]
        assert "setup_s" in got and len(got) >= 2
        assert spec.metrics_for(BENCH, c, True)
    for m in BENCH["per_layer"]:
        moves = e2e[m["moves"]]
        for c in m.get("workloads", cells):
            assert c in moves.get("workloads", cells), (m["name"], c)
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(1 <= len(x) <= 200 for x in layers)


def test_command_stays_inside_the_paths():
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1].startswith("portbench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    n = 24
    assert (2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 180 + 1200 <= 43200


# ---------------------------------------------------------------------------
# the guard, and no card
# ---------------------------------------------------------------------------


def test_guard_names_whole_top_level_modules(monkeypatch):
    sys.path.insert(0, str(ROOT / "portbench"))
    import run

    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert run.forbidden_modules() == ["jax", "repro"]


def test_harness_loads_no_jax_and_no_reference_package():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import portbench.core.runner, portbench.core.check\n"
            "import portbench.reference.qwen3_moe, portbench.reference.qwen2\n"
            "import repro_torch.serving.live\n"
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'repro'}\n"
            "print(sorted(bad))") % (str(ROOT), str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


def test_references_import_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            for m in mods:
                assert m.split(".")[0] not in ("repro_torch", "repro", "jax"), (path, m)


def test_no_card_no_result():
    """Without a CUDA device the run fails and prints no result (the card,
    if the machine has one, hidden from it)."""
    res = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"),
                          "--workload", BENCH["workloads"][0]["name"],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "no CUDA device" in res.stderr
