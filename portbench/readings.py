#!/usr/bin/env python3
"""Readings for setting a cell's limits and rate, many windows in one
process (not part of the benchmark's runs).

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 --seconds 25 --control 3
    python3 portbench/readings.py --workload <cell> --seeds 7 --rates 1.0,1.5,2.0 --no-check
    python3 portbench/readings.py --workload <cell> --seeds 5 --seconds 20 --faults stale,half,alter

The cell is set up once (weights from the first seed); each further seed
draws the weights anew in place and serves its own requests, so every
window runs the program exactly as ``run.py`` does.  Per window it prints a
JSON line: the end-to-end metrics, the backlog the window left (requests
due but never sent, and the queue wait's growth from its first half to its
second), and, unless ``--no-check``, the logit gaps of the served
tokens and, in the first ``--control`` windows, of the float8 reference's
choices, each set judged against the cell's committed limits
(``correct``, ``control_correct``).  With ``--rates`` the first seed
serves one window at each arrival rate: the sweep that finds the highest
rate the program sustains.  With ``--faults`` each named fault
(``core/faults.py``) is planted under the timed path for one more window
of the last seed, and its gaps judged the same way.
"""

import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import argparse  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench.core import check, client, endtoend, faults, runner, spec  # noqa: E402
from portbench.core.model import redraw_weights  # noqa: E402


def backlog_growth(win) -> dict:
    """Requests due but never sent, and the median queue wait of the
    window's second half against its first."""
    half = win.start + win.seconds / 2
    first, second = [], []
    for rid, due in win.due.items():
        wait = win.submit_start.get(rid, win.close) - due
        (first if due < half else second).append(wait)
    med = lambda v: float(np.median(v)) if v else None  # noqa: E731
    return {"unsent": sum(1 for r in win.due if r not in win.submit_start),
            "wait_p50_first_s": med(first), "wait_p50_second_s": med(second)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", default="")
    ap.add_argument("--control", type=int, default=0,
                    help="read the float8 control too, in the first N windows")
    ap.add_argument("--faults", default="",
                    help="plant these faults, one more window each")
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)

    bench = spec.load_benchmark(ROOT)
    cell = spec.cell(bench, args.workload)
    cfg, mix = spec.config(bench, cell["config"]), spec.traffic(cell["traffic"])
    seeds = [int(s) for s in args.seeds.split(",")]
    rates = [float(r) for r in args.rates.split(",")] if args.rates else [None]
    dev = torch.device(args.device)
    state = runner.build(cfg, mix, seeds[0], dev)
    runner.warm(state, bool(mix.get("backlog")))
    out = open(args.out, "a") if args.out else None
    limits = spec.limits(cell["name"])
    runs = [(s, r, None) for s in seeds for r in rates] if len(rates) == 1 else \
        [(seeds[0], r, None) for r in rates]
    runs += [(runs[-1][0], runs[-1][1], f) for f in args.faults.split(",") if f]
    for i, (seed, rate, fault) in enumerate(runs):
        if i:
            runner.revive(state)
            if seed != runs[i - 1][0]:
                redraw_weights(cfg, state.W, seed)
        if rate is not None:
            mix["arrivals"]["rate_per_s"] = rate
        reqs, prompts, backlog = runner.requests(state, seed, args.seconds)
        with faults.planted(fault) if fault else contextlib.nullcontext():
            win = client.run_window(state.serving, state.standby, reqs,
                                    prompts, args.seconds, mix["preempt_at"],
                                    None, backlog)
        runner.describe(win)
        names = ["tokens_per_s"] + [f"tpot_p{q}_ms" for q in (50, 90, 95, 99)] + \
            ([f"ttft_p{q}_ms" for q in (50, 75, 90)] if win.due else [])
        row = {"cell": cell["name"], "seed": seed, "fault": fault,
               "rate": mix["arrivals"]["rate_per_s"], "seconds": args.seconds,
               **endtoend.compute(names, win, 0.0),
               "tokens_incl_discarded_per_s": sum(
                   1 for a in win.attempts for t in a.times
                   if win.start <= t <= win.close) / (win.close - win.start),
               **backlog_growth(win)}
        if not args.no_check:
            sample = check.choose_sample(win, seed, mix["check"])
            t = time.perf_counter()
            found = check.gaps(cfg, state.W, sample, prompts,
                               control=i < args.control)
            control = {k[len("control_"):]: v for k, v in found.items()
                       if k.startswith("control_")}
            row.update(found, correct=check.passed(
                check.verdict(found, sample, limits, failed=0)))
            if control:
                row["control_correct"] = check.passed(check.verdict(
                    dict(control, positions=found["positions"]), sample,
                    limits, failed=0))
            row.update(sample=len(sample),
                       retried=sum(a.retry for a, _ in sample),
                       distinct_tokens=len({t for a, n in sample for t in a.tokens[:n]}),
                       check_s=time.perf_counter() - t)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
