"""One run of one cell: set-up, the measured window, the metrics, and the
comparison that decides ``correct``.

Set-up (all of it in ``setup_s``): the kernels' libraries are built, if
this checkout has not built them yet, and loaded; the weights are drawn
from the seed on the card; the program's model is built on them; the
cell's replicas (``serving`` + ``standby``, each ``slots`` cache slots of
``max_len`` with a captured serve step) are built; every slot that the
window would otherwise reach cold serves one short request (one prefill
and one replay; the first of them with the mix's longest prompt); and the
mix's backlog, if any, is admitted and stepped once.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Dict, List, Optional

import torch

from portbench.core import check, client, cost, endtoend, spec, trace
from portbench.core.context import Context
from portbench.core.model import build_program, make_weights
from portbench.core.traffic import make_requests

KERNELS = ("flash_attention", "flash_decode", "moe_gmm")
WARM_PROMPT = 16          # a short warm-up prompt's tokens


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class State:
    cfg: dict
    mix: dict
    device: torch.device
    W: Dict[str, torch.Tensor]
    model: object
    replicas: list

    @property
    def serving(self):
        return self.replicas[:self.mix["replicas"]["serving"]]

    @property
    def standby(self):
        return self.replicas[self.mix["replicas"]["serving"]]


def build(cfg: dict, mix: dict, seed: int, device: torch.device) -> State:
    """Kernels, weights, the program's model and the replicas."""
    from repro_torch.serving.live import LiveReplica

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    t = time.perf_counter()
    if device.type == "cuda":
        from repro_torch.kernels import build as kbuild

        kbuild.build(KERNELS)
        for name in KERNELS:
            kbuild.load(name)
    t_k = time.perf_counter()
    W = make_weights(cfg, seed, device, dtype)
    model = build_program(cfg, W)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_w = time.perf_counter()
    reps = mix["replicas"]
    replicas = [LiveReplica(f"replica-{i}", model, reps["max_len"], dtype,
                            slots=reps["slots"])
                for i in range(reps["serving"] + reps["standby"])]
    t_r = time.perf_counter()
    log(f"set-up: kernels {t_k - t:.3f} s, weights {t_w - t_k:.3f} s, "
        f"replicas {t_r - t_w:.3f} s ({len(replicas)} x {reps['slots']} slots "
        f"of {reps['max_len']})")
    return State(cfg, mix, device, W, model, replicas)


def warm(state: State, backlog: bool) -> None:
    """One short request through every slot the window would reach cold:
    the standby's, and the serving replicas' where no backlog fills them."""
    reps = state.replicas if not backlog else [state.standby]
    vocab = state.cfg["vocab_size"]
    g = torch.Generator(device="cpu").manual_seed(0)
    longest = state.mix["prompt_tokens"]["max"]
    first = True
    for rep in reps:
        for j in range(len(rep.free)):
            n = longest if first else WARM_PROMPT
            first = False
            rep.submit(-1 - j, torch.randint(0, vocab, (n,), generator=g)
                       .to(state.device), 1)
        rep.step()


def requests(state: State, seed: int, seconds: float, after: float = 0.0):
    """The run's requests, their prompts on the device, and the backlog's
    attempts (admitted and stepped once).  ``after`` seconds of arrivals
    follow the window's (a traced run's stretch)."""
    vocab = state.cfg["vocab_size"]
    reqs = make_requests(state.mix, seconds, seed, vocab)
    if after:
        reqs += make_requests(state.mix, after, seed, vocab, stream=1,
                              first_rid=len(reqs), after_s=seconds)
    prompts = {r.rid: torch.from_numpy(r.prompt).to(state.device) for r in reqs}
    backlog: List[client.Attempt] = []
    prefills: List[client.Prefill] = []
    for r in (r for r in reqs if r.backlog):
        target = min((x for x in state.serving if x.free),
                     key=lambda x: len(x.inflight))
        client.admit(target, r, prompts[r.rid], backlog, prefills)
    final = {a.rid: a for a in backlog}
    for rep in state.serving:
        if rep.inflight:
            client.step(rep, final, [])
    return reqs, prompts, backlog


def revive(state: State) -> None:
    """Every replica alive with every slot free (between the windows of one
    process: ``readings.py``)."""
    for rep in state.replicas:
        rep.kill()
        rep.alive = True


def per_layer(bench, cell_name, state, win, tracer, shape) -> tuple:
    """The cell's per-layer metrics that this run holds, the trace's
    summary and the breakdown."""
    summary = None
    if tracer is not None and tracer.phase == "done":
        summary = trace.reduce(tracer.events(), tracer.stretch_ns)
    ctx = Context(win, {r.name: r for r in state.replicas}, shape,
                  state.mix["replicas"]["max_len"], summary, tracer)
    out = {}
    for m in spec.metrics_for(bench, cell_name, trace=True):
        v = spec.reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out, summary


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             traced: bool, device: str = "cuda",
             t_start: Optional[float] = None, cfg: Optional[dict] = None,
             mix: Optional[dict] = None, limits: Optional[dict] = None) -> dict:
    """One run of the cell; returns the result line's object.  ``cfg``,
    ``mix`` and ``limits`` replace the cell's files (the CPU tests' small
    sizes)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.cell(bench, cell_name)
    cfg = cfg or spec.config(bench, cell["config"])
    mix = mix or spec.traffic(cell["traffic"])
    limits = limits or spec.limits(cell_name)
    dev = torch.device(device)
    state = build(cfg, mix, seed, dev)
    has_backlog = bool(mix.get("backlog"))
    warm(state, has_backlog)
    tracer = trace.Tracer(mix["trace_seconds"]) if traced else None
    reqs, prompts, backlog = requests(
        state, seed, seconds, mix["trace_seconds"] + 1.0 if traced else 0.0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s; window of {seconds} s opens")

    win = client.run_window(state.serving, state.standby, reqs, prompts,
                            seconds, mix["preempt_at"], tracer, backlog)
    if tracer is not None:
        tracer.finish()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    shape = cost.model_shape(cfg)
    describe(win)

    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else dev.type,
                "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {}
    if traced:
        metrics, summary = per_layer(bench, cell_name, state, win, tracer, shape)
        if summary is not None:
            dev_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
            result["breakdown"] = {
                "device_ops": [[n, s] for n, s in summary.device_ops],
                "idle_gaps": sorted(([k, v] for k, v in summary.idle_by_host.items()),
                                    key=lambda kv: -kv[1])[:10]}
            log(f"trace: {len(summary.kernels)} device operations, busy "
                f"{summary.busy_s:.4f} of {summary.window_s:.4f} s")
    else:
        names = [m["name"] for m in spec.metrics_for(bench, cell_name, False)]
        metrics = {n: {"value": v, "unit": unit(bench, n)}
                   for n, v in endtoend.compute(names, win, setup_s).items()}

    # the check: the program's state freed first, the weights kept
    sample = check.choose_sample(win, seed, mix["check"])
    state.replicas.clear()
    state.model = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    found = check.gaps(cfg, state.W, sample, prompts)
    log(f"check: {len(sample)} attempts, reference "
        f"{time.perf_counter() - t:.3f} s; " + ", ".join(
            f"{k} {v}" for k, v in found.items()))
    checks = check.verdict(found, sample, limits, failed=0)
    attempted = len(win.due) + len(backlog)
    return {"correct": check.passed(checks), "attempted": attempted,
            "failed": 0, "metrics": metrics, "device": dev_info, **result,
            "checks": checks}


def unit(bench: dict, name: str) -> str:
    return next(m["unit"] for m in bench["end_to_end"] + bench["per_layer"]
                if m["name"] == name)


def describe(win) -> None:
    """The window's counts and timings, on standard error."""
    done = sum(1 for a in win.final.values() if len(a.tokens) == a.want)
    log(f"window: {win.close - win.start:.3f} s, {len(win.due)} arrivals, "
        f"{len(win.attempts)} attempts ({sum(a.retry for a in win.attempts)} "
        f"retries), {endtoend.window_tokens(win)} tokens, {len(win.rounds)} "
        f"steps, {len(win.prefills)} prefills, preemption at "
        f"{'none' if win.kill_at is None else f'{win.kill_at - win.start:.3f} s'}"
        f", {done} requests completed")
    gaps = endtoend.token_gaps(win)
    ttft = endtoend.ttfts(win)
    if gaps:
        log(f"token gaps: {len(gaps)}, p50 {1e3 * endtoend.percentile(gaps, 50):.3f}"
            f" p95 {1e3 * endtoend.percentile(gaps, 95):.3f} ms")
    if ttft:
        log(f"first-token times: {len(ttft)}, p50 "
            f"{1e3 * endtoend.percentile(ttft, 50):.3f} p90 "
            f"{1e3 * endtoend.percentile(ttft, 90):.3f} ms")
