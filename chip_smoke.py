#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (compute capability 9.0) and ``nvcc``.  It:

1. prints the card's name and power limit (``nvidia-smi``) and builds the
   CUDA kernels from ``src/repro_torch/kernels/csrc`` for ``sm_90a``, one
   ``nvcc`` per source, all at once;
2. holds each kernel against its plain PyTorch version on the card, at the
   reference package's kernel tolerances (attention 2e-2 in bf16, 2e-5 in
   float32; the selective scan 1e-5), including the main paths' shapes;
3. times each kernel at its main path's shapes (device time from
   ``torch.profiler``, with its clock held against CUDA events): kernel,
   plain version, one PyTorch library call where one computes the same
   function (a yardstick the port never calls), and the card's bound;
4. serves two full-width models, one after the other, with seeded random
   bf16 weights, through the same helpers: llama3.2-1b (flash_attention in
   prefill, flash_decode in decode) and falcon-mamba-7b (64 Mamba-1 layers,
   the selective scan once per 256-token chunk of every prefill, no kernel
   in decode).  Each fleet has two replicas and eight requests of 128-1024
   prompt tokens, least-loaded dispatch, replica 0 preempted at step 4 and
   its requests retried on the survivor.  The launch counters are zeroed
   just before each fleet run and read just after: every request must
   complete with 33 tokens and every kernel must have launched exactly as
   often as the model's path says.  Prefill logits of the kernel path are
   compared with the plain path, and one prefill plus eight decode steps
   are profiled;
5. prints a ``kernels`` JSON line, the card line and, last, the device JSON
   line.

Any failure exits non-zero; without CUDA it exits 1 before printing results.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak, float32 peak
# outside the tensor cores, and HBM3 rate.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SCAN_TOL = 1e-5           # the reference's scan tolerance (test_kernels.py)

# llama3.2-1b attention at the main path's shapes
MAIN_H, MAIN_KV, MAIN_D = 32, 8, 64
PREFILL_S = 1024
DECODE_S = 2048

FA_CASES = [
    # (dtype, B, H, Kv, S, D, causal, window, prefix)
    (torch.bfloat16, 1, 32, 8, 1024, 64, True, None, 0),    # main path
    (torch.bfloat16, 1, 32, 8, 1000, 64, True, None, 0),    # ragged edge
    (torch.bfloat16, 1, 32, 8, 512, 64, True, 96, 0),       # sliding window
    (torch.bfloat16, 1, 32, 8, 512, 64, True, None, 32),    # prefix-LM
    (torch.bfloat16, 1, 8, 1, 512, 128, True, None, 0),     # D=128, MQA
    (torch.bfloat16, 2, 4, 4, 192, 64, False, None, 0),     # bidirectional
    (torch.float32, 1, 32, 8, 256, 64, True, None, 0),
    (torch.float32, 2, 8, 2, 200, 128, True, 96, 0),
]

FD_CASES = [
    # (dtype, B, H, Kv, S, D, valid lengths per batch row, ring)
    (torch.bfloat16, 1, 32, 8, 2048, 64, [600], False),     # main path
    (torch.bfloat16, 4, 32, 8, 2048, 64, [1, 300, 1000, 2048], False),
    (torch.bfloat16, 4, 32, 8, 2048, 64, [2048] * 4, True),  # ring slots
    (torch.bfloat16, 2, 8, 1, 1024, 128, [700, 1024], False),
    (torch.float32, 2, 32, 8, 2048, 64, [300, 1500], False),
    (torch.float32, 1, 8, 1, 1024, 128, [700], False),
]

# falcon-mamba-7b's scan: d_inner 8192, ssm_state 16, 256-step chunks
SCAN_C, SCAN_N, SCAN_Q = 8192, 16, 256

SCAN_CASES = [
    # (label, dtype, B, S, chunk slice [c0, c1), C, N, nonzero h0)
    ("main path", torch.float32, 1, 256, (0, 256), 8192, 16, False),
    ("ragged last chunk of S=975", torch.float32, 1, 207, (0, 207), 8192, 16, True),
    ("B=2 N=8 Q=17", torch.float32, 2, 17, (0, 17), 1024, 8, True),
    ("nonzero h0", torch.float32, 1, 256, (0, 256), 8192, 16, True),
    ("chunk slice of (2, 975, 2048, 16)", torch.float32, 2, 975, (768, 975),
     2048, 16, True),
    ("bf16 inputs", torch.bfloat16, 1, 64, (0, 64), 8192, 16, True),
]


def log(*args) -> None:
    print(*args, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _on_device(events):
    """The profiler's device-side events (kernels, copies): not the host
    operators that launched them (summing both would count a kernel twice)
    and not the ``ProfilerStep`` range the profiler may mirror onto the
    device timeline, which spans the whole window."""
    from torch.autograd import DeviceType

    return [e for e in events
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("ProfilerStep")]


def profile_window(window, cpu: bool = False):
    """Run ``window`` twice under ``torch.profiler``: the first run is the
    profiler's warm-up cycle, whose events are discarded (a trace started
    cold was seen to lose its first few kernels), the second is recorded.

    Returns the recorded device events, the second run's host wall time in
    ms (it ends in a synchronize) and the profiler's clock ratio: the span
    of the recorded device events over the CUDA-event time of the same
    window.  It is near 1 when the profiler's device timestamps are right;
    a run of this script once recorded kernels at 0.6 of their CUDA-event
    time, below the card's byte bound."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        window()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        start.record()
        window()
        end.record()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        prof.step()
    device = [e.time_range for e in _on_device(prof.events())]
    if not device:
        raise RuntimeError("torch.profiler recorded no device events")
    span_ms = (max(r.end for r in device) - min(r.start for r in device)) / 1e3
    kernels = [e for e in _on_device(prof.key_averages())
               if e.self_device_time_total > 0]
    return kernels, wall_ms, span_ms / start.elapsed_time(end)


CLOCK_OK = (0.8, 1.05)    # accepted profiler clock ratios (see profile_window)


def checked_profile(window, cpu: bool = False, iters: int = 1, attempts: int = 3):
    """``profile_window`` held to what a right trace must show: device busy
    time no longer than the wall time, a clock ratio inside ``CLOCK_OK``,
    and, when ``window`` is ``iters`` identical calls, a kernel count that
    is a multiple of ``iters`` (else the profiler lost events).  A window
    that fails is measured again; after ``attempts`` failures this raises."""
    for _ in range(attempts):
        events, wall_ms, clock = profile_window(window, cpu=cpu)
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        n_kernels = sum(e.count for e in events)
        if busy_ms <= 0:
            raise RuntimeError("torch.profiler recorded no device time")
        if (n_kernels % iters == 0 and busy_ms <= wall_ms
                and CLOCK_OK[0] <= clock <= CLOCK_OK[1]):
            return events, wall_ms, clock
        log(f"torch.profiler recorded {n_kernels} kernels ({iters} identical "
            f"calls), busy {busy_ms:.3f} of {wall_ms:.3f} wall ms, clock ratio "
            f"{clock:.3f}; measuring again")
    raise RuntimeError(f"torch.profiler failed its checks in {attempts} windows")


def device_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms: the CUDA kernel time that
    ``torch.profiler`` records over ``iters`` calls after ``warmup`` calls,
    so host overhead between launches does not count."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events, _, _ = checked_profile(lambda: [fn() for _ in range(iters)],
                                   iters=iters)
    return sum(e.self_device_time_total for e in events) / 1e3 / iters


def bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    """Least time the card could take: the larger of flops over the peak
    for their type (bf16 tensor cores unless given) and bytes over the HBM
    rate.  Returns (ms, limiting resource)."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else ""


def randn(rng: np.random.Generator, shape, dtype) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
        device="cuda", dtype=dtype)


# ---------------------------------------------------------------------------
# Phase 1: card and build
# ---------------------------------------------------------------------------


def phase_card_and_build() -> None:
    from repro_torch.kernels import build

    log("card:", card_line())
    cap = torch.cuda.get_device_capability(0)
    log(f"device: {torch.cuda.get_device_name(0)} capability {cap} "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    if cap < (9, 0):
        raise RuntimeError(f"need compute capability >= 9.0, got {cap}")
    t0 = time.perf_counter()
    paths = build.build()
    log(f"build: {len(paths)} kernels in {time.perf_counter() - t0:.1f} s")
    for name in paths:
        for line in build.log_path(name).read_text().splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  ptxas[{name}]: {line.strip()}")


def attention_pairs(S: int, causal: bool, window, prefix: int) -> int:
    """Unmasked (query, key) pairs: the work this input needs."""
    q = np.arange(S)[:, None]
    k = np.arange(S)[None, :]
    m = np.ones((S, S), bool)
    if causal:
        m &= (q >= k) | (k < prefix)
    if window is not None:
        m &= q - k < window
    return int(m.sum())


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_flash_attention() -> float:
    """Every FA_CASES case, kernel against plain; returns the largest error."""
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(11)
    worst = 0.0
    for dtype, B, H, Kv, S, D, causal, window, prefix in FA_CASES:
        q = randn(rng, (B, S, H, D), dtype)
        k = randn(rng, (B, S, Kv, D), dtype)
        v = randn(rng, (B, S, Kv, D), dtype)
        kw = dict(causal=causal, window=window, prefix_len=prefix)
        got = fa.launch(q, k, v, **kw)
        want = fa.plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[dtype]
        ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
        log(f"flash_attention {str(dtype)[6:]} B={B} H={H} Kv={Kv} S={S} "
            f"D={D} causal={causal} window={window} prefix={prefix}: "
            f"max_abs_err={err:.3g} tol={tol} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("flash_attention disagrees with its plain version")
        worst = max(worst, err)
    return worst


def make_valid(B: int, S: int, lengths, ring: bool, rng) -> torch.Tensor:
    if ring:        # a ring buffer mid-wrap: an arbitrary set of live slots
        valid = rng.random((B, S)) < 0.7
        valid[:, 0] = True
    else:
        valid = np.arange(S)[None, :] < np.asarray(lengths)[:, None]
    return torch.from_numpy(valid.astype(np.int8)).cuda()


def check_flash_decode() -> float:
    """Every FD_CASES case, kernel against plain; returns the largest error."""
    from repro_torch.kernels import flash_decode as fd

    rng = np.random.default_rng(12)
    worst = 0.0
    for dtype, B, H, Kv, S, D, lengths, ring in FD_CASES:
        q = randn(rng, (B, 1, H, D), dtype)
        k = randn(rng, (B, S, Kv, D), dtype)
        v = randn(rng, (B, S, Kv, D), dtype)
        valid = make_valid(B, S, lengths, ring, rng)
        got = fd.launch(q, k, v, valid)
        want = fd.plain(q, k, v, valid)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[dtype]
        ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
        log(f"flash_decode {str(dtype)[6:]} B={B} H={H} Kv={Kv} S={S} D={D} "
            f"valid={'ring' if ring else lengths}: max_abs_err={err:.3g} "
            f"tol={tol} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("flash_decode disagrees with its plain version")
        worst = max(worst, err)
    return worst


def scan_inputs(rng, shape, dtype):
    """a = sigmoid(normal) in (0, 1) like exp(delta * A), b = 0.1 * normal,
    as the reference's scan test draws them."""
    a = torch.sigmoid(randn(rng, shape, torch.float32)).to(dtype)
    b = (0.1 * randn(rng, shape, torch.float32)).to(dtype)
    return a, b


def check_selective_scan() -> float:
    """Every SCAN_CASES case, kernel against plain; returns the largest
    error.  A chunk slice is a strided view of the longer tensor."""
    from repro_torch.kernels import selective_scan as ss

    rng = np.random.default_rng(15)
    worst = 0.0
    for label, dtype, B, S, (c0, c1), C, N, nonzero in SCAN_CASES:
        a, b = scan_inputs(rng, (B, S, C, N), dtype)
        a, b = a[:, c0:c1], b[:, c0:c1]
        h0 = (randn(rng, (B, C, N), torch.float32) if nonzero
              else torch.zeros((B, C, N), device="cuda"))
        got = ss.launch(a, b, h0)
        want = ss.plain(a, b, h0)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = torch.allclose(got, want, atol=SCAN_TOL, rtol=SCAN_TOL)
        log(f"selective_scan {label}: {str(dtype)[6:]} B={B} Q={c1 - c0} C={C} "
            f"N={N} contiguous={a.is_contiguous()}: max_abs_err={err:.3g} "
            f"tol={SCAN_TOL} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("selective_scan disagrees with its plain version")
        worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# Phase 4: serve each full-width model through the kernels
# ---------------------------------------------------------------------------


def expected_launches(model, res) -> dict:
    """Kernel launches the fleet run ``res`` must have made: attention
    models launch flash_attention once per layer and prefill and
    flash_decode once per layer and decode step; Mamba-1 launches the scan
    once per layer and 256-step chunk of every prefill (the last chunk
    ragged), and nothing in decode."""
    L = model.cfg.num_layers
    if model.cfg.family == "ssm":
        chunks = sum(math.ceil(s / model.ssm_chunk) for s in res.prefill_lens)
        return {"flash_attention": 0, "flash_decode": 0,
                "selective_scan": L * chunks}
    return {"flash_attention": L * res.prefills,
            "flash_decode": L * res.decode_steps, "selective_scan": 0}


def build_served_model(arch: str):
    """Full-width ``arch`` with random bf16 weights (seed 0) on the card,
    and the fleet's eight prompts of 128-1024 tokens (numpy seed 7)."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.serving.live import make_prompts

    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = build_model(cfg, impl="kernel", device="cuda",
                        dtype=torch.bfloat16, generator=gen)
    torch.cuda.synchronize()
    log(f"model: {cfg.name} {model.num_params():,} params, bf16, random "
        f"(seed 0), built in {time.perf_counter() - t0:.1f} s")
    prompts = make_prompts(cfg, n=8, min_len=128, max_len=1024, seed=7,
                           device="cuda")
    log("prompt lengths:", [len(p) for p in prompts.values()])
    return model, prompts


def phase_serve(model, prompts) -> dict:
    """The fleet run of ``model``; returns the kernel launches it made,
    counted from zero just before the run and read just after."""
    from repro_torch.kernels import ops
    from repro_torch.serving.live import serve_fleet

    name = model.cfg.name
    # warm up (cuBLAS handles, allocator) before the measured run
    serve_fleet(model, {0: prompts[0][:64]}, replicas=1, out_tokens=2,
                max_len=128, kill_step=0, log=lambda s: None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    res = serve_fleet(model, prompts, replicas=2, out_tokens=32,
                      max_len=2048, kill_step=4, log=log)
    launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}

    if sorted(res.completed) != sorted(prompts):
        raise AssertionError(f"lost requests: {set(prompts) - set(res.completed)}")
    for rid, toks in res.completed.items():
        if len(toks) != 33:
            raise AssertionError(f"request {rid} has {len(toks)} tokens, want 33")
    want = expected_launches(model, res)
    if launches != want:
        raise AssertionError(f"{name}: kernel launches {launches} != {want} "
                             f"({res.prefills} prefills of {res.prefill_lens}, "
                             f"{res.decode_steps} decode steps)")
    if not res.retried:
        raise AssertionError("the preemption retried no request")
    n_tok = sum(len(t) for t in res.completed.values())
    log(f"{name} served {len(res.completed)}/{len(prompts)} requests, "
        f"{n_tok} tokens, {len(res.retried)} retried after the preemption, in "
        f"{res.wall_s:.3f} s: {n_tok / res.wall_s:.1f} tokens/s, "
        f"prefills={res.prefills} (lengths {res.prefill_lens}) "
        f"mean_prefill_ms={1e3 * np.mean(res.prefill_s):.3f}, "
        f"decode_steps={res.decode_steps} "
        f"mean_decode_step_ms={1e3 * np.mean(res.decode_s):.3f}, peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"{name} launches on the serving path (want {json.dumps(want)}):",
        json.dumps(launches))
    return launches


def _prefill_logits(model, tokens, impl, dtype):
    model.impl = impl
    try:
        cache = model.init_cache(1, tokens.shape[1], dtype=dtype)
        return model.prefill(tokens, cache, dtype=dtype)[0].float()
    finally:
        model.impl = "kernel"


@torch.inference_mode()
def compare_prefill_logits(model, prompts, n: int = 4) -> None:
    """Prefill logits of the kernel path against the plain path, same
    weights, in float32 and in bf16 activations.

    float32: within 1e-3 (fp32 summation order differs between kernel and
    plain through the layers; logits are O(1)).  bf16: the kernel path may
    be no further from the float32 plain logits than twice the bf16 plain
    path is, i.e. it adds no error beyond bf16's own rounding."""
    top1 = []
    for rid in list(prompts)[:n]:
        tokens = prompts[rid][None]
        ref32 = _prefill_logits(model, tokens, "plain", torch.float32)
        got32 = _prefill_logits(model, tokens, "kernel", torch.float32)
        ref16 = _prefill_logits(model, tokens, "plain", torch.bfloat16)
        got16 = _prefill_logits(model, tokens, "kernel", torch.bfloat16)
        for t in (got32, got16):
            if not torch.isfinite(t).all():
                raise AssertionError("non-finite prefill logits")
        err32 = (got32 - ref32).abs().max().item()
        err16 = (got16 - ref16).abs().max().item()
        kernel16 = (got16 - ref32).abs().max().item()
        plain16 = (ref16 - ref32).abs().max().item()
        tol16 = 2 * plain16
        top1.append(bool(got16.argmax(-1).eq(ref16.argmax(-1)).all()))
        log(f"{model.cfg.name} prefill logits request {rid} (S={tokens.shape[1]}, max|logit|="
            f"{ref32.abs().max().item():.3f}): f32 kernel vs plain "
            f"max_abs_err={err32:.3g} tol=1e-3; bf16 kernel vs plain "
            f"max_abs_err={err16:.4g}; bf16 distance to f32 plain: kernel "
            f"{kernel16:.4g} plain {plain16:.4g} tol={tol16:.4g}; "
            f"top1_equal={top1[-1]}")
        if err32 > 1e-3:
            raise AssertionError("f32 prefill logits: kernel path disagrees with plain")
        if kernel16 > tol16:
            raise AssertionError("bf16 prefill logits: kernel path adds error")
    log(f"{model.cfg.name} prefill logits bf16 top-1 agreement kernel vs plain "
        f"{sum(top1)}/{len(top1)}")


@torch.inference_mode()
def profile_serving(model, prompts, decode_steps: int = 8) -> None:
    """Where a request's time goes: one prefill of the longest prompt and
    ``decode_steps`` decode steps under torch.profiler (each window run once
    as the profiler's warm-up, then recorded).  Prints wall time, device
    busy time (kernel time summed) and the device's idle share, and the
    kernels that take the most device time."""
    tokens = max(prompts.values(), key=len)[None]
    cache = model.init_cache(1, 2048)
    logits, cache = model.prefill(tokens, cache)
    state = {"tok": logits.argmax(-1)}

    def decode():
        for _ in range(decode_steps):
            logits, _ = model.decode_step(state["tok"], cache)
            state["tok"] = logits.argmax(-1)

    windows = {"prefill": lambda: model.prefill(tokens, model.init_cache(1, 2048)),
               "decode": decode}
    for phase, window in windows.items():
        events, wall_ms, clock = checked_profile(window, cpu=True)
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
        n = 1 if phase == "prefill" else decode_steps
        log(f"{model.cfg.name} profile {phase} (S={tokens.shape[1]}, {n} call(s), "
            f"profiler on): "
            f"wall_ms={wall_ms / n:.3f} device_busy_ms={busy_ms / n:.3f} "
            f"idle_share={1 - busy_ms / wall_ms:.3f} "
            f"profiler_clock_ratio={clock:.3f} top kernels per call: " +
            json.dumps({e.key[:60]: round(e.self_device_time_total / 1e3 / n, 4)
                        for e in top}))


# ---------------------------------------------------------------------------
# Phase 3: kernel times at the main path's shapes
# ---------------------------------------------------------------------------


def time_flash_attention() -> dict:
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(13)
    B, S, H, Kv, D = 1, PREFILL_S, MAIN_H, MAIN_KV, MAIN_D
    q = randn(rng, (B, S, H, D), torch.bfloat16)
    k = randn(rng, (B, S, Kv, D), torch.bfloat16)
    v = randn(rng, (B, S, Kv, D), torch.bfloat16)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    calls = {
        "kernel": lambda: fa.launch(q, k, v, causal=True),
        "plain": lambda: fa.plain(q, k, v, causal=True),
        "library": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True),
    }
    ms, plain_ms, library_ms = (device_ms(f) for f in calls.values())
    call_ms = {k: cuda_ms(f) for k, f in calls.items()}
    flops = 4.0 * B * H * D * attention_pairs(S, True, None, 0)
    nbytes = 2 * (2 * B * S * H * D + 2 * B * S * Kv * D)
    b_ms, b_by = bound_ms(flops, nbytes)
    log(f"flash_attention timing bf16 B={B} H={H} Kv={Kv} S={S} D={D} causal: "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        f"bound_ms={b_ms:.5f} ({b_by}) [device time, torch.profiler]; "
        f"per call with host overhead (CUDA events): {json.dumps(call_ms)}")
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:121",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": library_ms,
    }


def time_flash_decode() -> dict:
    from repro_torch.kernels import flash_decode as fd

    rng = np.random.default_rng(14)
    B, S, H, Kv, D = 1, DECODE_S, MAIN_H, MAIN_KV, MAIN_D
    n_valid = 600
    q = randn(rng, (B, 1, H, D), torch.bfloat16)
    k = randn(rng, (B, S, Kv, D), torch.bfloat16)
    v = randn(rng, (B, S, Kv, D), torch.bfloat16)
    valid = make_valid(B, S, [n_valid], False, rng)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = valid.bool()[:, None, None, :]
    calls = {
        "kernel": lambda: fd.launch(q, k, v, valid),
        "plain": lambda: fd.plain(q, k, v, valid),
        "library": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True),
    }
    ms, plain_ms, library_ms = (device_ms(f, iters=20) for f in calls.values())
    call_ms = {k: cuda_ms(f, iters=50) for k, f in calls.items()}
    flops = 4.0 * B * H * D * n_valid
    # q and out, the mask, and the K/V rows of valid slots (bf16)
    nbytes = 2 * 2 * B * H * D + B * S + 2 * 2 * B * n_valid * Kv * D
    b_ms, b_by = bound_ms(flops, nbytes)
    log(f"flash_decode timing bf16 B={B} H={H} Kv={Kv} S={S} D={D} "
        f"valid={n_valid}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} bound_ms={b_ms:.5f} ({b_by}) "
        f"[device time, torch.profiler]; per call with host overhead "
        f"(CUDA events): {json.dumps(call_ms)}")
    return {
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:74",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": library_ms,
    }


def time_selective_scan() -> dict:
    from repro_torch.kernels import selective_scan as ss

    rng = np.random.default_rng(16)
    B, Q, C, N = 1, SCAN_Q, SCAN_C, SCAN_N
    a, b = scan_inputs(rng, (B, Q, C, N), torch.float32)
    h0 = randn(rng, (B, C, N), torch.float32)
    calls = {
        "kernel": lambda: ss.launch(a, b, h0),
        "plain": lambda: ss.plain(a, b, h0),
    }
    ms, plain_ms = (device_ms(f) for f in calls.values())
    call_ms = {k: cuda_ms(f) for k, f in calls.items()}
    # one FMA per element and step on the fp32 units; a and b read once, h0
    # read, every h_t written (fp32)
    flops = 2.0 * B * Q * C * N
    nbytes = 4.0 * (3 * Q + 1) * B * C * N
    b_ms, b_by = bound_ms(flops, nbytes, PEAK_FP32_FLOPS)
    log(f"selective_scan timing f32 B={B} Q={Q} C={C} N={N}: kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms=null (no single PyTorch call "
        f"computes this recurrence) bound_ms={b_ms:.5f} ({b_by}) [device time, "
        f"torch.profiler]; per call with host overhead (CUDA events): "
        f"{json.dumps(call_ms)}")
    return {
        "name": "selective_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
        "replaces": "src/repro/kernels/selective_scan.py:42",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    }


def serve_path(arch: str) -> dict:
    """Phase 4 for one model: build, serve, compare logits, profile, free.
    Returns the launches of the fleet run."""
    model, prompts = build_served_model(arch)
    launches = phase_serve(model, prompts)
    compare_prefill_logits(model, prompts)
    # the profiler runs last: it must not slow the measured serving run
    profile_serving(model, prompts)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("error: chip_smoke.py needs a CUDA device "
              "(torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_card_and_build()
    errors = {"flash_attention": check_flash_attention(),
              "flash_decode": check_flash_decode(),
              "selective_scan": check_selective_scan()}
    # timed before the fleets: after both models' profiles, one run of this
    # script recorded kernels at 0.6 of their true time
    kernels = [time_flash_attention(), time_flash_decode(), time_selective_scan()]
    # each path's kernels, counted in that path's own fleet run
    llama = serve_path("llama3.2-1b")
    mamba = serve_path("falcon-mamba-7b")
    launches = {"flash_attention": llama["flash_attention"],
                "flash_decode": llama["flash_decode"],
                "selective_scan": mamba["selective_scan"]}
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["max_abs_err"] = errors[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{key: k[key] for key in keys} for k in kernels]}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
