#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (compute capability 9.0) and ``nvcc``.  It:

1. prints the card's name and power limit (``nvidia-smi``) and builds the
   CUDA kernels from ``src/repro_torch/kernels/csrc`` for ``sm_90a``;
2. holds each kernel against its plain PyTorch version on the card
   (tolerance 2e-2 in bf16, 2e-5 in float32, as the reference package's
   kernel tests) and times kernel, plain version, one PyTorch library call
   (a yardstick the port never calls) and the bound of the card;
3. serves full-width llama3.2-1b with seeded random bf16 weights: two
   replicas, eight requests, least-loaded dispatch, replica 0 preempted at
   step 4 and its requests retried on the survivor; asserts that every
   request completes and that the kernels carried the path (launch counts),
   and compares prefill logits of the kernel path with the plain path;
4. prints a ``kernels`` JSON line and, last, the device JSON line.

Any failure exits non-zero; without CUDA it exits 1 before printing results.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak and HBM3 rate.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

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


def _kernel_events(prof):
    """The profiler's device-side events (kernels, copies), not the host
    operators that launched them: summing both would count a kernel twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def device_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms: the CUDA kernel time that
    ``torch.profiler`` records over ``iters`` calls after ``warmup`` calls,
    so host overhead between launches does not count."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in _kernel_events(prof))
    if total_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return total_us / 1e3 / iters


def bound_ms(flops: float, nbytes: float):
    """Least time the card could take: the larger of flops over the bf16
    peak and bytes over the HBM rate.  Returns (ms, limiting resource)."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
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


# ---------------------------------------------------------------------------
# Phase 3: serve full-width llama3.2-1b through the kernels
# ---------------------------------------------------------------------------


def build_llama():
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.serving.live import make_prompts

    cfg = get_config("llama3.2-1b")
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
    """The fleet run; returns the kernel launches it made."""
    from repro_torch.kernels import ops
    from repro_torch.serving.live import serve_fleet

    # warm up (cuBLAS handles, allocator) before the measured run
    serve_fleet(model, {0: prompts[0][:64]}, replicas=1, out_tokens=2,
                max_len=128, kill_step=0, log=lambda s: None)
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    res = serve_fleet(model, prompts, replicas=2, out_tokens=32,
                      max_len=2048, kill_step=4, log=log)
    launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}

    if sorted(res.completed) != sorted(prompts):
        raise AssertionError(f"lost requests: {set(prompts) - set(res.completed)}")
    for rid, toks in res.completed.items():
        if len(toks) != 33:
            raise AssertionError(f"request {rid} has {len(toks)} tokens, want 33")
    L = model.cfg.num_layers
    if launches["flash_attention"] != L * res.prefills:
        raise AssertionError(f"flash_attention launches {launches['flash_attention']}"
                             f" != {L} x {res.prefills} prefills")
    if launches["flash_decode"] != L * res.decode_steps:
        raise AssertionError(f"flash_decode launches {launches['flash_decode']}"
                             f" != {L} x {res.decode_steps} decode steps")
    if not res.retried:
        raise AssertionError("the preemption retried no request")
    n_tok = sum(len(t) for t in res.completed.values())
    log(f"served {len(res.completed)}/{len(prompts)} requests, {n_tok} tokens, "
        f"{len(res.retried)} retried after the preemption, in {res.wall_s:.3f} s: "
        f"{n_tok / res.wall_s:.1f} tokens/s, prefills={res.prefills} "
        f"mean_prefill_ms={1e3 * np.mean(res.prefill_s):.3f}, "
        f"decode_steps={res.decode_steps} "
        f"mean_decode_step_ms={1e3 * np.mean(res.decode_s):.3f}")
    log("launches on the serving path:", json.dumps(launches))
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
    plain through 16 layers; logits are O(1)).  bf16: the kernel path may be
    no further from the float32 plain logits than twice the bf16 plain
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
        log(f"prefill logits request {rid} (S={tokens.shape[1]}, max|logit|="
            f"{ref32.abs().max().item():.3f}): f32 kernel vs plain "
            f"max_abs_err={err32:.3g} tol=1e-3; bf16 kernel vs plain "
            f"max_abs_err={err16:.4g}; bf16 distance to f32 plain: kernel "
            f"{kernel16:.4g} plain {plain16:.4g} tol={tol16:.4g}; "
            f"top1_equal={top1[-1]}")
        if err32 > 1e-3:
            raise AssertionError("f32 prefill logits: kernel path disagrees with plain")
        if kernel16 > tol16:
            raise AssertionError("bf16 prefill logits: kernel path adds error")
    log(f"prefill logits bf16 top-1 agreement kernel vs plain {sum(top1)}/{len(top1)}")


@torch.inference_mode()
def profile_serving(model, prompts, decode_steps: int = 8) -> None:
    """Where a request's time goes: one prefill of the longest prompt and
    ``decode_steps`` decode steps under torch.profiler.  Prints wall time,
    device busy time (kernel time summed) and the device's idle share, and
    the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    tokens = max(prompts.values(), key=len)[None]
    for phase in ("prefill", "decode"):
        cache = model.init_cache(1, 2048)
        logits, cache = model.prefill(tokens, cache)
        tok = logits.argmax(-1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if phase == "prefill":
                model.prefill(tokens, model.init_cache(1, 2048))
            else:
                for _ in range(decode_steps):
                    logits, cache = model.decode_step(tok, cache)
                    tok = logits.argmax(-1)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        events = _kernel_events(prof)
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
        n = 1 if phase == "prefill" else decode_steps
        log(f"profile {phase} (S={tokens.shape[1]}, {n} call(s), profiler on): "
            f"wall_ms={wall_ms / n:.3f} device_busy_ms={busy_ms / n:.3f} "
            f"idle_share={1 - busy_ms / wall_ms:.3f} top kernels per call: " +
            json.dumps({e.key[:60]: round(e.self_device_time_total / 1e3 / n, 4)
                        for e in top}))


# ---------------------------------------------------------------------------
# Phase 4: kernel times at the main path's shapes
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


def main() -> int:
    if not torch.cuda.is_available():
        print("error: chip_smoke.py needs a CUDA device "
              "(torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_card_and_build()
    errors = {"flash_attention": check_flash_attention(),
              "flash_decode": check_flash_decode()}
    model, prompts = build_llama()
    launches = phase_serve(model, prompts)
    compare_prefill_logits(model, prompts)
    # the profiler runs last: it must not slow the measured serving run
    profile_serving(model, prompts)
    kernels = [time_flash_attention(), time_flash_decode()]
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
