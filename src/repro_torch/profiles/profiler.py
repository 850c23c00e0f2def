"""Micro-benchmark the port's kernels into per-model step-time tables
(counterpart of ``repro.profiles.profiler``, case for case).

For each model config the profiler times the kernels its architecture
runs per serving step, through ``repro_torch.kernels.ops``:

* prefill: ``flash_attention`` on a causal (B, S, H, D) input; the
  selective scan over one 64-step chunk for the ssm family; the grouped
  matmul ``moe_gmm`` at capacity 128 for MoE;
* decode: ``flash_decode`` against a fully valid cache; a one-step scan for
  the ssm family (the reference profiles no MoE decode case, nor does the
  port);

and turns the measurements into the two numbers the roofline latency
model consumes:

* ``mfu_prefill`` — achieved prefill FLOP/s over the instance's peak
  (``accel_count × peak_bf16_tflops``),
* ``mbu_decode``  — achieved decode HBM bytes/s over the instance's peak
  bandwidth (``accel_count × hbm_bytes_per_s``).

On the card (``device="cuda"``) each case runs its CUDA kernel: one warmup
call, then the best of ``repeats`` calls, each timed with CUDA events
around it.  Rows carry ``backend="cuda"``, ``mode="compiled"``.

On the CPU (``device="cpu"``, asked for explicitly) the same cases run the
kernels' plain PyTorch versions, timed with the host clock, into rows of
``backend="cpu"``, ``mode="eager"``.  Such rows validate the
profile → latency plumbing end to end; they are orders of magnitude below
what the card does and are not silicon numbers, as the reference says of
its ``interpret`` rows.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.cluster.catalog import InstanceType
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.profiles.schema import ProfileEntry, ProfileTable

__all__ = ["card_description", "profile_model", "profile_models"]

# the recurrence is sequential in time, so one chunk is the natural (and
# repeated) unit of work
_SCAN_CHUNK = 64
# MoE prefill capacity per expert (tokens routed to one expert)
_MOE_CAPACITY = 128

Case = Tuple[Callable[[], torch.Tensor], float]


def card_description(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` reports them
    (e.g. "NVIDIA H100 80GB HBM3, 700.00 W"); ``"cpu"`` for the CPU."""
    if device.type == "cpu":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[device.index or 0]


def _time_call(fn: Callable[[], torch.Tensor], repeats: int,
               device: torch.device) -> float:
    """Best-of-``repeats`` seconds of one call, after one untimed warmup
    call (building and loading a kernel is not step time).  On the card,
    CUDA events around each call; on the CPU, the host clock."""
    fn()
    best = float("inf")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(max(repeats, 1)):
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        return best
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _rnd(gen: torch.Generator, shape: Tuple[int, ...],
         dtype: torch.dtype) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32).to(dtype)


def _prefill_cases(cfg: ModelConfig, tokens: int, batch: int,
                   gen: torch.Generator) -> List[Case]:
    """(thunk, flops) per kernel the arch runs during prefill."""
    cases: List[Case] = []
    if cfg.num_heads:
        B, S = batch, tokens
        H, Kv, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        q = _rnd(gen, (B, S, H, D), torch.bfloat16)
        k = _rnd(gen, (B, S, Kv, D), torch.bfloat16)
        v = _rnd(gen, (B, S, Kv, D), torch.bfloat16)
        # QK^T + PV are 2·S²·D MACs each per head; causal halves the
        # live blocks
        flops = 4.0 * B * H * S * S * D * 0.5
        cases.append((lambda: ops.flash_attention(q, k, v, causal=True), flops))
    if cfg.family in ("ssm", "hybrid"):
        B, Q = batch, min(tokens, _SCAN_CHUNK)
        C, N = cfg.d_inner, cfg.ssm_state
        a = torch.sigmoid(_rnd(gen, (B, Q, C, N), torch.float32))
        b = _rnd(gen, (B, Q, C, N), torch.float32) * 0.1
        h0 = torch.zeros((B, C, N), dtype=torch.float32, device=gen.device)
        # h = a·h + b: one mul + one add per (C, N) element per step
        flops = 2.0 * B * Q * C * N
        cases.append((lambda: ops.selective_scan(a, b, h0), flops))
    if cfg.is_moe:
        E, C = cfg.num_experts, _MOE_CAPACITY
        D, F = cfg.d_model, cfg.expert_d_ff
        x = _rnd(gen, (E, C, D), torch.bfloat16)
        w = _rnd(gen, (E, D, F), torch.bfloat16)
        flops = 2.0 * E * C * D * F
        cases.append((lambda: ops.moe_gmm(x, w), flops))
    if not cases:
        raise ValueError(f"model family {cfg.family!r} maps to no profiled kernel")
    return cases


def _decode_cases(cfg: ModelConfig, cache_tokens: int, batch: int,
                  gen: torch.Generator) -> List[Case]:
    """(thunk, bytes moved) per kernel one decode step runs."""
    cases: List[Case] = []
    if cfg.num_heads:
        B, S = batch, cache_tokens
        H, Kv, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        q = _rnd(gen, (B, 1, H, D), torch.bfloat16)
        kc = _rnd(gen, (B, S, Kv, D), torch.bfloat16)
        vc = _rnd(gen, (B, S, Kv, D), torch.bfloat16)
        valid = torch.ones((B, S), dtype=torch.int8, device=gen.device)
        # decode attention streams the whole K and V cache once
        nbytes = 2.0 * B * Kv * S * D * kc.element_size()
        cases.append((lambda: ops.flash_decode(q, kc, vc, kv_valid=valid),
                      nbytes))
    if cfg.family in ("ssm", "hybrid"):
        B = batch
        C, N = cfg.d_inner, cfg.ssm_state
        a = torch.sigmoid(_rnd(gen, (B, 1, C, N), torch.float32))
        b = _rnd(gen, (B, 1, C, N), torch.float32) * 0.1
        h0 = _rnd(gen, (B, C, N), torch.float32)
        # read a, b, h; write h' — all fp32
        nbytes = 4.0 * B * C * N * 4
        cases.append((lambda: ops.selective_scan(a, b, h0), nbytes))
    if not cases:
        raise ValueError(f"model family {cfg.family!r} maps to no profiled kernel")
    return cases


def profile_model(
    model_id: str,
    itype: InstanceType,
    *,
    prefill_tokens: int = 256,
    cache_tokens: int = 512,
    batch: int = 1,
    decode_steps: int = 4,
    repeats: int = 2,
    device="cuda",
) -> ProfileEntry:
    """Measure one (model × instance accelerator) step-time row on
    ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    cfg = get_config(model_id)
    gen = torch.Generator(device=dev).manual_seed(0)

    # attention kernels measure the full requested prompt; scan kernels
    # always measure one chunk (the unit the model repeats across a
    # prompt — see schema.ProfileEntry.prefill_tokens).  For attention-
    # free archs the chunk therefore IS the measured prompt length.
    measured_tokens = (prefill_tokens if cfg.num_heads
                       else min(prefill_tokens, _SCAN_CHUNK))

    prefill_wall = 0.0
    prefill_flops = 0.0
    for fn, flops in _prefill_cases(cfg, prefill_tokens, batch, gen):
        prefill_wall += _time_call(fn, repeats, dev)
        prefill_flops += flops

    decode_wall = 0.0
    decode_bytes = 0.0
    for fn, nbytes in _decode_cases(cfg, cache_tokens, batch, gen):
        decode_wall += _time_call(fn, max(repeats, decode_steps), dev)
        decode_bytes += nbytes

    peak_flops = itype.accel_count * itype.peak_bf16_tflops * 1e12
    peak_bytes = itype.accel_count * itype.hbm_bytes_per_s
    return ProfileEntry(
        model=model_id,
        accelerator=itype.accelerator,
        backend=dev.type,
        mode="compiled" if dev.type == "cuda" else "eager",
        torch_version=torch.__version__,
        device=card_description(dev),
        prefill_tokens=measured_tokens,
        prefill_flops=prefill_flops,
        prefill_wall_s=prefill_wall,
        decode_cache_tokens=cache_tokens,
        decode_steps=decode_steps,
        decode_bytes=decode_bytes,
        decode_wall_s=decode_wall,
        mfu_prefill=(prefill_flops / prefill_wall) / peak_flops,
        mbu_decode=(decode_bytes / decode_wall) / peak_bytes,
    )


def profile_models(model_ids, itype: InstanceType, *,
                   table: Optional[ProfileTable] = None,
                   **kwargs) -> ProfileTable:
    """Profile several models into one table (merging into ``table``)."""
    out = table if table is not None else ProfileTable()
    out.torch_version = torch.__version__
    for model_id in model_ids:
        entry = profile_model(model_id, itype, **kwargs)
        out.add(entry)
        out.backend = entry.backend
        out.mode = entry.mode
        out.device = entry.device
    return out
