"""The ~100M trainer of the port (counterpart of ``examples/train_100m.py``):
a ~100M-parameter llama-family model, synthetic data, checkpoint/restart
fault tolerance.

    PYTHONPATH=src python -m repro_torch.launch.train_100m --steps 30 \\
        [--batch 4 --seq 128 --ckpt-dir artifacts/train_100m_torch \\
         --ckpt-every 10] [--device cpu]
    # kill it mid-run, rerun the same command: it resumes from the last
    # atomic checkpoint (the SpotHedge training-side story).

As the reference: llama3.2-1b cut to 10 layers of width 768 (12 heads, 4
KV heads of 64, MLP 2048, vocabulary 32,000); the model built with
``impl="blockwise"`` (the reference's default) and ``remat=False``, float32
parameters from seed 0; AdamW at lr 3e-4, warmup 20, cosine over
max(steps, 100); one microbatch, activations in bf16 (the reference's
``loss`` default); batches from ``make_batch`` at (seed 1, step).  Every
``--ckpt-every`` steps an atomic checkpoint goes to ``--ckpt-dir``; a run
that finds one there resumes from the newest.  It prints the reference's
lines, and before ``done`` one more: the last step's loss and grad norm
to more digits, the loop's wall, the part of it spent writing
checkpoints and the first step's (which waits for its result), s/step
without the checkpoints and, on the card, the peak memory.
``--device`` defaults to ``cuda``; without CUDA the trainer raises unless
given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Any, Callable, Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.distributed.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.launch.steps import TrainStep
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import build_model
from repro_torch.training import AdamWConfig
from repro_torch.training.data import make_batch


def config() -> ModelConfig:
    """The ~100M-parameter llama-family config of the reference's trainer."""
    return dataclasses.replace(
        get_config("llama3.2-1b"),
        name="llama-100m",
        num_layers=10,
        d_model=768,
        num_heads=12,
        num_kv_heads=4,
        head_dim=64,
        d_ff=2048,
        vocab_size=32_000,
    )


def build_step(cfg: ModelConfig, steps: int, *, device: Any = "cuda",
               dtype: torch.dtype = torch.bfloat16) -> TrainStep:
    """The trainer's train step on ``cfg``: the model in float32 from seed 0
    on ``device``, AdamW with the trainer's schedule for ``steps`` steps,
    activations in ``dtype``."""
    dev = resolve_device(device)
    model = build_model(cfg, impl="blockwise", remat=False, device=dev,
                        dtype=torch.float32,
                        generator=torch.Generator(device=dev).manual_seed(0))
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=20,
                          total_steps=max(steps, 100))
    return TrainStep(model, opt_cfg, microbatches=1, dtype=dtype)


def train(
    cfg: ModelConfig,
    *,
    steps: int = 30,
    batch: int = 4,
    seq: int = 128,
    ckpt_dir: str = "artifacts/train_100m_torch",
    ckpt_every: int = 10,
    device: Any = "cuda",
    out: Callable[[str], None] = print,
) -> Dict[str, Any]:
    """Train ``cfg`` to ``steps`` (resuming from ``ckpt_dir``'s newest
    checkpoint if there is one) and print the trainer's lines through
    ``out``.  Returns the train step (``"step"``), the last step's
    metrics (``"metrics"``, None when nothing was left to run) and the
    step it resumed from (``"start"``)."""
    dev = resolve_device(device)
    step_fn = build_step(cfg, steps, device=dev)
    out(f"model {cfg.name}: {step_fn.model.num_params() / 1e6:.1f}M params")

    start = 0
    if latest_step(ckpt_dir) is not None:
        restored, start = restore_checkpoint(ckpt_dir, step_fn.state())
        step_fn.load(restored)
        del restored        # copied into the parameters and the moments
        out(f"resumed from checkpoint step {start}")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    metrics, ckpt_s, first_s = None, 0.0, 0.0
    t0 = time.perf_counter()
    for step in range(start, steps):
        b = make_batch(cfg, batch, seq, seed=1, step=step, device=dev)
        metrics = step_fn(b)
        printed = step % 5 == 0 or step == steps - 1
        if printed or step == start:
            loss = float(metrics["loss"])         # waits for the step
            if step == start:
                first_s = time.perf_counter() - t0
        if printed:
            out(f"step {step:4d} loss {loss:8.4f} "
                f"gnorm {float(metrics['grad_norm']):8.3f} "
                f"({(time.perf_counter() - t0) / (step - start + 1):.1f}"
                "s/step)")
        if (step + 1) % ckpt_every == 0:
            t1 = time.perf_counter()
            path = save_checkpoint(ckpt_dir, step + 1, step_fn.params,
                                   step_fn.opt_state)
            ckpt_s += time.perf_counter() - t1
            out(f"checkpointed -> {path}")
    wall = time.perf_counter() - t0
    if metrics is not None:
        n = steps - start
        peak = (f", peak {torch.cuda.max_memory_allocated(dev) / 2**30:.3f}"
                " GiB" if dev.type == "cuda" else "")
        out(f"final step {steps - 1} loss {float(metrics['loss']):.7f} "
            f"gnorm {float(metrics['grad_norm']):.6f}; {n} steps in "
            f"{wall:.3f} s, {ckpt_s:.3f} s of it in checkpoints, the first "
            f"step {first_s:.3f} s, {(wall - ckpt_s) / n:.4f} s/step{peak}")
    out("done")
    return {"step": step_fn, "metrics": metrics, "start": start}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="artifacts/train_100m_torch")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    train(config(), steps=args.steps, batch=args.batch, seq=args.seq,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
          device=args.device, out=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
