"""The train CLI of the port (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 20 --batch 4 --seq 128 --scale smoke [--device cpu]

The reference's flags and lines: ``--scale smoke`` trains the reduced
config, ``full`` the published one; the model is built with
``impl="blockwise"`` (the reference's train path) and ``remat=True``,
float32 parameters (the reference's ``init`` draws float32) from seed 0,
activations in bf16 (the reference's ``loss`` default); batches come from
``make_batch`` at (seed 0, step).  Every ``--ckpt-every`` steps an atomic
checkpoint is written to ``--ckpt-dir``; a run finding one there resumes
from the newest complete one.  ``--device`` defaults to ``cuda``; without
CUDA the CLI raises unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.distributed.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.launch.steps import build_train_step
from repro_torch.training import AdamWConfig
from repro_torch.training.data import make_batch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3.2-1b")
    ap.add_argument("--scale", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (get_smoke_config if args.scale == "smoke" else get_config)(args.arch)
    step_fn = build_train_step(
        cfg, microbatches=args.microbatches, param_dtype=torch.float32,
        compress_grads=args.compress_grads,
        opt_cfg=AdamWConfig(total_steps=max(args.steps, 100)), device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    print(f"[train] {cfg.name}: {step_fn.model.num_params() / 1e6:.1f}M "
          f"params, devices=1 ({dev})")

    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        restored, start = restore_checkpoint(args.ckpt_dir, step_fn.state())
        step_fn.load(restored)
        print(f"[train] resumed from step {start}")

    t0 = time.perf_counter()
    for step in range(start, args.steps):
        batch = make_batch(cfg, args.batch, args.seq, seed=0, step=step,
                           device=dev)
        m = step_fn(batch)
        if step % 5 == 0 or step == args.steps - 1:
            print(f"[train] step {step:4d} loss {float(m['loss']):9.4f} "
                  f"gnorm {float(m['grad_norm']):9.3f}")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, step + 1, step_fn.params,
                            step_fn.opt_state)
    print(f"[train] {args.steps - start} steps in "
          f"{time.perf_counter() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
