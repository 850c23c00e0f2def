"""Live serving: real prefill + greedy decode replicas behind a least-loaded
dispatcher, with a preemption (counterpart of ``examples/serve_llm.py``).

Each request is prefilled on its replica, then decoded greedily one token
per replica step; it completes with the prefill token plus ``out_tokens``
decode tokens.  At step ``kill_step`` replica 0 is preempted: its in-flight
requests are dropped and retried client-side, re-prefilled on a survivor
(the paper's §4 preemption handling), so no request is lost.

    python -m repro_torch.serving.live                 # llama3.2-1b on CUDA
    python -m repro_torch.serving.live --smoke --device cpu
    python -m repro_torch.serving.live --arch falcon-mamba-7b
    python -m repro_torch.serving.live --arch falcon-mamba-7b --smoke --device cpu
    python -m repro_torch.serving.live --arch qwen3-moe-30b
    python -m repro_torch.serving.live --arch qwen3-moe-30b --smoke --device cpu

The replicas are model-agnostic: they call ``init_cache`` / ``prefill`` /
``decode_step``, whatever the model keeps in its cache (KV for attention,
dense or MoE, conv and SSM states for Mamba-1).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch import resolve_device


class LiveReplica:
    """A real prefill + decode engine; one cache per in-flight request."""

    def __init__(self, name: str, model, max_len: int = 96,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        self.name, self.model = name, model
        self.max_len = max_len
        self.dtype = dtype
        self.alive = True
        self.inflight: List[list] = []   # [req_id, cache, tok, remaining, out]
        self.prefill_s: List[float] = []
        self.prefill_lens: List[int] = []
        self.decode_s: List[float] = []

    @torch.inference_mode()
    def submit(self, req_id: int, prompt: torch.Tensor, out_tokens: int) -> None:
        t0 = time.perf_counter()
        cache = self.model.init_cache(1, self.max_len, dtype=self.dtype)
        logits, cache = self.model.prefill(prompt[None], cache, dtype=self.dtype)
        tok = logits.argmax(-1)                        # (1, 1)
        out = [int(tok[0, 0])]                         # waits for the device
        self.prefill_s.append(time.perf_counter() - t0)
        self.prefill_lens.append(int(prompt.shape[0]))
        self.inflight.append([req_id, cache, tok, out_tokens, out])

    @torch.inference_mode()
    def step(self):
        """One decode step for every in-flight request; returns the
        (req_id, tokens) of those that completed."""
        done, still = [], []
        for req_id, cache, tok, remaining, out in self.inflight:
            t0 = time.perf_counter()
            logits, cache = self.model.decode_step(tok, cache, dtype=self.dtype)
            tok = logits.argmax(-1)
            out.append(int(tok[0, 0]))
            self.decode_s.append(time.perf_counter() - t0)
            remaining -= 1
            if remaining <= 0:
                done.append((req_id, out))
            else:
                still.append([req_id, cache, tok, remaining, out])
        self.inflight = still
        return done

    def kill(self) -> List[int]:
        """Preemption: drop in-flight work, return ids for client retry."""
        self.alive = False
        failed = [item[0] for item in self.inflight]
        self.inflight = []
        return failed


@dataclasses.dataclass
class FleetResult:
    completed: Dict[int, List[int]]      # request id -> generated tokens
    retried: List[int]                   # ids retried after the preemption
    prefills: int                        # model.prefill calls, retries included
    decode_steps: int                    # model.decode_step calls
    prefill_s: List[float]               # host seconds per prefill
    prefill_lens: List[int]              # prompt length of each prefill
    decode_s: List[float]                # host seconds per decode step
    wall_s: float


def serve_fleet(
    model,
    prompts: Dict[int, torch.Tensor],
    *,
    replicas: int = 2,
    out_tokens: int = 16,
    max_len: int = 96,
    kill_step: int = 4,
    dtype: torch.dtype = torch.bfloat16,
    log: Callable[[str], None] = print,
) -> FleetResult:
    """Serve ``prompts`` (id -> 1-D token tensor on the model's device) on
    ``replicas`` replicas sharing ``model``; replica 0 is preempted after
    step ``kill_step``."""
    reps = [LiveReplica(f"replica-{i}", model, max_len, dtype)
            for i in range(replicas)]
    pending = list(prompts)
    completed: Dict[int, List[int]] = {}
    retried: List[int] = []

    t0 = time.perf_counter()
    step = 0
    while len(completed) < len(prompts):
        ready = [r for r in reps if r.alive]
        if not ready:
            raise RuntimeError("no live replica left to serve the pending requests")
        # least-loaded dispatch of pending requests
        while pending:
            req = pending.pop(0)
            target = min(ready, key=lambda r: len(r.inflight))
            target.submit(req, prompts[req], out_tokens=out_tokens)
            log(f"[lb] request {req} -> {target.name}")
        for r in ready:
            for req_id, out in r.step():
                completed[req_id] = out
                log(f"[{r.name}] request {req_id} done ({len(out)} tokens)")
        step += 1
        if step == kill_step and reps[0].alive:
            failed = reps[0].kill()
            log(f"[cloud] PREEMPTION kills {reps[0].name}; retrying {failed} "
                "on survivors (client-side retry)")
            retried.extend(failed)
            pending = failed + pending
    wall = time.perf_counter() - t0
    prefill_s = [t for r in reps for t in r.prefill_s]
    prefill_lens = [n for r in reps for n in r.prefill_lens]
    decode_s = [t for r in reps for t in r.decode_s]
    return FleetResult(completed, retried, len(prefill_s), len(decode_s),
                       prefill_s, prefill_lens, decode_s, wall)


def make_prompts(cfg, *, n: int, min_len: int, max_len: int, seed: int,
                 device="cuda") -> Dict[int, torch.Tensor]:
    """``n`` prompts of lengths drawn in [min_len, max_len], tokens uniform
    over the vocabulary, from a numpy seed."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(min_len, max_len + 1, size=n)
    return {
        i: torch.from_numpy(rng.integers(0, cfg.vocab_size, size=int(s))).to(device)
        for i, s in enumerate(lengths)
    }


def main(argv=None) -> None:
    """The run of ``examples/serve_llm.py``: 8 requests of 12 prompt
    tokens, 16 output tokens, replica 0 preempted at step 4; seeded random
    weights."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.registry import build_model

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--replicas", type=int, default=2)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    gen = torch.Generator(device=device).manual_seed(0)
    model = build_model(cfg, device=device, dtype=dtype, generator=gen)
    prompts = make_prompts(cfg, n=8, min_len=12, max_len=12, seed=7,
                           device=device)
    res = serve_fleet(model, prompts, replicas=args.replicas, dtype=dtype)
    n_tok = sum(len(v) for v in res.completed.values())
    print(f"\nserved {len(res.completed)} requests / {n_tok} tokens in "
          f"{res.wall_s:.1f}s on {device} across a preemption "
          f"({len(res.retried)} retried) — zero lost requests")


if __name__ == "__main__":
    main()
