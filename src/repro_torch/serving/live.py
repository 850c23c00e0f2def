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
    python -m repro_torch.serving.live --arch zamba2-7b
    python -m repro_torch.serving.live --arch zamba2-7b --smoke --device cpu
    python -m repro_torch.serving.live --arch whisper-medium
    python -m repro_torch.serving.live --arch whisper-medium --smoke --device cpu
    python -m repro_torch.serving.live --arch paligemma-3b
    python -m repro_torch.serving.live --arch paligemma-3b --smoke --device cpu
    python -m repro_torch.serving.live --arch h2o-danube3-4b
    python -m repro_torch.serving.live --arch qwen2.5-3b
    python -m repro_torch.serving.live --arch command-r-35b

The replicas are model-agnostic: they call ``init_cache`` / ``prefill`` /
``reset_cache`` and decode through the serve step
(``repro_torch.launch.steps``), whatever the model keeps in its cache (KV
for attention, dense or MoE, conv and SSM states for Mamba-1, both for
zamba2's hybrid, self and cross K/V for Whisper).  A request to an
encoder-decoder model carries its audio frames (1, S_enc, d_model) beside
its decoder prompt, and a request to a prefix-LM (paligemma-3b) its image
prefix, the stub frontend's (1, frontend_seq, d_model) patch embeddings,
before its text prompt; the replica hands them to ``prefill`` (the frames
first, the patches as ``prefix_embed``), and a retry after the preemption
re-prefills with the same frames or patches.  A replica
owns a fixed set of cache slots, each a cache with its serve step, made
when the replica is built: on the card each step is captured once there
as a CUDA graph (capturing writes into its cache, so it cannot wait for a
request), the graphs share the replica's memory pool, and every decode
step is a replay.  A request takes a free slot; prefill stays eager.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.launch.steps import ServeStep, build_serve_step


def prefill_request(model, tokens: torch.Tensor, cache: Dict[str, Any],
                    frames: Optional[torch.Tensor] = None,
                    dtype: torch.dtype = torch.bfloat16):
    """``model.prefill`` of one request's (B, S) ``tokens`` into ``cache``:
    an encoder-decoder model takes its audio ``frames`` first, a prefix-LM
    its image patches (passed as ``frames`` too) as ``prefix_embed``."""
    if frames is None:
        return model.prefill(tokens, cache, dtype=dtype)
    if model.cfg.is_encdec:
        return model.prefill(frames, tokens, cache, dtype=dtype)
    return model.prefill(tokens, cache, prefix_embed=frames, dtype=dtype)


@dataclasses.dataclass
class _Request:
    req_id: int
    slot: Tuple[Dict[str, Any], ServeStep]   # the cache and its serve step
    length: int                              # tokens in the cache (host copy)
    remaining: int
    out: List[int]


class LiveReplica:
    """A real prefill + decode engine with ``slots`` cache slots: at most
    that many requests in flight, each in its own cache with its own serve
    step (captured on the card when the replica is built)."""

    def __init__(self, name: str, model, max_len: int = 96,
                 dtype: torch.dtype = torch.bfloat16, *, slots: int) -> None:
        self.name, self.model = name, model
        self.dtype = dtype
        self.alive = True
        self.inflight: List[_Request] = []
        self.prefill_s: List[float] = []
        self.prefill_lens: List[int] = []
        self.decode_s: List[float] = []
        on_card = model.device.type == "cuda"
        pool = torch.cuda.graph_pool_handle() if on_card else None
        stream = torch.cuda.Stream(model.device) if on_card else None
        self.free: List[Tuple[Dict[str, Any], ServeStep]] = []
        for _ in range(slots):
            cache = model.init_cache(1, max_len, dtype=dtype)
            self.free.append((cache, build_serve_step(
                model, cache, dtype=dtype, pool=pool, stream=stream)))

    @torch.inference_mode()
    def submit(self, req_id: int, prompt: torch.Tensor, out_tokens: int,
               frames: Optional[torch.Tensor] = None) -> None:
        """Prefill ``prompt`` (1-D tokens) into a free cache slot; an
        encoder-decoder model also takes the request's audio ``frames``, a
        prefix-LM its image prefix (passed as ``frames`` too)."""
        if not self.free:
            raise RuntimeError(f"{self.name}: all {len(self.inflight)} cache "
                               "slots are in flight")
        t0 = time.perf_counter()
        cache, step = slot = self.free.pop()
        self.model.reset_cache(cache)
        logits, cache = prefill_request(self.model, prompt[None], cache,
                                        frames, self.dtype)
        length = int(prompt.shape[0])
        if frames is not None and not self.model.cfg.is_encdec:
            length += frames.shape[1]                  # the image prefix
        step.tokens.copy_(logits.argmax(-1))           # (1, 1)
        out = [int(step.tokens[0, 0])]                 # waits for the device
        self.prefill_s.append(time.perf_counter() - t0)
        self.prefill_lens.append(int(prompt.shape[0]))
        self.inflight.append(_Request(req_id, slot, length, out_tokens, out))

    @torch.inference_mode()
    def step(self):
        """One decode step for every in-flight request; returns the
        (req_id, tokens) of those that completed."""
        done, still = [], []
        for r in self.inflight:
            cache, step = r.slot
            capacity = self.model.cache_capacity(cache)
            if capacity is not None and r.length >= capacity:
                raise ValueError(f"request {r.req_id}: cache full, {r.length} "
                                 f"of {capacity} slots used")
            t0 = time.perf_counter()
            r.out.append(int(step()[0, 0]))
            self.decode_s.append(time.perf_counter() - t0)
            r.length += 1
            r.remaining -= 1
            if r.remaining <= 0:
                done.append((r.req_id, r.out))
                self.free.append(r.slot)
            else:
                still.append(r)
        self.inflight = still
        return done

    def kill(self) -> List[int]:
        """Preemption: drop in-flight work, return ids for client retry."""
        self.alive = False
        failed = [r.req_id for r in self.inflight]
        self.free += [r.slot for r in self.inflight]
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
    setup_s: float = 0.0                 # building the replicas' cache slots
    graphs: int = 0                      # of their serve steps, CUDA graphs


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
    frames: Optional[Dict[int, torch.Tensor]] = None,
) -> FleetResult:
    """Serve ``prompts`` (id -> 1-D token tensor on the model's device) on
    ``replicas`` replicas sharing ``model``; replica 0 is preempted after
    step ``kill_step``.  An encoder-decoder model takes each request's
    audio ``frames`` too, a prefix-LM each request's image prefix under the
    same name (id -> (1, frontend_seq, d_model), ``make_frames``).  Each
    replica has one cache slot per prompt (a survivor may end up holding
    every request); building them (and capturing their steps) is set-up,
    outside ``wall_s``."""
    t_setup = time.perf_counter()
    reps = [LiveReplica(f"replica-{i}", model, max_len, dtype,
                        slots=len(prompts))
            for i in range(replicas)]
    setup_s = time.perf_counter() - t_setup
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
            target.submit(req, prompts[req], out_tokens=out_tokens,
                          frames=None if frames is None else frames[req])
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
    # every request is done, so every slot is free again
    graphs = sum(s.graph is not None for r in reps for _, s in r.free)
    return FleetResult(completed, retried, len(prefill_s), len(decode_s),
                       prefill_s, prefill_lens, decode_s, wall, setup_s, graphs)


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


def make_frames(cfg, prompts: Dict[int, Any], *, seed: int,
                device="cuda") -> Dict[int, torch.Tensor]:
    """The stub frontend's embeddings for each request of ``prompts``: an
    encoder-decoder's audio frames or a prefix-LM's image patches, (1,
    frontend_seq, d_model), unit normal in float32 from a numpy seed (the
    reference's smoke tests draw theirs unit normal)."""
    rng = np.random.default_rng(seed)
    shape = (1, cfg.frontend_seq, cfg.d_model)
    return {i: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            .to(device) for i in prompts}


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
    frames = (make_frames(cfg, prompts, seed=8, device=device)
              if cfg.frontend else None)
    res = serve_fleet(model, prompts, replicas=args.replicas, dtype=dtype,
                      frames=frames)
    n_tok = sum(len(v) for v in res.completed.values())
    print(f"\nserved {len(res.completed)} requests / {n_tok} tokens in "
          f"{res.wall_s:.1f}s on {device} across a preemption "
          f"({len(res.retried)} retried) — zero lost requests")


if __name__ == "__main__":
    main()
