"""The serve step: one greedy decode step of one request, captured once as
a CUDA graph and replayed (counterpart of ``build_serve_step`` in
``repro.launch.steps``, which lowers the same function under ``jax.jit``).

The step is the reference's ``fn``: ``decode_step`` against the cache,
then the greedy ``argmax``, returning the next token.  The model keeps the
cache length on the device and advances it in place
(``repro_torch.models.lm``), so the step reads nothing back to the host and
one capture replays at every position.

On the card ``build_serve_step`` holds a static token buffer beside the
request's cache (the cache's tensors are the graph's static state), warms
the step up on a side stream (cuBLAS workspaces, the kernels' arrival
counters of that stream, their shared-memory attributes), then captures
it in a ``torch.cuda.CUDAGraph``; calling the step replays the graph.
Graphs of one replica share one memory pool (``pool``) and one capture
stream, and replay one after another on the caller's stream.  A capture
that fails raises: nothing falls back to eager on the card.

The step takes any model of the port whose ``decode_step`` keeps to that
contract, the encoder-decoder ``EncDecLM`` too: its cache's cross K/V and
cross mask are static state like the self K/V (prefill writes them in
place), and one replay of whisper-medium's step launches 2 × 24
flash_decode, each decoder layer's self-attention and cross-attention.

On the CPU the same function runs eagerly: that is the only path a test
can run here, chosen by the cache's device, as the kernel wrappers choose.

Prefill stays eager: every request has its own prompt length.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.kernels import ops


class ServeStep:
    """One request's decode step: ``step()`` (or ``step(tokens)``) runs one
    greedy step against ``cache`` and returns ``step.tokens``, the (B, 1)
    int64 buffer that holds the next token and is the next call's input
    (overwritten by that call).  ``step.logits`` holds the step's logits.

    On the card the step is a CUDA graph.  A replay runs no Python kernel
    wrapper, so the launches the graph holds are counted once at capture
    (``launches``, per wrapper) and added to ``<wrapper>.launches`` at every
    replay; the warmup and the capture themselves leave every counter as it
    was before them."""

    def __init__(self, model, cache: Dict[str, Any], *,
                 dtype: torch.dtype = torch.bfloat16,
                 pool: Optional[Any] = None,
                 stream: Optional[torch.cuda.Stream] = None) -> None:
        self.model, self.cache, self.dtype = model, cache, dtype
        batch = model.cache_batch(cache)
        self.tokens = torch.zeros((batch, 1), dtype=torch.long,
                                  device=model.device)
        self.logits: Optional[torch.Tensor] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}
        if model.device.type == "cuda":
            self._capture(pool, stream)

    def _step(self) -> torch.Tensor:
        self.logits, _ = self.model.decode_step(self.tokens, self.cache,
                                                dtype=self.dtype)
        self.tokens.copy_(self.logits.argmax(-1))
        return self.tokens

    @torch.inference_mode()
    def _capture(self, pool, stream) -> None:
        wrappers = ops.KERNEL_WRAPPERS
        counted = {fn: fn.launches for fn in wrappers}
        stream = stream if stream is not None else torch.cuda.Stream(
            self.model.device)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self._step()             # warmup, on the capture stream
        torch.cuda.current_stream().wait_stream(stream)
        before = {fn: fn.launches for fn in wrappers}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            self._step()
        self.launches = {fn.__name__: fn.launches - before[fn] for fn in wrappers}
        for fn in wrappers:          # the warmup and the capture count nothing
            fn.launches = counted[fn]
        self.graph = graph
        # the warmup stepped the cache: hand it back empty
        self.model.reset_cache(self.cache)
        self.tokens.zero_()

    @torch.inference_mode()
    def __call__(self, tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
        if tokens is not None and tokens is not self.tokens:
            self.tokens.copy_(tokens)
        if self.graph is None:
            return self._step()
        self.graph.replay()
        for fn in ops.KERNEL_WRAPPERS:
            fn.launches += self.launches[fn.__name__]
        return self.tokens


def build_serve_step(model, cache: Dict[str, Any], *,
                     dtype: torch.dtype = torch.bfloat16,
                     pool: Optional[Any] = None,
                     stream: Optional[torch.cuda.Stream] = None) -> ServeStep:
    """The serve step of ``model`` on ``cache`` (one request's cache, of any
    batch): captured on the card, eager on the CPU.  On the card ``cache``
    comes back empty (length 0, zeros): fill it with ``model.prefill``
    after this, not before."""
    return ServeStep(model, cache, dtype=dtype, pool=pool, stream=stream)


__all__ = ["ServeStep", "build_serve_step"]
