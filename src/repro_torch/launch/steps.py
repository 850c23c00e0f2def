"""The steps of the port (counterpart of ``repro.launch.steps``): the serve
step and the prefill step, each captured once as a CUDA graph and
replayed, and the train step.

Serve step (``build_serve_step``, the reference's ``build_serve_step``)
-------------------------------------------------------------------------
The reference's ``fn``: ``decode_step`` against the cache, then the greedy
``argmax``, returning the next token.  The model keeps the cache length on
the device and advances it in place (``repro_torch.models.lm``), so the
step reads nothing back to the host and one capture replays at every
position.  It takes any model of the port whose ``decode_step`` keeps to
that contract, the encoder-decoder ``EncDecLM`` too: its cache's cross K/V
and cross mask are static state like the self K/V (prefill writes them in
place), and one replay of whisper-medium's step launches 2 x 24
flash_decode, each decoder layer's self-attention and cross-attention.

Prefill step (``build_prefill_step``, the reference's ``build_prefill_step``)
-----------------------------------------------------------------------------
``model.prefill`` at one fixed (batch, seq_len), as the reference lowers it
at ``shape.seq_len``: static token buffers (and the encoder-decoder's frames
or the prefix-LM's patches), the cache written in place (the counterpart of
the reference donating it) and the last position's logits.  The captured
function empties the cache first (``reset_cache``), so a replay leaves the
cache exactly as one eager ``model.prefill`` of those tokens into an empty
cache does, whatever the cache held before.  Prompts of other lengths are
not padded into it: padding would change a Mamba layer's final state.

Capture (both)
--------------
On the card the step holds its static inputs beside the cache (whose
tensors are the graph's static state), warms the step up on a side stream
(cuBLAS workspaces, the kernels' arrival counters of that stream, their
shared-memory attributes), then captures it in a ``torch.cuda.CUDAGraph``;
calling the step replays the graph.  The serve steps of one replica share
one memory pool (``pool``) and one capture stream, and replay one after
another on the caller's stream; a prefill step has its own.  A capture that fails raises: nothing falls back to
eager on the card.  A replay runs no Python kernel wrapper, so the launches
the graph holds are counted once at capture (``launches``, per wrapper) and
added to ``<wrapper>.launches`` at every replay; the warmup and the capture
themselves leave every counter as it was before them.  On the CPU the same
function runs eagerly: that is the only path a test can run here, chosen by
the cache's device, as the kernel wrappers choose.

Train step (``build_train_step``, the reference's ``build_train_step``)
-----------------------------------------------------------------------
A ``TrainStep`` over a model built with ``impl="blockwise"`` (the
reference's train path) and ``remat=True``, bf16 parameters by default and
fp32 AdamW moments, on the model's device; ``step(batch)`` updates the
parameters and the optimizer state in place and returns the metrics
(``repro_torch.training.train_loop``).  No mesh and no shardings: one
device.  It is not captured: it runs eagerly on either device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_loop import make_train_step


class _CapturedStep:
    """A step over ``cache`` run by ``_step()``: captured as a CUDA graph on
    the card when built, eager on the CPU (``graph`` None)."""

    model: Any
    cache: Dict[str, Any]

    def _init_capture(self, pool, stream) -> None:
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}
        if self.model.device.type == "cuda":
            self._capture(pool, stream)

    def _step(self) -> torch.Tensor:
        raise NotImplementedError

    def _inputs(self) -> List[torch.Tensor]:
        """The static input buffers, emptied with the cache after capture."""
        raise NotImplementedError

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
        # the warmup ran the step on the cache: hand it back empty
        self.model.reset_cache(self.cache)
        for t in self._inputs():
            t.zero_()

    @torch.inference_mode()
    def _run(self) -> torch.Tensor:
        if self.graph is None:
            return self._step()
        self.graph.replay()
        for fn in ops.KERNEL_WRAPPERS:
            fn.launches += self.launches[fn.__name__]
        return self._output()

    def _output(self) -> torch.Tensor:
        raise NotImplementedError


class ServeStep(_CapturedStep):
    """One request's decode step: ``step()`` (or ``step(tokens)``) runs one
    greedy step against ``cache`` and returns ``step.tokens``, the (B, 1)
    int64 buffer that holds the next token and is the next call's input
    (overwritten by that call).  ``step.logits`` holds the step's logits."""

    def __init__(self, model, cache: Dict[str, Any], *,
                 dtype: torch.dtype = torch.bfloat16,
                 pool: Optional[Any] = None,
                 stream: Optional[torch.cuda.Stream] = None) -> None:
        self.model, self.cache, self.dtype = model, cache, dtype
        batch = model.cache_batch(cache)
        self.tokens = torch.zeros((batch, 1), dtype=torch.long,
                                  device=model.device)
        self.logits: Optional[torch.Tensor] = None
        self._init_capture(pool, stream)

    def _step(self) -> torch.Tensor:
        self.logits, _ = self.model.decode_step(self.tokens, self.cache,
                                                dtype=self.dtype)
        self.tokens.copy_(self.logits.argmax(-1))
        return self.tokens

    def _inputs(self) -> List[torch.Tensor]:
        return [self.tokens]

    def _output(self) -> torch.Tensor:
        return self.tokens

    def __call__(self, tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
        if tokens is not None and tokens is not self.tokens:
            self.tokens.copy_(tokens)
        return self._run()


def build_serve_step(model, cache: Dict[str, Any], *,
                     dtype: torch.dtype = torch.bfloat16,
                     pool: Optional[Any] = None,
                     stream: Optional[torch.cuda.Stream] = None) -> ServeStep:
    """The serve step of ``model`` on ``cache`` (one request's cache, of any
    batch): captured on the card, eager on the CPU.  On the card ``cache``
    comes back empty (length 0, zeros): fill it with ``model.prefill``
    after this, not before."""
    return ServeStep(model, cache, dtype=dtype, pool=pool, stream=stream)


class PrefillStep(_CapturedStep):
    """``model.prefill`` of (batch, ``seq_len``) tokens into ``cache``:
    ``step(tokens[, frames= | patches=])`` copies its inputs into the static
    buffers ``step.tokens`` (int64), ``step.frames`` (an encoder-decoder's
    (B, S_enc, d_model)) or ``step.patches`` (a prefix-LM's (B,
    frontend_seq, d_model)), each in the activation dtype, empties the
    cache, prefills it in place and returns ``step.logits``, the last
    position's (B, 1, V) logits."""

    def __init__(self, model, cache: Dict[str, Any], seq_len: int, *,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        cfg = model.cfg
        self.model, self.cache, self.dtype = model, cache, dtype
        batch, dev = model.cache_batch(cache), model.device
        front = (batch, cfg.frontend_seq, cfg.d_model)
        self.frames = (torch.zeros(front, dtype=dtype, device=dev)
                       if cfg.is_encdec else None)
        self.patches = (torch.zeros(front, dtype=dtype, device=dev)
                        if cfg.frontend and not cfg.is_encdec else None)
        need = seq_len + (cfg.frontend_seq if self.patches is not None else 0)
        capacity = model.cache_capacity(cache)
        if capacity is not None and need > capacity:
            raise ValueError(f"a prefill of {need} positions exceeds the "
                             f"cache's {capacity} slots")
        self.tokens = torch.zeros((batch, seq_len), dtype=torch.long,
                                  device=dev)
        self.logits: Optional[torch.Tensor] = None
        self._init_capture(None, None)

    def _step(self) -> torch.Tensor:
        model = self.model
        model.reset_cache(self.cache)
        if self.frames is not None:
            self.logits, _ = model.prefill(self.frames, self.tokens,
                                           self.cache, dtype=self.dtype)
        else:
            self.logits, _ = model.prefill(self.tokens, self.cache,
                                           prefix_embed=self.patches,
                                           dtype=self.dtype)
        return self.logits

    def _inputs(self) -> List[torch.Tensor]:
        return [t for t in (self.tokens, self.frames, self.patches)
                if t is not None]

    def _output(self) -> torch.Tensor:
        return self.logits

    def __call__(self, tokens: torch.Tensor, *,
                 frames: Optional[torch.Tensor] = None,
                 patches: Optional[torch.Tensor] = None) -> torch.Tensor:
        for name, buf, value in (("tokens", self.tokens, tokens),
                                 ("frames", self.frames, frames),
                                 ("patches", self.patches, patches)):
            if (buf is None) != (value is None):
                raise ValueError(f"{self.model.cfg.name}'s prefill step "
                                 f"{'takes' if buf is not None else 'has no'} "
                                 f"{name}")
            if buf is not None:
                if value.shape != buf.shape:
                    raise ValueError(f"{name} {tuple(value.shape)}, the step "
                                     f"was built for {tuple(buf.shape)}")
                buf.copy_(value)
        return self._run()


def build_prefill_step(model, cache: Dict[str, Any], seq_len: int, *,
                       dtype: torch.dtype = torch.bfloat16) -> PrefillStep:
    """The prefill step of ``model`` at ``seq_len`` tokens into ``cache``
    (batch from the cache): captured on the card (its own memory pool and
    capture stream), eager on the CPU.  On the card ``cache`` comes back
    empty."""
    return PrefillStep(model, cache, seq_len, dtype=dtype)


class TrainStep:
    """A train step over ``model`` (made trainable here): ``step(batch)``
    runs ``make_train_step``'s step against ``step.opt_state`` and returns
    its metrics.  ``step.params`` maps each parameter's name to the
    model's tensor; ``state()`` is the tree a checkpoint saves and
    ``load(tree)`` copies a restored one back."""

    def __init__(self, model, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                 compress_grads: bool = False,
                 grad_accum: str = "f32_sharded",
                 dtype: torch.dtype = torch.bfloat16) -> None:
        model.requires_grad_(True)
        self.model, self.opt_cfg = model, opt_cfg
        self.params = dict(model.named_parameters())
        self.opt_state = adamw_init(self.params)
        self._fn = make_train_step(model, opt_cfg, microbatches=microbatches,
                                   compress_grads=compress_grads,
                                   grad_accum=grad_accum, dtype=dtype)

    def __call__(self, batch) -> Dict[str, torch.Tensor]:
        return self._fn(self.opt_state, batch)

    def state(self) -> Dict[str, Any]:
        return {"params": self.params, "opt_state": self.opt_state}

    @torch.no_grad()
    def load(self, tree: Dict[str, Any]) -> None:
        """Copy ``tree`` ({"params", "opt_state"} as ``state()``) into the
        model's parameters and the optimizer state."""
        def copy(dst, src):
            for k, v in src.items():
                if isinstance(v, dict):
                    if k not in dst:
                        dst[k] = {}
                    copy(dst[k], v)
                elif k in dst:
                    dst[k].copy_(v)
                else:
                    dst[k] = v.clone()
        copy(self.params, tree["params"])
        copy(self.opt_state, tree.get("opt_state", {}))


def build_train_step(
    cfg,
    *,
    microbatches: int = 16,
    param_dtype: torch.dtype = torch.bfloat16,
    compress_grads: bool = False,
    grad_accum: str = "f32_sharded",
    opt_cfg: Optional[AdamWConfig] = None,
    dtype: torch.dtype = torch.bfloat16,
    device: Any = "cuda",
    generator: Optional[torch.Generator] = None,
) -> TrainStep:
    """The train step of ``cfg``'s model, built with ``impl="blockwise"``
    and ``remat=True`` in ``param_dtype`` on ``device`` from ``generator``
    (seed 0 on the device by default), activations in ``dtype``."""
    from repro_torch.models.registry import build_model

    model = build_model(cfg, impl="blockwise", remat=True, device=device,
                        dtype=param_dtype, generator=generator)
    return TrainStep(model, opt_cfg or AdamWConfig(),
                     microbatches=microbatches, compress_grads=compress_grads,
                     grad_accum=grad_accum, dtype=dtype)


__all__ = ["PrefillStep", "ServeStep", "TrainStep", "build_prefill_step",
           "build_serve_step", "build_train_step"]
