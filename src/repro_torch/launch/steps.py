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

import collections.abc
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

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


# ===========================================================================
# Mesh-aware builders (the dry-run contract)
# ===========================================================================
#
# The reference's ``build_train_step`` / ``build_prefill_step`` /
# ``build_serve_step`` take (config, mesh, shape) and return a pjit-able
# function with abstract inputs and shardings; ``build_step`` dispatches on
# the shape's kind and ``input_specs`` returns the abstract inputs.  Their
# port keeps ``build_step`` and ``input_specs`` and names the three builders
# ``build_mesh_*_step``: the names above belong to the captured steps.
#
# A built step holds a model built on ``meta`` (shapes, no data) and meta
# inputs; on a mesh every parameter, cache tensor and input is a DTensor
# placed by ``distributed.sharding``'s rules, its local shard a meta tensor
# of one device's shape.  ``BuiltStep.run()`` runs the step itself, which
# ``launch.op_count`` counts and ``launch.dryrun`` records.  Sharding
# policy, as the reference's:
#
# * weights: Megatron TP over "model" (heads / mlp / vocab / experts /
#   ssm_inner); a dimension that does not divide falls back to replication;
# * train: batch over ("pod", "data"); optimizer state ZeRO-1 over "data";
# * prefill: batch over ("pod", "data"); the cache in the decode layout;
# * decode: context parallelism, the KV cache's sequence over "model",
#   batch over ("pod", "data").
#
# ``mesh=None`` is one device: plain meta tensors, no placements.  The
# model's ``impl`` defaults to "blockwise", as the reference's builders do;
# the serve and prefill builders also take ``impl="kernel"``, the port's
# serving path, where each kernel wrapper's meta route counts the kernel's
# own work (on a mesh, on one device's shards: ``kernels.ops._on_mesh``).

# the cache's logical axes, keyed by the port's cache keys (the reference's
# ``_CACHE_LOGICAL_AXES`` and ``_cache_pspec_tree``)
_KV_AXES = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
_CROSS_AXES = ("layers", "batch", None, "kv_heads", "head_dim")


def cache_logical(cache: Dict[str, Any]) -> Dict[str, Any]:
    """The logical axes of every cache tensor: K/V (layers or blocks,
    batch, slots, kv heads, head_dim) with their slots on ``kv_seq``;
    whisper's cross K/V over the encoder's frames, which are not sharded,
    and its (batch, frames) cross mask; the Mamba states with batch and
    their channels (``ssm_inner``, or the Mamba-2 heads) named; ``len``
    replicated."""
    def leaf(path: Tuple[str, ...], t: torch.Tensor) -> Tuple:
        name, nd = path[0], t.dim()
        if name == "len":
            return (None,) * nd
        if name in ("kv", "attn_kv"):
            return _KV_AXES
        if name in ("cross_k", "cross_v"):
            return _CROSS_AXES
        if name == "cross_valid":
            return ("batch", None)
        if name in ("ssm_state", "prelude_state", "block_state"):
            # (stack..., batch, channels...): batch, and channels over
            # model where they divide
            if path[-1] == "conv":
                return (None,) * (nd - 3) + ("batch", None, "ssm_inner")
            if nd >= 4 and path[-1] == "ssm":
                # mamba1: (L, B, di, N); mamba2: (stack.., B, H, P, N)
                if nd == 4:
                    return (None, "batch", "ssm_inner", None)
                return (None,) * (nd - 4) + ("batch", "heads", None, None)
            return (None,) * (nd - 1) + ("batch",)
        return (None,) * nd

    def walk(tree, path):
        if isinstance(tree, torch.Tensor):
            return leaf(path, tree)
        return {k: walk(v, path + (k,)) for k, v in tree.items()}

    return walk(cache, ())


def batch_placements(mesh, batch: int = 0) -> Tuple[Any, ...]:
    """Placements of a batch-leading input (the reference's ``_batch_spec``):
    dim 0 over ("pod", "data"); a batch the whole data extent does not
    divide over "data" alone where it divides that, else replicated."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    axes = ("pod", "data") if "pod" in sizes else ("data",)
    if batch:
        n = 1
        for a in axes:
            n *= sizes[a]
        if batch % n != 0:
            axes = ("data",) if (batch % sizes.get("data", 1) == 0
                                 and batch > 1) else ()
    return tuple(Shard(0) if name in axes else Replicate()
                 for name in mesh.mesh_dim_names)


def local_nbytes(tree: Any) -> int:
    """Bytes one device holds of a tree of tensors (a DTensor's local
    shard)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if isinstance(tree, DTensor) else tree
        return t.nbytes
    if isinstance(tree, dict):
        return sum(local_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(local_nbytes(v) for v in tree)
    return 0


def placements_of(tree: Any) -> Any:
    """The placements of every DTensor of a tree (None for a plain
    tensor)."""
    if isinstance(tree, torch.Tensor):
        return tuple(tree.placements) if hasattr(tree, "placements") else None
    if isinstance(tree, dict):
        return {k: placements_of(v) for k, v in tree.items()}
    return tuple(placements_of(v) for v in tree)


def _from_dtensor_code(err: BaseException) -> bool:
    """The exception was raised inside DTensor's own code (a sharding
    propagation it has no rule for, or an op it cannot run on shards)."""
    tb = err.__traceback__
    while tb is not None:
        if "torch/distributed/tensor/" in tb.tb_frame.f_code.co_filename:
            return True
        tb = tb.tb_next
    return False


_AUTOGRAD = (torch.autograd.grad, torch.autograd.backward,
             torch.Tensor.backward)


class ReplicateOnRefusal(torch.overrides.TorchFunctionMode):
    """Run a torch function that DTensor refuses on replicated inputs.

    DTensor has no sharding rule for some ops, or fails on some placements
    (its version decides which: torch 2.11's has no ``index_copy_`` and no
    two mesh dimensions on one tensor dimension, as the two-node mesh's
    batch over ("pod", "data") needs).  Such a call is run again on every
    DTensor input gathered whole (``Replicate`` on every mesh dimension,
    the collectives counted), its plain result wrapped as a replicated
    DTensor; an in-place call writes its result back into its first
    argument, in that argument's placements.  It computes what the call
    computes.  Each refused function is counted in ``refused`` with its
    first error, which the dry run records and prints."""

    def __init__(self) -> None:
        super().__init__()
        self.refused: Dict[str, int] = {}
        self.errors: Dict[str, str] = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

        kwargs = kwargs or {}
        # DTensor opts out of __torch_function__, so ``types`` never names
        # it: look at the arguments
        flat, spec = tree_flatten((args, kwargs))
        if not any(isinstance(x, DTensor) for x in flat):
            return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except (RuntimeError, NotImplementedError, ValueError,
                AssertionError, IndexError) as err:
            # a backward op's refusal surfaces here and is not this call's
            if func in _AUTOGRAD or not _from_dtensor_code(err):
                raise
            name = getattr(func, "__name__", str(func))
            self.refused[name] = self.refused.get(name, 0) + 1
            self.errors.setdefault(name, str(err).splitlines()[0][:300])
        mesh = next(x for x in flat if isinstance(x, DTensor)).device_mesh
        rep = [Replicate()] * mesh.ndim
        local = [x.redistribute(mesh, rep).to_local() if isinstance(x, DTensor)
                 else x for x in flat]
        l_args, l_kwargs = tree_unflatten(local, spec)
        target = args[0] if args else None
        in_place = isinstance(target, DTensor) and (
            name == "__setitem__" or name.startswith("__i")
            or (name.endswith("_") and not name.startswith("__")))
        if in_place:      # on a copy: the gathered local is DTensor's view
            l_args = (l_args[0].clone(),) + tuple(l_args[1:])
        out = func(*l_args, **l_kwargs)
        if isinstance(out, collections.abc.Iterator):     # Tensor.__iter__
            out = iter(tuple(out))
        if in_place and target.requires_grad and torch.is_grad_enabled():
            # inside autograd the result is a new tensor, as an in-place
            # op's caller reads it (``a = (...).exp_()``)
            return DTensor.from_local(l_args[0], mesh, rep, run_check=False)
        if in_place:
            # a state update (a cache, an accumulator): written back
            with torch.no_grad():
                written = DTensor.from_local(l_args[0], mesh, rep,
                                             run_check=False)
                target.to_local().copy_(
                    written.redistribute(mesh, target.placements).to_local())
            return None if name == "__setitem__" else target
        lead = next(x for x in flat if isinstance(x, DTensor))

        def wrap(t):
            """A plain result as a DTensor, sharded back as the first
            DTensor input was where its shape allows (the gathered copy is
            sliced locally), replicated elsewhere."""
            if not isinstance(t, torch.Tensor) or isinstance(t, DTensor):
                return t
            out = DTensor.from_local(t, mesh, rep, run_check=False)
            back = [p if isinstance(p, Shard) and p.dim < t.dim()
                    and t.shape[p.dim] % mesh.size(i) == 0 else Replicate()
                    for i, p in enumerate(lead.placements)]
            if t.dim() != lead.dim() or back == rep:
                return out
            return out.redistribute(mesh, back)

        if isinstance(out, collections.abc.Iterator):
            return iter(tuple(wrap(t) for t in out))
        return tree_map(wrap, out)


@dataclasses.dataclass
class BuiltStep:
    """Everything needed to run and count one cell: ``fn(*abstract_args)``
    is the step; ``abstract_args`` are meta tensors (DTensors on a mesh),
    the first of them the model's own parameters by name;
    ``in_placements`` / ``out_placements`` their DTensor placements (None
    without a mesh); ``donate`` the arguments the step updates in place
    (the reference donates them: parameters and optimizer state, or the
    cache)."""

    fn: Callable
    abstract_args: Tuple[Any, ...]
    arg_names: Tuple[str, ...]
    in_placements: Any
    out_placements: Any
    static_desc: str
    donate: Tuple[int, ...] = ()
    model: Any = None
    mesh: Any = None
    refused: Dict[str, int] = dataclasses.field(default_factory=dict)
    refusal_errors: Dict[str, str] = dataclasses.field(default_factory=dict)

    def run(self):
        """``fn(*abstract_args)``; on a mesh, the plain tensors the step
        makes (positions, masks) count as replicated
        (``implicit_replication``), and a call DTensor refuses runs
        replicated (``ReplicateOnRefusal``; its counts in ``self.refused``
        and ``self.refusal_errors`` after the run)."""
        from torch.distributed.tensor.experimental import implicit_replication

        if self.mesh is None:
            return self.fn(*self.abstract_args)
        fallback = ReplicateOnRefusal()
        with implicit_replication(), fallback:
            out = self.fn(*self.abstract_args)
        self.refused, self.refusal_errors = fallback.refused, fallback.errors
        return out

    def arg_bytes(self) -> Dict[str, int]:
        """One device's bytes of each argument, by name."""
        return {n: local_nbytes(a)
                for n, a in zip(self.arg_names, self.abstract_args)}


def _mesh_model(cfg, mesh, rules, *, impl: str, dtype: torch.dtype,
                remat: bool = False):
    """``cfg``'s model on ``meta`` in ``dtype``, its parameters placed by
    ``rules`` on ``mesh`` (as they are without one)."""
    from repro_torch.distributed.sharding import distribute_module_params
    from repro_torch.models.registry import build_model

    model = build_model(cfg, impl=impl, remat=remat, device="meta",
                        dtype=dtype)
    if mesh is not None:
        distribute_module_params(model, mesh, rules)
    return model


def _place(tree, logical, mesh, rules):
    """``tree``'s meta tensors as DTensors on ``mesh`` under ``rules`` (as
    they are without a mesh)."""
    if mesh is None:
        return tree
    from repro_torch.distributed.sharding import distribute_params

    return distribute_params(tree, logical, mesh, rules)


def _place_batch(t: torch.Tensor, mesh):
    if mesh is None:
        return t
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, batch_placements(mesh, t.shape[0]))


def _params(model) -> Dict[str, torch.Tensor]:
    return dict(model.named_parameters())


def build_mesh_train_step(
    cfg,
    mesh,
    shape,
    *,
    microbatches: int = 16,
    rules_name: str = "tp",
    param_dtype: torch.dtype = torch.bfloat16,   # bf16 params, fp32 m/v
    compress_grads: bool = False,
    impl: str = "blockwise",
    remat: bool = True,
    grad_accum: str = "f32_sharded",
    opt_cfg: Optional[AdamWConfig] = None,
) -> BuiltStep:
    """The reference's mesh train step: loss, gradients over
    ``microbatches``, AdamW with its moments ZeRO-1 sharded over "data"
    (``zero1_logical_tree``).  The gradient accumulator takes each
    parameter's placements."""
    from repro_torch.distributed.sharding import make_rules, model_logical
    from repro_torch.launch.mesh import data_axis_size
    from repro_torch.training.data import abstract_batch
    from repro_torch.training.optimizer import zero1_logical

    if impl == "kernel":
        raise ValueError("the train step runs impl='blockwise': the kernels "
                         "have no backward")
    rules = make_rules(rules_name)
    model = _mesh_model(cfg, mesh, rules, impl=impl, dtype=param_dtype,
                        remat=remat)
    model.requires_grad_(True)
    params = _params(model)
    logical = model_logical(model)
    data_size = data_axis_size(mesh) if mesh is not None else 1
    z_logical = {k: zero1_logical(logical[k], p.shape, data_size)
                 for k, p in params.items()}
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device="meta")
             for k, p in params.items()}
    opt_state = {
        "m": _place(zeros, z_logical, mesh, rules),
        "v": _place({k: torch.zeros_like(t) for k, t in zeros.items()},
                    z_logical, mesh, rules),
        "step": _place(torch.zeros((), dtype=torch.int32, device="meta"),
                       (), mesh, rules),
    }
    if compress_grads:
        opt_state["ef_error"] = _place(
            {k: torch.zeros_like(t) for k, t in zeros.items()}, z_logical,
            mesh, rules)
    B, S = shape.global_batch, shape.seq_len
    batch = {k: _place_batch(t, mesh)
             for k, t in abstract_batch(cfg, B, S, dtype=param_dtype).items()}
    step = make_train_step(model, opt_cfg or AdamWConfig(),
                           microbatches=microbatches,
                           compress_grads=compress_grads,
                           grad_accum=grad_accum)

    def fn(params, opt_state, batch):
        # the model holds ``params``: the step updates them in place
        return params, opt_state, step(opt_state, batch)

    metrics = {"loss": None, "grad_norm": None, "step": None}
    return BuiltStep(
        fn=fn,
        abstract_args=(params, opt_state, batch),
        arg_names=("params", "opt_state", "batch"),
        in_placements=placements_of((params, opt_state, batch))
        if mesh is not None else None,
        out_placements=(placements_of(params), placements_of(opt_state),
                        metrics) if mesh is not None else None,
        static_desc=(f"train {cfg.name} seq={S} gb={B} mb={microbatches}"),
        donate=(0, 1),        # params + opt_state update in place
        model=model, mesh=mesh,
    )


def _cache_len(cfg, shape) -> int:
    return shape.seq_len + (cfg.frontend_seq if (cfg.frontend and not
                                                 cfg.is_encdec) else 0)


def _serving_parts(cfg, mesh, shape, rules_name, cache_rules_name, dtype,
                   cache_dtype, impl):
    """The model, its parameters and its cache, placed."""
    from repro_torch.distributed.sharding import make_rules

    rules = make_rules(rules_name)
    model = _mesh_model(cfg, mesh, rules, impl=impl, dtype=dtype)
    cache = model.init_cache(shape.global_batch, _cache_len(cfg, shape),
                             cache_dtype)
    cache = _place(cache, cache_logical(cache), mesh,
                   make_rules(cache_rules_name))
    return model, _params(model), cache


def build_mesh_prefill_step(
    cfg,
    mesh,
    shape,
    *,
    rules_name: str = "tp",
    cache_rules_name: str = "decode_cp",
    dtype: torch.dtype = torch.bfloat16,
    impl: str = "blockwise",
) -> BuiltStep:
    """The prompt of ``shape.seq_len`` tokens (and an encoder-decoder's
    frames or a prefix-LM's patches) into a cache in the decode layout;
    returns the last position's logits and the cache."""
    model, params, cache = _serving_parts(cfg, mesh, shape, rules_name,
                                          cache_rules_name, dtype, dtype, impl)
    B, S = shape.global_batch, shape.seq_len
    tokens = _place_batch(
        torch.zeros((B, S), dtype=torch.long, device="meta"), mesh)
    extra: Tuple[Any, ...] = ()
    if cfg.frontend:
        extra = (_place_batch(torch.zeros(
            (B, cfg.frontend_seq, cfg.d_model), dtype=dtype, device="meta"),
            mesh),)

    if cfg.is_encdec:
        def fn(params, tokens, frames, cache):
            return model.prefill(frames, tokens, cache, dtype=dtype)
        names = ("params", "tokens", "frames", "cache")
    elif cfg.frontend:
        def fn(params, tokens, patches, cache):
            return model.prefill(tokens, cache, prefix_embed=patches,
                                 dtype=dtype)
        names = ("params", "tokens", "patches", "cache")
    else:
        def fn(params, tokens, cache):
            return model.prefill(tokens, cache, dtype=dtype)
        names = ("params", "tokens", "cache")

    args = (params, tokens) + extra + (cache,)
    return BuiltStep(
        fn=fn,
        abstract_args=args,
        arg_names=names,
        in_placements=placements_of(args) if mesh is not None else None,
        out_placements=(batch_placements(mesh, B), placements_of(cache))
        if mesh is not None else None,
        static_desc=f"prefill {cfg.name} seq={S} gb={B}",
        donate=(len(args) - 1,),    # the cache
        model=model, mesh=mesh,
    )


def build_mesh_serve_step(
    cfg,
    mesh,
    shape,
    *,
    rules_name: str = "tp",
    cache_rules_name: str = "decode_cp",
    dtype: torch.dtype = torch.bfloat16,
    kv_dtype: Optional[torch.dtype] = None,
    impl: str = "blockwise",
) -> BuiltStep:
    """One-token decode step against a cache of ``shape.seq_len`` tokens,
    then the greedy next token (serving returns tokens, not logits)."""
    from repro_torch.distributed.sharding import constrain

    model, params, cache = _serving_parts(cfg, mesh, shape, rules_name,
                                          cache_rules_name, dtype,
                                          kv_dtype or dtype, impl)
    B, S = shape.global_batch, shape.seq_len
    tokens = _place_batch(
        torch.zeros((B, 1), dtype=torch.long, device="meta"), mesh)

    def fn(params, tokens, cache):
        logits, cache = model.decode_step(tokens, cache, dtype=dtype)
        # on a mesh the logits are sharded over the vocabulary: gathered
        # whole first, the greedy pick reads every entry of a row
        logits = constrain(logits, "batch", None, None)
        return logits.argmax(-1), cache

    args = (params, tokens, cache)
    return BuiltStep(
        fn=fn,
        abstract_args=args,
        arg_names=("params", "tokens", "cache"),
        in_placements=placements_of(args) if mesh is not None else None,
        out_placements=(batch_placements(mesh, B), placements_of(cache))
        if mesh is not None else None,
        static_desc=f"decode {cfg.name} ctx={S} gb={B}",
        donate=(2,),          # the cache
        model=model, mesh=mesh,
    )


def build_step(arch: str, shape_name: str, mesh, **kwargs) -> BuiltStep:
    """Dispatch on the shape's kind (``mesh=None``: one device)."""
    from repro_torch.configs import SHAPES, get_config

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return build_mesh_train_step(cfg, mesh, shape, **kwargs)
    if shape.kind == "prefill":
        return build_mesh_prefill_step(cfg, mesh, shape, **kwargs)
    if shape.kind == "decode":
        return build_mesh_serve_step(cfg, mesh, shape, **kwargs)
    raise ValueError(f"unknown shape kind {shape.kind}")


def input_specs(arch: str, shape_name: str, mesh, **kwargs):
    """Meta-tensor stand-ins for every input of a cell (the dry-run
    contract: the right shapes and dtypes, placed, nothing allocated)."""
    return build_step(arch, shape_name, mesh, **kwargs).abstract_args


__all__ = ["BuiltStep", "PrefillStep", "ServeStep", "TrainStep",
           "build_mesh_prefill_step", "build_mesh_serve_step",
           "build_mesh_train_step", "build_prefill_step", "build_serve_step",
           "build_step", "build_train_step", "input_specs"]
