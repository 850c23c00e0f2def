"""Per-device operation, byte and collective counts of a step run on
``meta`` tensors (counterpart of ``repro.launch.hlo_count``).

The reference lowers a step to XLA and walks the optimized HLO text.  A
PyTorch step has no HLO: it runs eagerly, op by op.  So the port runs the
step itself on ``meta`` tensors (shapes, no data) under a
``TorchDispatchMode`` and counts each op as it is dispatched:

* **per device.**  On a mesh the step's tensors are DTensors whose local
  shards are ``meta`` tensors.  The mode returns ``NotImplemented`` for an
  op on DTensors, so DTensor runs it (picks the shardings, redistributes)
  and dispatches the local op on the shards, which the mode then sees and
  counts: one device's work, as the reference's counts describe the
  per-device module.  The meta runs that DTensor's sharding propagation
  makes on ``FakeTensor``s of the global shapes are not counted.
* **FLOPs** by ``torch.utils.flop_counter``'s formulas (matmuls,
  convolutions, attention), plus each hand-written kernel's own count,
  which its wrapper's ``meta`` route adds (``kernels.cost``).
* **Bytes**: every op reads its inputs and writes its outputs once, which
  is what eager PyTorch moves on the card: there is no fusion.  Views move
  nothing; ``empty`` writes nothing.  An indexed op moves only the rows it
  touches: a gather (``index_select``, advanced indexing, ``gather``,
  ``embedding``) reads its indices and as many bytes of its source as it
  writes (at most the whole source); an indexed write in place
  (``index_copy_``, ``index_put_``, ``scatter_`` and their ``add`` forms)
  reads its indices and values and writes the values' bytes into its
  target (the ``add`` forms also read them there; at most the whole
  target), never the whole target: a decode step's one-slot cache write
  moves one slot, as on the card.  This replaces the reference's TPU
  fusion model (``hlo_count.py``, which counts only the ops XLA:TPU would
  not fuse).
* **Collectives** per kind (``all-reduce``, ``all-gather``,
  ``reduce-scatter``, ``all-to-all``, ``broadcast``), from the functional
  collectives DTensor issues: raw bytes are each result's bytes (the
  reference reads the result shape of each HLO collective), link bytes add
  the ring factor (all-reduce 2x, the rest 1x; ``analysis.py:38-44``).
  DTensor on a ``cpu`` mesh (the dry run's) redistributes a shard from one
  tensor dimension to another by all-gather and chunk, where on ``cuda``
  it issues an all-to-all.
* **Peak live temporaries**: every storage an op creates is live from then
  until the last tensor that holds it dies; the largest sum over the run
  (inputs excluded).

Loops run as Python loops, so nothing is scaled by a trip count.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, List

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost

COLL_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0, "broadcast": 1.0}

# functional-collective op names -> the reference's kinds
_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}
_NOT_COUNTED = {"wait_tensor", "_wrap_tensor_autograd"}
_NO_WRITE = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided"}
# indexed ops, by the rows they touch (their first argument is the source
# or the target)
_GATHERS = {"index_select", "index", "gather", "embedding"}
_SCATTERS = {"index_copy_": 1, "index_put_": 1, "scatter_": 1,
             "index_add_": 2, "scatter_add_": 2}   # target passes: write, read


@dataclasses.dataclass
class Counts:
    """One device's counts (``hlo_count.Counts``'s fields, and the kernels'
    share and the peak of live temporaries)."""

    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0       # ring-factored link bytes
    coll_raw: float = 0.0         # raw result bytes through collectives
    coll_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernel_flops: float = 0.0     # of flops: the hand-written kernels'
    kernel_bytes: float = 0.0     # of bytes: the hand-written kernels'
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    ops: int = 0
    peak_temp_bytes: int = 0
    out_bytes: int = 0            # results that are not updated arguments


def _storage_key(t: torch.Tensor):
    return t.untyped_storage()._cdata


class OpCounter(TorchDispatchMode):
    """Count one device's work while active (``with OpCounter() as c:``);
    the result is ``c.counts``.  Inputs made before entering are not
    temporaries."""

    def __init__(self) -> None:
        super().__init__()
        self.counts = Counts()
        self._live: Dict[Any, List[int]] = {}   # key -> [nbytes, holders]
        self._live_bytes = 0

    def __enter__(self):
        cost._active.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        cost._active.remove(self)
        return super().__exit__(*exc)

    # the kernels' meta routes report here (``kernels.cost.record``)
    def add_kernel(self, kernel: str, work: cost.Work) -> None:
        c = self.counts
        c.flops += work.flops
        c.bytes += work.bytes
        c.kernel_flops += work.flops
        c.kernel_bytes += work.bytes
        c.kernel_calls[kernel] = c.kernel_calls.get(kernel, 0) + 1

    def _hold(self, t: torch.Tensor) -> None:
        """``t`` holds a tracked storage until it dies."""
        key = _storage_key(t)
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self._live_bytes -= entry[0]
            del self._live[key]

    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key not in self._live:
            nbytes = t.untyped_storage().nbytes()
            self._live[key] = [nbytes, 0]
            self._live_bytes += nbytes
            self.counts.peak_temp_bytes = max(self.counts.peak_temp_bytes,
                                              self._live_bytes)
        self._hold(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented     # DTensor runs it; its local ops come back
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out                # sharding propagation, not the device's
        name = func._overloadpacket.__name__
        ns = func.namespace
        c = self.counts
        if name in _NOT_COUNTED:
            return out
        c.ops += 1
        in_keys = {_storage_key(t) for t in ins}
        if ns in ("_c10d_functional", "c10d_functional") and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            raw = sum(t.nbytes for t in outs)
            c.coll_counts[kind] = c.coll_counts.get(kind, 0) + 1
            c.coll_raw += raw
            c.coll_bytes += COLL_FACTOR[kind] * raw
        else:
            packet = func._overloadpacket
            if packet in flop_registry:
                c.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            if func.is_view:
                pass
            elif name in _GATHERS:
                written = sum(t.nbytes for t in outs)
                c.bytes += (written + min(written, ins[0].nbytes)
                            + sum(t.nbytes for t in ins[1:]))
            elif name in _SCATTERS:
                target, rest = ins[0], ins[1:]
                values = sum(t.nbytes for t in rest if t.dtype == target.dtype)
                c.bytes += (sum(t.nbytes for t in rest)
                            + _SCATTERS[name] * min(values, target.nbytes))
            else:
                if name not in _NO_WRITE:
                    c.bytes += sum(t.nbytes for t in outs)
                c.bytes += sum(t.nbytes for t in ins)
        for t in outs:
            if func.is_view or _storage_key(t) in in_keys:
                self._hold(t)         # a view or an in-place result
            else:
                self._track(t)
        return out


def count_step(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under an ``OpCounter``; returns
    (its result, the counts)."""
    with OpCounter() as counter:
        result = fn(*args, **kwargs)
    return result, counter.counts


__all__ = ["COLL_FACTOR", "Counts", "OpCounter", "count_step"]
