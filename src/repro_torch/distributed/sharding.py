"""Sharding: logical axes -> mesh axes, with divisibility-aware fallback
(counterpart of ``repro.distributed.sharding``).

The model zoo annotates every parameter and activation with *logical* axis
names (``repro_torch.models.base``).  This module maps them onto a
``torch.distributed.DeviceMesh`` with axes (``pod``, ``data``, ``model``)
through the reference's named rule tables, copied entry for entry:

* ``tp``        Megatron-style tensor parallelism inside a replica:
                heads / mlp / experts / vocab over ``model``; batch over
                (``pod``, ``data``); ZeRO-1 shards optimizer state over
                ``data``.
* ``tp_sp``     tp + sequence-parallel residual stream (activations' seq
                axis over ``model`` between blocks).
* ``decode_cp`` decode-time context parallelism: the KV-cache *sequence*
                axis is sharded over ``model`` (works for every kv_heads
                count, incl. paligemma's kv=1) and batch over ``data``.

Where the reference builds a ``PartitionSpec`` (one entry per tensor
dimension, naming mesh axes), the port builds DTensor placements (one
entry per *mesh* dimension: ``Shard(tensor_dim)`` or ``Replicate()``).  A
tuple axis such as ``("pod", "data")`` on ``batch`` shards that one tensor
dimension over both mesh dimensions, pod-major, as the reference's spec
does.  ``pspec_of`` writes placements back in the reference's
``PartitionSpec`` form (a tuple, trailing ``None``s trimmed) for tests.

A rule is dropped per tensor dimension when the dimension does not divide
the mesh axis (paligemma's one KV head on a 4-way ``model`` axis falls back
to replicated weights while its attention still context-parallelizes).
The fallback is counted on every occurrence as
``sharding_replication_fallback`` on ``repro_torch.obs``'s registry and
logged once per (axis, mesh axis, dim, size), as in the reference.

The functions read only ``mesh.mesh_dim_names`` and ``mesh.shape``, so a
placement can be worked out for any mesh shape without a process group;
``distribute_params`` and ``constrain`` need a real ``DeviceMesh``.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.distributed.tensor import (
    DTensor,
    Placement,
    Replicate,
    Shard,
    distribute_tensor,
)

from repro_torch.obs.registry import get_registry

logger = logging.getLogger(__name__)

# rule: logical axis name -> mesh axis name (or tuple of mesh axes) or None
Rules = Mapping[str, Any]

_TP_RULES: Dict[str, Any] = {
    # weights
    "embed": None,               # residual dim replicated (activations SP'd)
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "layers": None,
    "experts": "model",          # EP: experts over the TP axis
    "expert_mlp": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "conv": None,
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,
    "act_embed": None,
    # optimizer state (ZeRO-1): leading param axis over data
    # (training/optimizer.py zero1_logical)
    "zero": "data",
}

_TP_SP_RULES = dict(_TP_RULES)
_TP_SP_RULES.update({
    "seq": "model",              # sequence-parallel residual stream
})

_DECODE_CP_RULES = dict(_TP_RULES)
_DECODE_CP_RULES.update({
    "kv_seq": "model",           # context-parallel KV cache
    "kv_heads": None,            # seq takes the axis; heads replicated
    "heads": None,               # (mamba2 hybrid decode state heads too)
    "batch": ("pod", "data"),
})

RULESETS: Dict[str, Dict[str, Any]] = {
    "tp": _TP_RULES,
    "tp_sp": _TP_SP_RULES,
    "decode_cp": _DECODE_CP_RULES,
}


def make_rules(name: str, overrides: Optional[Rules] = None) -> Dict[str, Any]:
    rules = dict(RULESETS[name])
    if overrides:
        rules.update(overrides)
    return rules


def axis_sizes(mesh: Any) -> Dict[str, int]:
    """{mesh axis name: size} of a ``DeviceMesh`` (or anything with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _present(mesh: Any, axis: Any) -> Any:
    """Drop mesh axes the mesh doesn't have (e.g. 'pod' on single-pod)."""
    if axis is None:
        return None
    names = tuple(mesh.mesh_dim_names)
    if isinstance(axis, (tuple, list)):
        kept = tuple(a for a in axis if a in names)
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]
    return axis if axis in names else None


def _mesh_axis_size(mesh: Any, axis: Any) -> int:
    if axis is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


_warned: set = set()


def logical_to_axes(
    logical: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh: Any,
    rules: Rules,
) -> List[Any]:
    """The mesh axis (a name, a tuple of names or None) of each tensor
    dimension: the rule's axes present on the mesh, None where the
    dimension does not divide them (counted and logged)."""
    out: List[Any] = []
    for dim, name in zip(shape, logical):
        axis = rules.get(name) if name is not None else None
        axis = _present(mesh, axis)
        if axis is not None:
            n = _mesh_axis_size(mesh, axis)
            if dim % n != 0:
                key = (name, axis, dim, n)
                # counted on every occurrence though logged once, so a
                # caller can hold a mesh to what it expected to shard
                get_registry().inc(
                    "sharding_replication_fallback",
                    axis=str(name),
                    mesh_axis=str(key[1]),
                    dim=dim,
                    size=n,
                )
                if key not in _warned:
                    _warned.add(key)
                    logger.info(
                        "sharding fallback: logical axis %r (dim %d) does "
                        "not divide mesh axis %r (size %d); replicating",
                        name, dim, axis, n,
                    )
                axis = None
        out.append(axis)
    return out


def logical_to_placements(
    logical: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh: Any,
    rules: Rules,
) -> Tuple[Placement, ...]:
    """DTensor placements of one tensor, one per mesh dimension:
    ``Shard(d)`` where tensor dimension d maps onto that mesh axis,
    ``Replicate()`` elsewhere."""
    names = tuple(mesh.mesh_dim_names)
    placements: List[Placement] = [Replicate() for _ in names]
    for d, axis in enumerate(logical_to_axes(logical, shape, mesh, rules)):
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            if a is None:
                continue
            i = names.index(a)
            if isinstance(placements[i], Shard):
                raise ValueError(f"mesh axis {a!r} shards tensor dims "
                                 f"{placements[i].dim} and {d} of {logical}")
            placements[i] = Shard(d)
    return tuple(placements)


def pspec_of(placements: Sequence[Placement], ndim: int,
             mesh: Any) -> Tuple[Any, ...]:
    """Placements written in the reference's ``PartitionSpec`` form: per
    tensor dimension the mesh axis (a tuple where several shard it, in
    mesh order) or None, trailing Nones trimmed."""
    per_dim: List[List[str]] = [[] for _ in range(ndim)]
    for name, p in zip(mesh.mesh_dim_names, placements):
        if isinstance(p, Shard):
            per_dim[p.dim].append(name)
    spec: List[Any] = [
        None if not a else (a[0] if len(a) == 1 else tuple(a))
        for a in per_dim
    ]
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _is_logical(x: Any) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def tree_map2(fn, logical_tree: Any, tree: Any) -> Any:
    """``fn(logical, leaf)`` over two nested dicts of the same keys, whose
    logical leaves are tuples of axis names."""
    if _is_logical(logical_tree):
        return fn(logical_tree, tree)
    return {k: tree_map2(fn, logical_tree[k], tree[k]) for k in logical_tree}


def param_placements(logical_tree: Any, tree: Any, mesh: Any,
                     rules: Rules) -> Any:
    """Placements for every leaf of ``tree`` (tensors or anything with a
    ``shape``), from the matching leaf of ``logical_tree``."""
    return tree_map2(
        lambda logical, t: logical_to_placements(logical, t.shape, mesh, rules),
        logical_tree, tree)


def distribute_params(tree: Any, logical_tree: Any, mesh: Any,
                      rules: Rules) -> Any:
    """Each tensor of ``tree`` as a DTensor on ``mesh`` under the rules'
    placements (``distribute_tensor``: every rank keeps its own shard)."""
    return tree_map2(
        lambda logical, t: distribute_tensor(
            t, mesh, logical_to_placements(logical, t.shape, mesh, rules)),
        logical_tree, tree)


def model_logical(model) -> Dict[str, Tuple[Optional[str], ...]]:
    """The logical axes of each of a port model's parameters, by name.
    The model holds per-layer tensors (``layers.3.attn.wq``); its
    blueprint (the reference's) stacks them (``decoder.attn.wq`` with a
    leading "layers" axis, zamba2's ``blocks`` twice): each index in the
    name drops one leading stacked axis."""
    bp = model.blueprint()
    out: Dict[str, Tuple[Optional[str], ...]] = {}
    for name, p in model.named_parameters():
        node, drop = bp, 0
        for part in name.split("."):
            if part.isdigit():
                drop += 1
                continue
            if part not in node:
                node = node["decoder"]      # layers / prelude / blocks / shared_attn
                if part == "layers":
                    continue
            node = node[part]
        logical = tuple(node.logical[drop:])
        if len(logical) != p.dim():
            raise ValueError(f"{name}: logical {logical} for shape "
                             f"{tuple(p.shape)}")
        out[name] = logical
    return out


def distribute_module_params(model, mesh: Any, rules: Rules) -> None:
    """Replace each parameter of ``model`` by a DTensor parameter on
    ``mesh`` under the rules' placements (``distribute_tensor``), keeping
    its ``requires_grad``."""
    for name, logical in model_logical(model).items():
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner)
        p = getattr(module, leaf)
        placed = distribute_tensor(
            p.detach(), mesh, logical_to_placements(logical, p.shape, mesh,
                                                    rules))
        setattr(module, leaf, nn.Parameter(placed,
                                           requires_grad=p.requires_grad))


def constrain(x: torch.Tensor, *axes: Optional[str],
              rules: Optional[Rules] = None) -> torch.Tensor:
    """Redistribute a DTensor to the placements of its logical activation
    axes (``tp`` rules unless given); a plain tensor is returned as it is,
    as the reference's ``constrain`` is a no-op outside a mesh."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    placements = logical_to_placements(list(axes), x.shape, mesh,
                                       rules or RULESETS["tp"])
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


__all__ = [
    "RULESETS", "Rules", "axis_sizes", "constrain",
    "distribute_module_params", "distribute_params", "logical_to_axes",
    "logical_to_placements", "make_rules", "model_logical",
    "param_placements", "pspec_of", "tree_map2",
]
