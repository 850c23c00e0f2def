"""The migration cost model: the port's own copy of
``repro.migration.cost``.

* KV transfer: a migrated sequence ships ``resident_tokens x
  kv_bytes_per_token`` over the link between the two instances, halved
  under int8 KV compression (bf16 to int8 with a per-tensor scale, the
  reference's ``distributed/compression.py``; the serving engines use only
  the byte factor), in ``link_latency + bytes / bandwidth`` seconds.
* Elastic re-shard: instead of dying when chips are lost, shrink one mesh
  axis in power-of-two steps and price the state that moves.  A pricing
  API for planners and reports; the serving engines' replicas are one
  instance each and use the KV transfer only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

__all__ = [
    "INT8_KV_FACTOR", "RemeshPlan", "ReshardCost", "compression_factor",
    "kv_transfer_bytes", "kv_transfer_s", "plan_reshard",
]

# bf16 KV quantised to int8 with a per-tensor scale: 2 bytes -> 1 byte
INT8_KV_FACTOR = 0.5


def compression_factor(compression: str) -> float:
    """The bytes-on-the-wire multiplier of a KV compression mode."""
    if compression == "int8":
        return INT8_KV_FACTOR
    if compression == "none":
        return 1.0
    raise ValueError(f"unknown KV compression mode {compression!r}")


def kv_transfer_bytes(resident_tokens: int, kv_bytes_per_token: float,
                      compression: str = "none") -> float:
    """The bytes one sequence's resident KV takes over the wire."""
    return (float(resident_tokens) * float(kv_bytes_per_token)
            * compression_factor(compression))


def kv_transfer_s(nbytes: float, bandwidth_bytes_per_s: float,
                  link_latency_s: float = 0.0) -> float:
    """Seconds to move ``nbytes`` over one link."""
    if nbytes <= 0.0:
        return float(link_latency_s)
    if bandwidth_bytes_per_s <= 0.0:
        return float("inf")
    return float(link_latency_s) + float(nbytes) / float(
        bandwidth_bytes_per_s)


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    """A mesh shrink: the fields of the reference's
    ``distributed.elastic.RemeshPlan``, which the port does not have yet."""

    old_shape: Tuple[int, ...]
    new_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    dropped_chips: int


@dataclasses.dataclass(frozen=True)
class ReshardCost:
    """A priced plan for continuing on fewer chips instead of dying."""

    old_shape: Tuple[int, ...]
    new_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    dropped_chips: int
    moved_bytes: float              # state that crosses the network
    transfer_s: float               # moved_bytes over the link
    relower_s: float                # recompiling the step

    @property
    def new_chip_count(self) -> int:
        n = 1
        for s in self.new_shape:
            n *= s
        return n

    @property
    def total_s(self) -> float:
        return self.transfer_s + self.relower_s

    def to_remesh_plan(self) -> RemeshPlan:
        return RemeshPlan(old_shape=self.old_shape, new_shape=self.new_shape,
                          axis_names=self.axis_names,
                          dropped_chips=self.dropped_chips)


def plan_reshard(
    mesh_shape: Sequence[int],
    axis_names: Sequence[str],
    surviving_chips: int,
    *,
    kv_resident_bytes: float = 0.0,
    weight_bytes: float = 0.0,
    bandwidth_bytes_per_s: float,
    link_latency_s: float = 0.0,
    relower_s: float = 2.0,
    shrink_axis: str = "data",
) -> Optional[ReshardCost]:
    """Price a shrink of ``shrink_axis`` (power-of-two steps) onto
    ``surviving_chips``; ``None`` when no shrink fits.  The dropped chips'
    share of the resident KV always moves; the weights move only when a
    model axis shrinks."""
    names = tuple(axis_names)
    shape = tuple(int(s) for s in mesh_shape)
    if len(names) != len(shape):
        raise ValueError(
            f"mesh_shape {shape} and axis_names {names} length mismatch")
    if shrink_axis not in names:
        raise ValueError(f"mesh has no axis {shrink_axis!r}")
    idx = names.index(shrink_axis)
    other = 1
    for i, s in enumerate(shape):
        if i != idx:
            other *= s
    old_chips = other * shape[idx]
    new_dim = shape[idx]
    while new_dim > 1 and other * new_dim > surviving_chips:
        new_dim //= 2
    if other * new_dim > surviving_chips:
        return None
    new_shape = tuple(new_dim if i == idx else s for i, s in enumerate(shape))
    dropped = old_chips - other * new_dim
    frac = dropped / old_chips
    moved = kv_resident_bytes * frac
    if shrink_axis != "data":
        moved += weight_bytes * frac
    transfer = kv_transfer_s(moved, bandwidth_bytes_per_s, link_latency_s)
    return ReshardCost(old_shape=shape, new_shape=new_shape, axis_names=names,
                       dropped_chips=dropped, moved_bytes=moved,
                       transfer_s=transfer, relower_s=relower_s)
