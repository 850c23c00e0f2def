"""Elastic re-mesh: continue after losing (or gaining) capacity
(counterpart of ``repro.distributed.elastic``).

The SpotHedge failure unit is a whole replica, but a training job also
wants to survive losing part of its data-parallel axis: checkpoint, build a
smaller mesh, re-shard, resume.  ``plan_remesh`` computes the new mesh
shape from the surviving chip count; ``build_mesh`` makes it; ``reshard``
moves a tree of DTensors onto the new mesh.

Policy, as the reference's: shrink the ``data`` axis first (the gradient
math does not depend on the data-parallel size, up to the batch), never
the ``model`` axis (a tensor-parallel degree change moves every chip's
layout).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    old_shape: Tuple[int, ...]
    new_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    dropped_chips: int

    @property
    def new_chip_count(self) -> int:
        n = 1
        for s in self.new_shape:
            n *= s
        return n


def plan_remesh(
    mesh: Any,
    surviving_chips: int,
    *,
    shrink_axis: str = "data",
) -> RemeshPlan:
    """Largest mesh of the same axis structure that fits the survivors,
    shrinking only ``shrink_axis`` (power-of-two steps).  ``mesh`` is a
    ``DeviceMesh`` or anything with ``mesh_dim_names`` and ``shape``."""
    names = tuple(mesh.mesh_dim_names)
    shape = tuple(int(s) for s in mesh.shape)
    if shrink_axis not in names:
        raise ValueError(f"mesh has no axis {shrink_axis!r}")
    idx = names.index(shrink_axis)
    other = 1
    for i, s in enumerate(shape):
        if i != idx:
            other *= s
    new_dim = shape[idx]
    while new_dim > 1 and other * new_dim > surviving_chips:
        new_dim //= 2
    if other * new_dim > surviving_chips:
        raise ValueError(
            f"cannot fit mesh {shape} into {surviving_chips} chips by "
            f"shrinking {shrink_axis!r} alone"
        )
    new_shape = tuple(
        new_dim if i == idx else s for i, s in enumerate(shape)
    )
    return RemeshPlan(
        old_shape=shape,
        new_shape=new_shape,
        axis_names=names,
        dropped_chips=math.prod(shape) - other * new_dim,
    )


def build_mesh(plan: RemeshPlan, device_type: Optional[str] = None):
    """The plan's new mesh over the first ``plan.new_chip_count`` ranks of
    the default process group (``launch.mesh.make_mesh``)."""
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(plan.new_shape, plan.axis_names, device_type=device_type)


def reshard(tree: Any, logical_tree: Any, new_mesh: Any, rules: Any) -> Any:
    """Every DTensor of ``tree`` on ``new_mesh`` under the rules'
    placements.  DTensor does not redistribute across meshes, so each is
    gathered whole (``full_tensor``) and distributed anew; a plain tensor
    is distributed as it is."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.distributed.sharding import logical_to_placements, tree_map2

    def move(logical, t):
        full = t.full_tensor() if isinstance(t, DTensor) else t
        return distribute_tensor(
            full, new_mesh,
            logical_to_placements(logical, full.shape, new_mesh, rules))

    return tree_map2(move, logical_tree, tree)


__all__ = ["RemeshPlan", "build_mesh", "plan_remesh", "reshard"]
