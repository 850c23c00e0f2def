"""Mesh definitions (counterpart of ``repro.launch.mesh``).

The reference's production meshes are TPU pods: (16, 16) chips over
("data", "model"), two pods (2, 16, 16) over ("pod", "data", "model").  The
port's are H100 nodes: one node of 8 GPUs joined all to all by NVLink as
("data", "model") = (2, 4), two nodes as ("pod", "data", "model") = (2, 2,
4).  With every axis above 1, each rule of ``distributed.sharding`` acts as
on the pods: batch and ZeRO-1 over ``data``, tensor parallelism over
``model``, the ``pod`` axis, and the divisibility fallback (paligemma's one
KV head on the 4-way ``model`` axis).

Every function builds a ``DeviceMesh`` over ranks of the default process
group, which the caller initialises (NCCL on the card, gloo or the
``"fake"`` backend on the CPU); nothing here creates a group.  The mesh's
device type is ``device_type``, or, when it is not given, ``"cuda"`` under
an NCCL group and ``"cpu"`` under any other.  A mesh holds the first
``prod(shape)`` ranks, row-major.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

NODE_SHAPE = (2, 4)
NODE_AXES = ("data", "model")
TWO_NODE_SHAPE = (2, 2, 4)
TWO_NODE_AXES = ("pod", "data", "model")


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              device_type: Optional[str] = None) -> DeviceMesh:
    """Any mesh (elastic restarts, tests) over the first ``prod(shape)``
    ranks of the default process group."""
    if not dist.is_initialized():
        raise RuntimeError("initialise the default process group before "
                           "building a mesh (torch.distributed."
                           "init_process_group)")
    n = math.prod(shape)
    if n > dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process "
                         f"group has {dist.get_world_size()}")
    return DeviceMesh(_device_type(device_type),
                      torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """One 8×H100 node, ("data", "model") = (2, 4); with ``multi_pod`` two
    nodes, ("pod", "data", "model") = (2, 2, 4)."""
    if multi_pod:
        return make_mesh(TWO_NODE_SHAPE, TWO_NODE_AXES, device_type=device_type)
    return make_mesh(NODE_SHAPE, NODE_AXES, device_type=device_type)


def make_host_mesh(*, device_type: Optional[str] = None) -> DeviceMesh:
    """1x1 ("data", "model") mesh on this rank's device (smoke tests,
    examples)."""
    return DeviceMesh(_device_type(device_type),
                      torch.tensor([[dist.get_rank()]]),
                      mesh_dim_names=NODE_AXES)


def mesh_chip_count(mesh) -> int:
    return math.prod(tuple(mesh.shape))


def data_axis_size(mesh) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    n = sizes.get("data", 1)
    if "pod" in sizes:
        n *= sizes["pod"]
    return n


__all__ = ["data_axis_size", "make_host_mesh", "make_mesh",
           "make_production_mesh", "mesh_chip_count"]
