"""Parameter blueprints (counterpart of ``repro.models.base``).

A model definition builds a *blueprint*: a nested dict of :class:`ParamSpec`
leaves.  From it the port derives

* ``init_params(bp, generator)``  materialized tensors, drawn from an
  explicit ``torch.Generator``,
* ``abstract_params(bp, dtype)``  ``meta`` tensors of the same shapes: the
  dry run (``repro_torch.launch.dryrun``) sizes full-width models without
  allocating anything,
* ``logical_axes(bp)``            logical sharding axes per leaf, read by
  ``repro_torch.distributed.sharding``'s rule tables,
* ``param_count(bp)``             the exact parameter count,
* ``ParamTree``                   an ``nn.Module`` holding the tensors as
  parameters, indexed like the reference's nested dicts (``p["wq"]``);
  ``param_tree(bp, generator, dtype)`` draws one (``generator`` None:
  ``meta`` tensors, nothing drawn).

Shapes and logical axes are the reference's, so parameters carry over from
the JAX package one to one (``repro_torch.convert``).  The draws are not the
JAX draws; tests carry weights across instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declares one parameter tensor."""

    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"       # normal | zeros | ones | embed
    scale: float = 1.0          # stddev multiplier for "normal"
    dtype: torch.dtype = torch.float32

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.logical):
            raise ValueError(
                f"shape {self.shape} and logical {self.logical} rank mismatch"
            )

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


Blueprint = Any  # nested dict with ParamSpec leaves


def _map_specs(fn, bp: Blueprint) -> Any:
    if isinstance(bp, ParamSpec):
        return fn(bp)
    return {k: _map_specs(fn, v) for k, v in bp.items()}


def _leaves(bp: Blueprint):
    if isinstance(bp, ParamSpec):
        yield bp
    else:
        for v in bp.values():
            yield from _leaves(v)


def _fan_in(spec: ParamSpec) -> int:
    """Fan-in for variance scaling: all dims but the last."""
    if len(spec.shape) <= 1:
        return max(spec.shape[0] if spec.shape else 1, 1)
    return max(int(np.prod(spec.shape[:-1])), 1)


def _init_leaf(spec: ParamSpec, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    x = torch.empty(spec.shape, dtype=torch.float32, device=device)
    if spec.init == "embed":
        # embedding init: unit normal scaled down
        x.normal_(0.0, spec.scale, generator=generator)
        return x.to(spec.dtype)
    if spec.init == "normal":
        # truncated-normal variance scaling (fan-in), like flax defaults
        std = spec.scale / math.sqrt(_fan_in(spec))
        nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return (x * std).to(spec.dtype)
    raise ValueError(f"unknown init {spec.init!r}")


def init_params(bp: Blueprint, generator: torch.Generator) -> Any:
    """Materialize parameters on the generator's device, leaf by leaf in
    the blueprint's order."""
    return _map_specs(
        lambda s: _init_leaf(s, generator, generator.device), bp
    )


def abstract_params(bp: Blueprint, dtype: Optional[torch.dtype] = None) -> Any:
    """``meta`` tensors of the blueprint's shapes, in ``dtype`` (each
    leaf's own without it): nothing is allocated."""
    return _map_specs(
        lambda s: torch.empty(s.shape, dtype=dtype or s.dtype, device="meta"),
        bp,
    )


def logical_axes(bp: Blueprint) -> Any:
    """The logical-axis tree, mirroring the parameter structure."""
    return _map_specs(lambda s: s.logical, bp)


def param_count(bp: Blueprint) -> int:
    return sum(s.size for s in _leaves(bp))


def cast_params(params: Any, dtype: torch.dtype) -> Any:
    """Cast float leaves of a nested dict (weights) to ``dtype``."""
    if isinstance(params, torch.Tensor):
        return params.to(dtype) if params.is_floating_point() else params
    return {k: cast_params(v, dtype) for k, v in params.items()}


def dense_spec(
    in_dim: int,
    out_dim: int,
    in_axis: Optional[str],
    out_axis: Optional[str],
    *,
    scale: float = 1.0,
    dtype: torch.dtype = torch.float32,
) -> ParamSpec:
    return ParamSpec((in_dim, out_dim), (in_axis, out_axis), "normal",
                     scale, dtype)


def stacked(spec: ParamSpec, layers: int) -> ParamSpec:
    """Stack a per-layer spec along a leading 'layers' axis."""
    return ParamSpec(
        (layers,) + spec.shape,
        ("layers",) + spec.logical,
        spec.init,
        spec.scale,
        spec.dtype,
    )


def stack_blueprint(bp: Blueprint, layers: int) -> Blueprint:
    """Stack every leaf of a per-layer blueprint (the reference's layout for
    ``lax.scan``; the port keeps it for counting and conversion)."""
    return _map_specs(lambda s: stacked(s, layers), bp)


class ParamTree(nn.Module):
    """Nested parameters as an ``nn.Module``: dict leaves become
    ``nn.Parameter``s (built frozen for serving; ``requires_grad_(True)``
    makes them trainable), dict nodes become
    child ``ParamTree``s.  ``tree["attn"]["wq"]`` reads like the
    reference's nested dicts, and ``state_dict`` keys are the dotted paths
    (``attn.wq``)."""

    def __init__(self, params: Mapping[str, Union[torch.Tensor, Mapping]]) -> None:
        super().__init__()
        for name, value in params.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False)
                )
            else:
                self.add_module(name, ParamTree(value))

    def __getitem__(self, name: str) -> Any:
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def draw_params(bp: Blueprint, generator: Optional[torch.Generator],
                dtype: torch.dtype) -> Any:
    """``bp``'s parameters drawn from ``generator`` and cast to ``dtype``;
    with no generator, ``abstract_params(bp, dtype)``."""
    if generator is None:
        return abstract_params(bp, dtype)
    return cast_params(init_params(bp, generator), dtype)


def param_tree(bp: Blueprint, generator: Optional[torch.Generator],
               dtype: torch.dtype) -> ParamTree:
    """A ``ParamTree`` of ``draw_params(bp, generator, dtype)``."""
    return ParamTree(draw_params(bp, generator, dtype))
