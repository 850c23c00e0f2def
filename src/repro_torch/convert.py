"""Carry parameters over from the JAX package.

The reference's parameters are a nested dict with the per-layer leaves
stacked on a leading layer axis under ``decoder``.  Given that tree as numpy
arrays, ``params_from_jax`` returns a ``state_dict`` for
``repro_torch.models.lm.TransformerLM``: ``decoder/<path>[i]`` becomes
``layers.<i>.<path>``, top-level leaves keep their names.  Values go through
float32 (numpy has no bfloat16) and are then cast to ``dtype``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for name, value in tree.items():
        key = f"{prefix}{name}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, key + "."))
        else:
            out[key] = np.asarray(value, dtype=np.float32)
    return out


def params_from_jax(
    tree: Mapping[str, Any], dtype: torch.dtype = torch.float32
) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``TransformerLM`` from the reference's
    parameter tree (numpy leaves, layer axis stacked)."""
    state: Dict[str, torch.Tensor] = {}
    for name, value in tree.items():
        if name == "decoder":
            for path, stacked in _flatten(value).items():
                for i, layer in enumerate(stacked):
                    state[f"layers.{i}.{path}"] = torch.tensor(layer).to(dtype)
        elif isinstance(value, Mapping):
            raise ValueError(f"unexpected subtree {name!r} outside 'decoder'")
        else:
            state[name] = torch.tensor(
                np.asarray(value, dtype=np.float32)).to(dtype)
    return state
