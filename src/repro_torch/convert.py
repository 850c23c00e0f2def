"""Carry parameters over from the JAX package.

The reference's parameters are a nested dict with the per-layer leaves
stacked on a leading layer axis under ``decoder``.  Given that tree as numpy
arrays, ``params_from_jax`` returns a ``state_dict`` for the port's model:

* ``repro_torch.models.lm.TransformerLM``: ``decoder/<path>[i]`` becomes
  ``layers.<i>.<path>``, top-level leaves keep their names.  The hybrid
  family's decoder is mapped explicitly: ``prelude/<path>[i]`` becomes
  ``prelude.<i>.<path>``, ``blocks/<path>[i][j]`` (stacked twice) becomes
  ``blocks.<i>.<j>.<path>``, and ``shared_attn/<path>`` (not stacked)
  keeps its path under ``shared_attn``.
* ``repro_torch.models.whisper.EncDecLM`` (a tree with ``encoder``):
  ``encoder/<path>[i]`` becomes ``encoder.<i>.<path>``,
  ``decoder/<path>[i]`` becomes ``decoder.<i>.<path>``, and the
  LayerNorms ``enc_norm`` / ``dec_norm`` become ``<name>.scale`` and
  ``<name>.bias``.

Any other subtree raises ``ValueError``.  Values go through float32 (numpy
has no bfloat16) and are then cast to ``dtype``.  A stack whose leaves
disagree on their layer axes raises ``ValueError``; a leaf that is missing
or of the wrong shape is refused by ``load_state_dict``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

HYBRID_KEYS = {"prelude", "blocks", "shared_attn"}
NORM_KEYS = {"enc_norm", "dec_norm"}       # EncDecLM's LayerNorm subtrees


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for name, value in tree.items():
        key = f"{prefix}{name}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, key + "."))
        else:
            out[key] = np.asarray(value, dtype=np.float32)
    return out


def _unstack(leaves: Dict[str, np.ndarray], axes: int, where: str):
    """Split every leaf along its first ``axes`` axes, which all leaves must
    share; yields (index tuple, path, slice)."""
    leads = {tuple(v.shape[:axes]) for v in leaves.values()}
    if len(leads) > 1 or any(v.ndim <= axes for v in leaves.values()):
        raise ValueError(f"{where}: leaves disagree on their {axes} stacked "
                         f"layer axes: {sorted(leads)}")
    for path, stacked in leaves.items():
        for idx in np.ndindex(*stacked.shape[:axes]):
            yield idx, path, stacked[idx]


def _decoder(tree: Mapping[str, Any], prefix: str):
    """(state-dict prefix, index tuple, path, slice) for every decoder leaf;
    a stack that is not the hybrid's goes under ``prefix``."""
    if set(tree) != HYBRID_KEYS:
        for idx, path, leaf in _unstack(_flatten(tree), 1, "decoder"):
            yield prefix, idx, path, leaf
        return
    for name, axes in (("prelude", 1), ("blocks", 2)):
        for idx, path, leaf in _unstack(_flatten(tree[name]), axes, name):
            yield name, idx, path, leaf
    for path, leaf in _flatten(tree["shared_attn"]).items():
        yield "shared_attn", (), path, leaf


def params_from_jax(
    tree: Mapping[str, Any], dtype: torch.dtype = torch.float32
) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``TransformerLM`` or ``EncDecLM`` from the
    reference's parameter tree (numpy leaves, layer axes stacked)."""
    encdec = "encoder" in tree
    state: Dict[str, torch.Tensor] = {}
    for name, value in tree.items():
        if name == "decoder":
            stacks = _decoder(value, "decoder" if encdec else "layers")
        elif name == "encoder" and isinstance(value, Mapping):
            stacks = (("encoder", idx, path, leaf) for idx, path, leaf
                      in _unstack(_flatten(value), 1, "encoder"))
        elif encdec and name in NORM_KEYS and isinstance(value, Mapping):
            stacks = ((name, (), path, leaf)
                      for path, leaf in _flatten(value).items())
        elif isinstance(value, Mapping):
            expected = "'decoder', 'encoder', 'enc_norm' and 'dec_norm'" \
                if encdec else "'decoder'"
            raise ValueError(f"unexpected subtree {name!r}: only {expected} "
                             "are subtrees")
        else:
            state[name] = torch.tensor(
                np.asarray(value, dtype=np.float32)).to(dtype)
            continue
        for prefix, idx, path, leaf in stacks:
            key = ".".join([prefix, *map(str, idx), path])
            state[key] = torch.tensor(leaf).to(dtype)
    return state
