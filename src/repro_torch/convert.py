"""Carry parameters, and scenario schedules, over from the JAX package.

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

``schedule_from_arrays`` is the same carrying-over for the scenario engine:
the fields of a reference ``CellSchedule`` (recorded by its control plane)
become the port's ``CellSchedule``, whose data plane replays them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.serving.torchengine.schedule import (
    BaseMetrics,
    CellSchedule,
    SubStepGrid,
)

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


def schedule_from_arrays(fields: Mapping[str, Any]) -> CellSchedule:
    """The port's ``CellSchedule`` from the fields of the reference's, as
    numpy arrays and plain values: ``fields["grid"]`` holds the fields of
    its ``SubStepGrid`` and ``fields["base"]`` those of its ``SimResult``
    (only the ``BaseMetrics`` ones are read).  Arrays are copied into the
    dtypes the data plane takes; a missing field raises ``KeyError``."""
    g = fields["grid"]
    grid = SubStepGrid(
        ts=np.array(g["ts"], dtype=np.float64),
        win_of=np.array(g["win_of"], dtype=np.int64),
        win_first=np.array(g["win_first"], dtype=np.int64),
        ticks=int(g["ticks"]),
        dt=float(g["dt"]),
        sub_step_s=float(g["sub_step_s"]),
    )
    b = fields["base"]
    base = BaseMetrics(**{f.name: (int if f.type == "int" else float)(b[f.name])
                          for f in dataclasses.fields(BaseMetrics)})
    return CellSchedule(
        policy_name=str(fields["policy_name"]),
        trace_name=str(fields["trace_name"]),
        workload_name=str(fields["workload_name"]),
        arr=np.array(fields["arr"], dtype=np.float64),
        svc=np.array(fields["svc"], dtype=np.float64),
        rcode=np.array(fields["rcode"], dtype=np.int64),
        n_regions=int(fields["n_regions"]),
        timeout_s=float(fields["timeout_s"]),
        concurrency=int(fields["concurrency"]),
        lb_kind=str(fields["lb_kind"]),
        grid=grid,
        ready_mask=np.array(fields["ready_mask"], dtype=bool),
        rtt=np.array(fields["rtt"], dtype=np.float64),
        kill_slot=np.array(fields["kill_slot"], dtype=np.int64),
        kill_g=np.array(fields["kill_g"], dtype=np.int64),
        post_slots=np.array(fields["post_slots"], dtype=np.int64),
        base=base,
        n_slots=int(fields["n_slots"]),
        trace_on=bool(fields["trace_on"]),
    )
