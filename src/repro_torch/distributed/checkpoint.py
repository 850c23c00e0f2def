"""Checkpoint save / restore with atomic manifests (counterpart of
``repro.distributed.checkpoint``), in the reference's on-disk layout:

    <dir>/step_00000100/
        manifest.json        # step, one entry per tensor: key, file, shape, dtype
        leaf_00000.npy ...   # one file per tensor: its raw bytes as uint8
    <dir>/step_00000100.tmp/ # written first, renamed when complete

A checkpoint counts once its directory is renamed and holds its manifest:
``latest_step`` ignores ``.tmp`` directories a preempted writer left
behind, and the next save removes them.  A save keeps the newest ``keep``
checkpoints.  Every tensor is stored as its raw bytes with its true dtype
in the manifest, so bf16 needs neither ``ml_dtypes`` nor ``safetensors``.

Trees are nested dicts of tensors (``{"params": {name: tensor}, "opt_state":
{"m": {...}, "v": {...}, "step": tensor}}``); a tensor's key is its path
joined with ``/`` (``params/layers.0.attn.wq``).  ``restore_checkpoint``
reads into the structure of a template: a key the checkpoint lacks raises
``KeyError``, a shape that differs raises ``ValueError``, and each tensor
lands on its template tensor's device.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16,
    "float16": torch.float16, "float64": torch.float64,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
DTYPE_NAMES = {v: k for k, v in DTYPES.items()}


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for name, value in tree.items():
        key = f"{prefix}{name}"
        if isinstance(value, Mapping):
            yield from _flatten(value, key + "/")
        else:
            yield key, value


def _step_dirs(directory: str):
    return sorted(d for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def save_checkpoint(
    directory: str,
    step: int,
    params: Mapping[str, Any],
    opt_state: Optional[Mapping[str, Any]] = None,
    *,
    extra: Optional[Dict[str, Any]] = None,
    keep: int = 3,
) -> str:
    """Write params (and the optimizer state) atomically; prune old
    checkpoints to the newest ``keep``.  Returns the checkpoint's path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    tree: Dict[str, Any] = {"params": params}
    if opt_state is not None:
        tree["opt_state"] = opt_state
    manifest: Dict[str, Any] = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (key, leaf) in enumerate(_flatten(tree)):
        t = torch.as_tensor(leaf).detach().contiguous().cpu()
        if t.dtype not in DTYPE_NAMES:
            raise TypeError(f"{key}: dtype {t.dtype} has no checkpoint name")
        fname = f"leaf_{i:05d}.npy"
        raw = t.reshape(-1).view(torch.uint8).numpy() if t.numel() else \
            np.zeros(0, np.uint8)
        np.save(os.path.join(tmp, fname), raw)
        manifest["leaves"].append({"key": key, "file": fname,
                                   "shape": list(t.shape),
                                   "dtype": DTYPE_NAMES[t.dtype]})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)           # the commit

    for old in _step_dirs(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, old), ignore_errors=True)
    # stale .tmp directories of preempted writers
    for d in os.listdir(directory):
        if d.endswith(".tmp"):
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
    return final


def latest_step(directory: str) -> Optional[int]:
    """The newest complete checkpoint's step, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in _step_dirs(directory)
             if os.path.exists(os.path.join(directory, d, "manifest.json"))]
    return max(steps) if steps else None


def _read_leaf(path: str, entry: Mapping[str, Any]) -> torch.Tensor:
    raw = np.load(os.path.join(path, entry["file"]))
    dtype = DTYPES[entry["dtype"]]
    t = torch.from_numpy(raw.copy()).view(dtype)
    return t.reshape(entry["shape"])


def restore_checkpoint(
    directory: str,
    template: Mapping[str, Any],
    *,
    step: Optional[int] = None,
) -> Tuple[Dict[str, Any], int]:
    """Read a checkpoint (the newest complete one unless ``step``) into the
    structure of ``template`` ({"params": ..., "opt_state": ...?}).
    Returns (tree, step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {e["key"]: e for e in manifest["leaves"]}

    def restore(tree: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name, leaf in tree.items():
            key = f"{prefix}{name}"
            if isinstance(leaf, Mapping):
                out[name] = restore(leaf, key + "/")
                continue
            entry = by_key.get(key)
            if entry is None:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            want = tuple(torch.as_tensor(leaf).shape)
            if tuple(entry["shape"]) != want:
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{tuple(entry['shape'])} vs template {want}")
            device = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
            out[name] = _read_leaf(path, entry).to(device)
        return out

    return restore(template, ""), step


__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint"]
