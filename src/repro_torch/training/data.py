"""Synthetic data for the train path (counterpart of
``repro.training.data``).

Deterministic token streams keyed by (seed, step): a batch is drawn from
``np.random.default_rng((seed, step))`` exactly as the reference draws it,
so tokens and labels are the reference's to the bit (int64 here, int32
there), and the encoder-decoder's frames or the prefix-LM's patches are
the same float32 normals, cast to the activation dtype.  A real deployment
swaps ``synthetic_batches`` for a tokenised corpus reader with the same
contract.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig


def make_batch(
    cfg: ModelConfig,
    batch: int,
    seq: int,
    *,
    seed: int = 0,
    step: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    device: Any = "cuda",
) -> Dict[str, torch.Tensor]:
    """One synthetic batch with next-token labels (and the frontend stub's
    frames or patches) on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng((seed, step))
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(batch, seq + 1), dtype=np.int32)
    ).long()
    out = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
    front = "frames" if cfg.is_encdec else "patches" if cfg.frontend else None
    if front is not None:
        x = rng.standard_normal((batch, cfg.frontend_seq, cfg.d_model),
                                dtype=np.float32)
        out[front] = torch.from_numpy(x).to(device=dev, dtype=dtype)
    return out


def synthetic_batches(
    cfg: ModelConfig,
    batch: int,
    seq: int,
    *,
    seed: int = 0,
    start_step: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    device: Any = "cuda",
) -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield make_batch(cfg, batch, seq, seed=seed, step=step, dtype=dtype,
                         device=device)
        step += 1


def abstract_batch(cfg: ModelConfig, batch: int, seq: int,
                   dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The batch's shapes and dtypes as tensors on the ``meta`` device."""
    out = {
        "tokens": torch.empty((batch, seq), dtype=torch.long, device="meta"),
        "labels": torch.empty((batch, seq), dtype=torch.long, device="meta"),
    }
    front = "frames" if cfg.is_encdec else "patches" if cfg.frontend else None
    if front is not None:
        out[front] = torch.empty((batch, cfg.frontend_seq, cfg.d_model),
                                 dtype=dtype, device="meta")
    return out


__all__ = ["abstract_batch", "make_batch", "synthetic_batches"]
