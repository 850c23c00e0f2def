"""PyTorch / CUDA port of SkyServe for NVIDIA Hopper: the model data plane
and its train path, the scenario engine, and the control plane it runs on
(the spot traces, the cluster simulator, SpotHedge and its baselines, the
autoscalers).

A sibling of the JAX package ``repro``, which stays the reference.  This
package imports ``torch`` and numpy only: never ``jax`` and nothing from
``repro``.  Module names mirror the reference's, so ``repro_torch.models.lm``
is the counterpart of ``repro.models.lm``.

Entry points take ``device=`` and default to ``"cuda"``; on a machine
without CUDA they raise unless the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Asking for CUDA where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


__all__ = ["resolve_device"]
