"""Assigned architecture configs (the port's own copy of ``repro.configs``).

``get_config(arch_id)`` returns the exact published ModelConfig;
``get_smoke_config(arch_id)`` the reduced same-family config used by the
CPU tests; ``SHAPES`` the four assigned input-shape cells.  The files are data and are kept field-for-field equal to the
reference package's.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.shapes import SHAPES, ShapeSpec, cells_for
from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "paligemma-3b",
    "falcon-mamba-7b",
    "command-r-35b",
    "h2o-danube3-4b",
    "qwen2.5-3b",
    "llama3.2-1b",
    "whisper-medium",
    "phi3.5-moe-42b",
    "qwen3-moe-30b",
    "zamba2-7b",
]

_MODULES: Dict[str, str] = {
    "paligemma-3b": "paligemma_3b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "command-r-35b": "command_r_35b",
    "h2o-danube3-4b": "h2o_danube3_4b",
    "qwen2.5-3b": "qwen2_5_3b",
    "llama3.2-1b": "llama3_2_1b",
    "whisper-medium": "whisper_medium",
    "phi3.5-moe-42b": "phi3_5_moe_42b",
    "qwen3-moe-30b": "qwen3_moe_30b",
    "zamba2-7b": "zamba2_7b",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    if hasattr(mod, "smoke_config"):
        return mod.smoke_config()
    return get_config(arch_id).scaled()


__all__ = ["ARCH_IDS", "ModelConfig", "SHAPES", "ShapeSpec", "cells_for",
           "get_config", "get_smoke_config"]
