"""The four assigned input-shape cells (the port's own copy of
``repro.configs.shapes``, held field for field against it by a test).

    train_4k     seq 4,096   × global_batch 256   -> train step
    prefill_32k  seq 32,768  × global_batch 32    -> prefill step
    decode_32k   seq 32,768  × global_batch 128   -> serve step (1 new token,
                                                    KV cache of seq_len)
    long_500k    seq 524,288 × global_batch 1     -> serve step; requires
                                                    sub-quadratic attention

``cells_for(cfg)`` applies the assignment's skip rules: ``long_500k`` only
for SSM / hybrid / sliding-window archs (pure full-attention archs record
the skip).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cells_for(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """[(shape_name, status)]: status 'run' or a skip reason."""
    out: List[Tuple[str, str]] = []
    for name, spec in SHAPES.items():
        if name == "long_500k" and not cfg.supports_long_context:
            out.append((name, "skip: quadratic full attention"))
            continue
        out.append((name, "run"))
    return out
