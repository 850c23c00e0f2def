"""Plain float32 Qwen2 (``Qwen2ForCausalLM``, as Qwen/Qwen2.5-3B publishes
it) over the benchmark's weights (``core/model.py`` names them).

Each layer: RMSNorm, attention with biases on the q, k and v projections
(none on the output), the rotary embedding, grouped-query heads; RMSNorm,
then a SwiGLU MLP (``down(silu(gate(x)) * up(x))``).  The output head is
the input embedding, transposed (tied).  No departure from the published
description; sliding-window attention is off there too.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from portbench.reference.common import (attention_block, final_logits,
                                        layer_weights, linear, rms_norm)

LAYER_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "bq", "bk", "bv",
              "mlp_wi", "mlp_wg", "mlp_wo")


@torch.no_grad()
def logits(cfg: dict, W: dict, seqs: List[torch.Tensor], prompt_lens: List[int],
           quant: Optional[str] = None) -> List[torch.Tensor]:
    """For each sequence (prompt then served tokens) the float32 logits at
    positions prompt_len - 1 .. T - 1.  Layer by layer over all sequences."""
    eps = cfg["rms_norm_eps"]
    xs = [W["embed"][s].float() for s in seqs]
    for i in range(cfg["num_hidden_layers"]):
        lw = layer_weights(W, i, LAYER_KEYS)
        for j, x in enumerate(xs):
            x = attention_block(x, lw, cfg, quant)
            h = rms_norm(x, lw["ln2"], eps)
            a = F.silu(linear(h, lw["mlp_wg"], quant)) * linear(h, lw["mlp_wi"], quant)
            xs[j] = x + linear(a, lw["mlp_wo"], quant)
        del lw
    return final_logits(xs, W, cfg, [p - 1 for p in prompt_lens], quant)
