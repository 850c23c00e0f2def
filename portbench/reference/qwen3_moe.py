"""Plain float32 Qwen3-MoE (``Qwen3MoeForCausalLM``, as Qwen/Qwen3-30B-A3B
publishes it) over the benchmark's weights (``core/model.py`` names them).

Each layer: RMSNorm, attention with per-head RMSNorm on q and k (QK-norm)
before the rotary embedding, grouped-query heads, no biases; RMSNorm, then
the sparse MoE block: a softmax router over all experts, the top k kept and
renormalised (``norm_topk_prob``), each chosen expert a SwiGLU MLP
(``down(silu(gate(x)) * up(x))``), their outputs summed by those weights.
Untied output head.

Departure from the published model, as the configuration states it: the
served program routes a prefill of P tokens with a capacity of
ceil(P * k / E * capacity_factor) tokens per expert, counting each expert's
(token, choice) pairs token by token and choice by choice, and drops the
pairs past it; a decode step is one token and drops nothing.  The reference
does the same: the prompt's positions are routed as one prefill, each later
position alone.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F

from portbench.reference.common import (attention_block, final_logits,
                                        layer_weights, linear, rms_norm)

LAYER_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "q_norm", "k_norm",
              "router", "moe_wi", "moe_wg", "moe_wo")


def kept_pairs(idx: torch.Tensor, P: int, E: int, cf: float) -> torch.Tensor:
    """Which (token, choice) pairs of a prefill's P tokens (``idx`` (P, k),
    the chosen experts) fit their expert's capacity."""
    k = idx.shape[1]
    C = max(math.ceil(P * k / E * cf), 1)
    onehot = F.one_hot(idx.reshape(-1), E)
    pos = (onehot.cumsum(0) * onehot).sum(-1) - 1
    return (pos < C).view(P, k)


def moe(h: torch.Tensor, lw: dict, cfg: dict, lengths: List[int],
        prompt_lens: List[int], quant: Optional[str]) -> torch.Tensor:
    """The sparse MoE block over the tokens of all sequences, h (N, d)."""
    E, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    gates = torch.softmax(linear(h, lw["router"], quant), dim=-1)
    w, idx = torch.topk(gates, k, dim=-1)
    if cfg["norm_topk_prob"]:
        w = w / w.sum(-1, keepdim=True)
    keep = torch.ones_like(idx, dtype=torch.bool)
    start = 0
    for T, P in zip(lengths, prompt_lens):
        keep[start:start + P] = kept_pairs(idx[start:start + P], P, E,
                                           cfg["program"]["capacity_factor"])
        start += T
    w = w * keep
    y = torch.zeros_like(h)
    for e in range(E):
        tok, choice = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        x = h[tok]
        a = F.silu(linear(x, lw["moe_wg"][e], quant)) * linear(x, lw["moe_wi"][e], quant)
        y.index_add_(0, tok, linear(a, lw["moe_wo"][e], quant) * w[tok, choice, None])
    return y


@torch.no_grad()
def logits(cfg: dict, W: dict, seqs: List[torch.Tensor], prompt_lens: List[int],
           quant: Optional[str] = None) -> List[torch.Tensor]:
    """For each sequence (prompt then served tokens) the float32 logits at
    positions prompt_len - 1 .. T - 1: the ones that chose each served
    token.  Layer by layer over all sequences."""
    eps = cfg["rms_norm_eps"]
    lengths = [int(s.shape[0]) for s in seqs]
    xs = [W["embed"][s].float() for s in seqs]
    for i in range(cfg["num_hidden_layers"]):
        lw = layer_weights(W, i, LAYER_KEYS)
        xs = [attention_block(x, lw, cfg, quant) for x in xs]
        h = torch.cat([rms_norm(x, lw["ln2"], eps) for x in xs])
        y = moe(h, lw, cfg, lengths, prompt_lens, quant)
        xs = [x + part for x, part in zip(xs, y.split(lengths))]
        del lw
    return final_logits(xs, W, cfg, [p - 1 for p in prompt_lens], quant)
