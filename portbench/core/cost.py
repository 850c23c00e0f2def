"""The yardstick's work formulas and the card's peaks, frozen here so that a
change to the program cannot move the bounds it is measured against.

The kernel formulas are a copy of the port's ``kernels/cost.py`` as it
stood when this benchmark was written (each input byte read once, each
output byte written once, in the dtypes the kernel reads and writes; where
the work depends on the data, what this run's data needs).  The model's
FLOPs are the ones the model's equations need, counted from the
configuration: projections, the routed experts, attention over the unmasked
pairs, and the logits that are computed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class Work:
    flops: float
    bytes: float

    def bound_s(self, peak_flops: float = PEAK_BF16_FLOPS,
                peak_bytes: float = PEAK_BYTES_PER_S) -> float:
        """The least time the card could take: the larger of operations over
        the peak and bytes over the memory rate."""
        return max(self.flops / peak_flops, self.bytes / peak_bytes)


def attention_pairs(Sq: int, Skv: int, causal: bool,
                    window: Optional[int] = None, prefix: int = 0) -> int:
    """Unmasked (query, key) pairs: query i sees key j where (not causal,
    or j <= i, or j < prefix) and (no window, or i - j < window)."""
    q = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(q, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.zeros(Sq, dtype=np.int64)
    if window is not None:
        lo = np.maximum(lo, q - window + 1)
    main = np.clip(hi - lo + 1, 0, None)
    extra = 0
    if causal and prefix:
        first = np.maximum(q + 1, 0)
        last = min(prefix, Skv) - 1
        extra = np.clip(last - first + 1, 0, None)
    return int((main + extra).sum())


def flash_attention_work(B: int, H: int, Kv: int, Sq: int, Skv: int, D: int,
                         itemsize: int, *, causal: bool,
                         window: Optional[int] = None, prefix: int = 0) -> Work:
    """QK^T and PV over the unmasked pairs (2 x 2 operations per head, pair
    and channel); q and the output (B, Sq, H, D), k and v (B, Skv, Kv, D)."""
    pairs = attention_pairs(Sq, Skv, causal, window, prefix)
    return Work(4.0 * B * H * D * pairs,
                float(itemsize) * (2 * B * Sq * H * D + 2 * B * Skv * Kv * D))


def flash_decode_work(B: int, H: int, Kv: int, S: int, D: int, itemsize: int,
                      n_valid: Optional[int] = None) -> Work:
    """One query token per head against ``n_valid`` valid slots of an
    S-slot cache: q and the output, the (B, S) one-byte mask, and the K and
    V rows of the valid slots."""
    n = S if n_valid is None else n_valid
    return Work(4.0 * B * H * D * n,
                float(itemsize) * B * H * D * 2 + B * S
                + float(itemsize) * 2 * B * n * Kv * D)


def moe_gmm_work(E: int, C: int, D: int, F: int, itemsize: int,
                 n_rows: Optional[int] = None,
                 n_occupied: Optional[int] = None) -> Work:
    """y[e] = x[e] @ w[e] over the occupied rows: the occupied experts'
    weights, the occupied rows of x, and all of y (E x C x F)."""
    rows = E * C if n_rows is None else n_rows
    occ = E if n_occupied is None else n_occupied
    return Work(2.0 * rows * D * F,
                float(itemsize) * (occ * D * F + rows * D + E * C * F))


# ---------------------------------------------------------------------------
# The model's FLOPs (for the step's share of the peak)
# ---------------------------------------------------------------------------


def _per_token_matmul_flops(m) -> float:
    """2 x the weights one token multiplies through in one layer: the
    attention projections, and the MLP or the router and the routed
    experts.  ``m`` is a ``ModelShape``."""
    d, H, Kv, D = m.d_model, m.heads, m.kv_heads, m.head_dim
    attn = d * (H + 2 * Kv) * D + H * D * d
    if m.experts:
        ffn = d * m.experts + m.top_k * 3 * d * m.expert_ff
    else:
        ffn = 3 * d * m.d_ff
    return 2.0 * (attn + ffn)


@dataclasses.dataclass(frozen=True)
class ModelShape:
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    experts: int = 0
    top_k: int = 0
    expert_ff: int = 0


def model_shape(cfg: dict) -> ModelShape:
    """The widths of a benchmark configuration file (published keys)."""
    H = cfg["num_attention_heads"]
    return ModelShape(
        layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        heads=H, kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg.get("head_dim", cfg["hidden_size"] // H),
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        experts=cfg.get("num_experts", 0),
        top_k=cfg.get("num_experts_per_tok", 0),
        expert_ff=cfg.get("moe_intermediate_size", 0))


def prefill_flops(m: ModelShape, S: int) -> float:
    """A prefill of S tokens: every token through every layer, causal
    attention over its pairs, and the logits of the last position."""
    attn = 4.0 * m.heads * m.head_dim * attention_pairs(S, S, True)
    return (m.layers * (S * _per_token_matmul_flops(m) + attn)
            + 2.0 * m.d_model * m.vocab)


def decode_flops(m: ModelShape, n_valid: int) -> float:
    """One decode step of one token against ``n_valid`` cached positions
    (its own included), with its logits."""
    attn = 4.0 * m.heads * m.head_dim * n_valid
    return (m.layers * (_per_token_matmul_flops(m) + attn)
            + 2.0 * m.d_model * m.vocab)
