"""What the plain references share: float32 RMSNorm, rotary embedding,
causal grouped-query attention and a linear layer, in plain ``torch`` ops.

``quant="fp8"`` is the control, the model computed in float8 e4m3: every
matrix product (the projections, the experts, the router and the output
head) takes its weight rounded with a scale per output channel and its
input with a scale per row, and attention reads q, k and v rounded with a
scale per token and head (a float8 KV cache); norms, softmax and the
residual stream stay in float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

FP8_MAX = 448.0


def no_tf32() -> None:
    """Float32 products in float32: TF32 would be a lower precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fake_fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the slice's largest magnitude maps to 448), back in float32."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def linear(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """x (N, in) @ w (in, out); under the control both rounded to fp8."""
    if quant == "fp8":
        return fake_fp8(x, -1) @ fake_fp8(w, 0)
    if quant is not None:
        raise ValueError(f"unknown precision {quant!r}")
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (T, heads, D) at positions 0..T-1, the two
    halves of each head rotated together (``rotate_half``)."""
    T, _, D = x.shape
    half = D // 2
    freq = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     block: int = 512) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over keys at or before each query; q (T,
    H, D), k and v (T, Kv, D), H a multiple of Kv; queries in blocks."""
    T, H, D = q.shape
    Kv = k.shape[1]
    G = H // Kv
    out = torch.empty_like(q)
    for s in range(0, T, block):
        e = min(s + block, T)
        qb = q[s:e].reshape(e - s, Kv, G, D)
        scores = torch.einsum("qkgd,mkd->kgqm", qb, k[:e]) / math.sqrt(D)
        later = (torch.arange(e, device=q.device)[None, :]
                 > torch.arange(s, e, device=q.device)[:, None])
        p = torch.softmax(scores.masked_fill(later, float("-inf")), dim=-1)
        out[s:e] = torch.einsum("kgqm,mkd->qkgd", p, v[:e]).reshape(e - s, H, D)
    return out


def attention_block(x, lw: dict, cfg: dict, quant: Optional[str]) -> torch.Tensor:
    """One pre-norm self-attention sub-layer of a Qwen decoder on one
    sequence x (T, d): the residual plus the attention's output."""
    T, d = x.shape
    H, Kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = cfg.get("head_dim", d // H)
    eps = cfg["rms_norm_eps"]
    h = rms_norm(x, lw["ln1"], eps)
    q = linear(h, lw["wq"].reshape(d, H * D), quant).view(T, H, D)
    k = linear(h, lw["wk"].reshape(d, Kv * D), quant).view(T, Kv, D)
    v = linear(h, lw["wv"].reshape(d, Kv * D), quant).view(T, Kv, D)
    if "bq" in lw:
        q, k, v = q + lw["bq"], k + lw["bk"], v + lw["bv"]
    if "q_norm" in lw:
        q, k = rms_norm(q, lw["q_norm"], eps), rms_norm(k, lw["k_norm"], eps)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    if quant == "fp8":
        q, k, v = fake_fp8(q, -1), fake_fp8(k, -1), fake_fp8(v, -1)
    a = causal_attention(q, k, v)
    return x + linear(a.reshape(T, H * D), lw["wo"].reshape(H * D, d), quant)


def layer_weights(W: dict, i: int, keys) -> dict:
    """Layer ``i``'s weights of ``keys`` (those ``W`` has) in float32."""
    return {k: W[k][i].float() for k in keys if k in W}


def final_logits(xs, W: dict, cfg: dict, starts, quant: Optional[str]) -> list:
    """Float32 logits over the published vocabulary at positions
    starts[j]..T-1 of each sequence's hidden states xs[j] (T, d)."""
    V = cfg["vocab_size"]
    head = (W["embed"][:V].float().T if cfg["tie_word_embeddings"]
            else W["unembed"][:, :V].float())
    norm = W["final_norm"].float()
    return [linear(rms_norm(x[s:], norm, cfg["rms_norm_eps"]), head, quant)
            for x, s in zip(xs, starts)]
