"""Plain PyTorch versions of the kernels, in the reference package's kernel
layouts (counterpart of ``repro.kernels.ref``).

They are the CPU path of ``repro_torch.kernels.ops`` and the yardstick that
``chip_smoke.py`` holds each CUDA kernel against on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,              # (B, H, Sq, D)
    k: torch.Tensor,              # (B, Kv, Skv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    prefix_len: int = 0,
) -> torch.Tensor:
    B, H, Sq, D = q.shape
    Kv, Skv = k.shape[1], k.shape[2]
    G = H // Kv
    qg = q.reshape(B, Kv, G, Sq, D).float()
    s = torch.einsum("bkgqd,bkmd->bkgqm", qg, k.float()) / math.sqrt(D)
    q_pos = torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        c = q_pos[:, None] >= k_pos[None, :]
        if prefix_len:
            c = c | (k_pos[None, :] < prefix_len)
        mask &= c
    if window is not None:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=q.device))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqm,bkmd->bkgqd", w, v.float())
    return out.reshape(B, H, Sq, D).to(q.dtype)


def flash_decode_ref(
    q: torch.Tensor,              # (B, H, D)
    k: torch.Tensor,              # (B, Kv, S, D)
    v: torch.Tensor,
    valid: torch.Tensor,          # (B, S) int8 / bool
    return_lse: bool = False,
):
    """Softmax attention of one query row per head over the valid slots.
    With ``return_lse``: (the output (B, H, D) in fp32, the log-sum-exp of
    each row's masked, scaled scores (B, H)); a row with no valid slot has
    -1e30, the mask's finite value."""
    B, H, D = q.shape
    Kv = k.shape[1]
    G = H // Kv
    qg = q.reshape(B, Kv, G, D).float()
    s = torch.einsum("bkgd,bkmd->bkgm", qg, k.float()) / math.sqrt(D)
    s = torch.where(
        valid[:, None, None, :].bool(), s, torch.tensor(NEG_INF, device=q.device)
    )
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgm,bkmd->bkgd", w, v.float())
    if return_lse:
        return out.reshape(B, H, D), torch.logsumexp(s, dim=-1).reshape(B, H)
    return out.reshape(B, H, D).to(q.dtype)


def selective_scan_ref(
    a: torch.Tensor,              # (B, Q, C, N)
    b: torch.Tensor,
    h0: torch.Tensor,             # (B, C, N)
) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t for t = 0..Q-1, every h_t in fp32
    (B, Q, C, N): a sequential loop over Q, one fused step per t."""
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    h = h0.float()
    for t in range(a.shape[1]):
        h = torch.addcmul(b[:, t].float(), a[:, t].float(), h, out=out[:, t])
    return out


def moe_gmm_ref(
    x: torch.Tensor,              # (E, C, D)
    w: torch.Tensor,              # (E, D, F)
    rows: Optional[torch.Tensor] = None,   # (E,) int
) -> torch.Tensor:
    """y[e] = x[e] @ w[e] in fp32, cast back to x's dtype (E, C, F).  With
    ``rows``, only the first rows[e] rows of x[e] hold tokens: y's rows at
    or past rows[e] are zeros, whatever x holds there."""
    y = torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
    if rows is None:
        return y
    live = torch.arange(x.shape[1], device=x.device)[None, :] < rows[:, None]
    return torch.where(live[..., None], y, torch.zeros((), dtype=y.dtype,
                                                        device=y.device))
