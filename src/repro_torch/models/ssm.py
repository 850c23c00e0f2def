"""State-space sequence mixer, Mamba-1 (falcon-mamba) — counterpart of the
Mamba-1 half of ``repro.models.ssm``.  Mamba-2/SSD (zamba2) comes with the
hybrid stack.

Full-sequence processing is chunked as in the reference: the SSM state is
carried across chunks of ``chunk`` steps, and within a chunk the recurrence
h_t = a_t * h_{t-1} + b_t is the selective scan.  Two compute paths, chosen
by ``impl``:

* ``"kernel"`` (default) goes through ``repro_torch.kernels.ops``: the
  hand-written CUDA scan for CUDA tensors, its plain version for CPU tensors.
* ``"plain"`` runs the scan's plain PyTorch version on any device;
  ``chip_smoke.py`` holds the kernel path against it on the card.

The reference pads the last chunk with a = 1, b = 0 up to a whole chunk;
here the last chunk is scanned with its true length, which leaves the same
outputs and final state without copying the padded (B, S, d_inner, N)
tensors.  Each chunk is a view of the sequence's a and b (the kernel takes
their B and Q strides), so nothing is copied per chunk either.

Decode is the single-step recurrence with a carried (conv, ssm) state; the
reference has no kernel there, and neither has the port.

Activation-dtype order is the reference's: the in/x/dt projections, the
softplus and the conv taps run in the activation dtype and are cast to fp32
after; y is formed in fp32 and cast back before ``out_proj``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels import selective_scan as _ss
from repro_torch.models.base import ParamSpec
from repro_torch.models.config import ModelConfig

IMPLS = ("kernel", "plain")


# ---------------------------------------------------------------------------
# Depthwise causal conv
# ---------------------------------------------------------------------------


def causal_conv1d(
    x: torch.Tensor,                      # (B, S, C)
    w: torch.Tensor,                      # (K, C) depthwise taps
    bias: Optional[torch.Tensor],         # (C,)
    prev: Optional[torch.Tensor] = None,  # (B, K-1, C) carried context
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, C), new_prev (B, K-1, C)), in x's dtype.  The taps
    are a loop of multiply-adds in x's dtype, as in the reference (not
    ``F.conv1d``, which runs float32 in TF32 on the card)."""
    K, S = w.shape[0], x.shape[1]
    if prev is None:
        prev = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([prev.to(x.dtype), x], dim=1)          # (B, S+K-1, C)
    y = xp[:, :S] * w[0].to(x.dtype)
    for tap in range(1, K):
        y = y + xp[:, tap:tap + S] * w[tap].to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    new_prev = xp[:, -(K - 1):] if K > 1 else prev
    return y, new_prev


# ---------------------------------------------------------------------------
# Mamba-1
# ---------------------------------------------------------------------------


def mamba1_blueprint(cfg: ModelConfig) -> Dict[str, Any]:
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dt_rank = max(1, math.ceil(d / 16))
    return {
        "in_proj": ParamSpec((d, 2 * di), ("embed", "ssm_inner")),
        "conv_w": ParamSpec((cfg.ssm_conv, di), ("conv", "ssm_inner")),
        "conv_b": ParamSpec((di,), ("ssm_inner",), "zeros"),
        "x_proj": ParamSpec((di, dt_rank + 2 * N), ("ssm_inner", None)),
        "dt_proj": ParamSpec((dt_rank, di), (None, "ssm_inner")),
        "dt_bias": ParamSpec((di,), ("ssm_inner",), "zeros"),
        "A_log": ParamSpec((di, N), ("ssm_inner", "ssm_state"), "zeros"),
        "D": ParamSpec((di,), ("ssm_inner",), "ones"),
        "out_proj": ParamSpec((di, d), ("ssm_inner", "embed")),
    }


def _mamba1_coeffs(p, cfg: ModelConfig, x_conv: torch.Tensor, dt: torch.dtype):
    """delta / B / C from the conv output; returns (a, bx, C) per step:
    a, bx (B, S, d_inner, N) and C (B, S, N), all fp32."""
    N = cfg.ssm_state
    dt_rank = p["dt_proj"].shape[0]
    proj = x_conv @ p["x_proj"].to(dt)                    # (B, S, R+2N)
    delta_r, Bc, Cc = torch.split(proj, [dt_rank, N, N], dim=-1)
    delta = F.softplus(
        delta_r @ p["dt_proj"].to(dt) + p["dt_bias"].to(dt)
    ).float()                                             # (B, S, di)
    A = -torch.exp(p["A_log"].float())                    # (di, N)
    a = (delta[..., None] * A).exp_()                     # (B, S, di, N)
    bx = (delta * x_conv.float())[..., None] * Bc.float()[..., None, :]
    return a, bx, Cc.float()


def mamba1_full(
    p: Dict[str, Any],
    cfg: ModelConfig,
    x: torch.Tensor,                      # (B, S, d)
    *,
    chunk: int = 256,
    state: Optional[Dict[str, torch.Tensor]] = None,
    impl: str = "kernel",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence Mamba-1; returns (y, {"conv", "ssm"} final state).
    One scan per chunk of ``chunk`` steps (ceil(S / chunk) in all)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; have {IMPLS}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    B, S, _ = x.shape
    di, N = cfg.d_inner, cfg.ssm_state
    dt = x.dtype

    xz = x @ p["in_proj"].to(dt)                          # (B, S, 2di)
    xin, z = torch.split(xz, di, dim=-1)
    conv_prev = None if state is None else state["conv"]
    x_conv, conv_state = causal_conv1d(xin, p["conv_w"], p["conv_b"], conv_prev)
    x_conv = F.silu(x_conv)

    a, bx, Cc = _mamba1_coeffs(p, cfg, x_conv, dt)
    h = (torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
         if state is None else state["ssm"].float())
    scan = ops.selective_scan if impl == "kernel" else _ss.plain
    y = torch.empty((B, S, di), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        c1 = min(c0 + chunk, S)
        hs = scan(a[:, c0:c1], bx[:, c0:c1], h)           # (B, Q, di, N)
        y[:, c0:c1] = torch.einsum("bsdn,bsn->bsd", hs, Cc[:, c0:c1])
        h = hs[:, -1]
    del a, bx                     # (B, S, di, N) fp32 each: free them now
    y = y + x_conv.float() * p["D"].float()
    y = (y * F.silu(z.float())).to(dt)
    out = y @ p["out_proj"].to(dt)
    return out, {"conv": conv_state, "ssm": h}


def mamba1_decode(
    p: Dict[str, Any],
    cfg: ModelConfig,
    x: torch.Tensor,                      # (B, 1, d)
    state: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One step of the recurrence against the carried state."""
    dt = x.dtype
    xz = x @ p["in_proj"].to(dt)
    xin, z = torch.split(xz, cfg.d_inner, dim=-1)
    x_conv, conv_state = causal_conv1d(xin, p["conv_w"], p["conv_b"],
                                       state["conv"])
    x_conv = F.silu(x_conv)
    a, bx, Cc = _mamba1_coeffs(p, cfg, x_conv, dt)
    h = state["ssm"].float() * a[:, 0] + bx[:, 0]
    y = torch.einsum("bdn,bn->bd", h, Cc[:, 0])[:, None]
    y = y + x_conv.float() * p["D"].float()
    y = (y * F.silu(z.float())).to(dt)
    return y @ p["out_proj"].to(dt), {"conv": conv_state, "ssm": h}


def mamba1_state_shapes(cfg: ModelConfig, batch: int) -> Dict[str, tuple]:
    return {
        "conv": (batch, cfg.ssm_conv - 1, cfg.d_inner),
        "ssm": (batch, cfg.d_inner, cfg.ssm_state),
    }
