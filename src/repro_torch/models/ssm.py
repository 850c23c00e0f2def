"""State-space sequence mixers, Mamba-1 (falcon-mamba) and Mamba-2/SSD
(zamba2) — counterpart of ``repro.models.ssm``.

Mamba-1
-------

Full-sequence processing is chunked as in the reference: the SSM state is
carried across chunks of ``chunk`` steps, and within a chunk the recurrence
h_t = a_t * h_{t-1} + b_t is the selective scan.  Two compute paths, chosen
by ``impl``:

* ``"kernel"`` (default) goes through ``repro_torch.kernels.ops``: the
  hand-written CUDA scan for CUDA tensors, its plain version for CPU tensors.
* ``"plain"`` runs the scan's plain PyTorch version on any device;
  ``chip_smoke.py`` holds the kernel path against it on the card.
* ``"blockwise"`` is the reference's ``impl="jnp"`` chunk step, its train
  path: an associative scan of the (a, b) pairs within the chunk, here a
  Hillis-Steele doubling scan in ceil(log2(chunk)) out-of-place steps,
  which autograd differentiates (the plain version's step loop writes
  through ``out=`` and has no backward; it stays the kernel's oracle).

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

Mamba-2 / SSD
-------------
The chunked SSD form of the reference: within a chunk the outputs are an
attention-like product with the decay matrix ``exp(segsum(log a))``, the
carried state adds its decayed contribution, and the state is updated once
per chunk.  The reference computes all of it in einsums outside any Pallas
kernel, so the port computes it in fp32 ``torch.einsum``/``matmul`` and
has no kernel here either.  As for Mamba-1, the last chunk runs at its true
length where the reference pads it with ``log a = 0``, ``delta = 0`` (and
zero x, B, C): padded steps decay nothing and add nothing, so the outputs
and the final state are the same.  Dtype order is the reference's: the
projections and the conv run in the activation dtype, delta, the states
and y in fp32, and the gated y is cast back before its ``rms_norm``.
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
from repro_torch.models.layers import rms_norm, rmsnorm_spec

IMPLS = ("kernel", "plain", "blockwise")


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


def doubling_scan(a: torch.Tensor, b: torch.Tensor,
                  h0: torch.Tensor) -> torch.Tensor:
    """Every h_t of h_t = a_t * h_{t-1} + b_t along axis 1 of a, b (B, Q,
    C, N), from h0 (B, C, N): the prefix compositions of the pairs (a_t,
    b_t) under (a, b) o (a', b') = (a a', b a' + b'), built by doubling
    (step d combines each t with t - d), then applied to h0.  Out of place
    throughout, so autograd differentiates it."""
    Q = a.shape[1]
    d = 1
    while d < Q:
        a, b = (torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1),
                torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1))
        d *= 2
    return b + a * h0[:, None]


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
    scan = {"kernel": ops.selective_scan, "plain": _ss.plain,
            "blockwise": doubling_scan}[impl]
    if type(a).__name__ == "DTensor":     # a mesh: each device's channels
        rows, chan = {"batch": 0}, {"batch": 0, "chan": 2}
        y, h = ops.on_mesh(_scan_chunks, (a, bx, Cc, h),
                           [chan, chan, rows, {"batch": 0, "chan": 1}],
                           [chan, {"batch": 0, "chan": 1}], scan=scan,
                           chunk=chunk)
    else:
        y, h = _scan_chunks(a, bx, Cc, h, scan=scan, chunk=chunk)
    del a, bx                     # (B, S, di, N) fp32 each: free them now
    y = y + x_conv.float() * p["D"].float()
    y = (y * F.silu(z.float())).to(dt)
    out = y @ p["out_proj"].to(dt)
    return out, {"conv": conv_state, "ssm": h}


def _scan_chunks(a, bx, Cc, h, *, scan, chunk: int):
    """The Mamba-1 recurrence over the sequence in chunks of ``chunk``
    steps, contracted with C: (y (B, S, di) fp32, the last state (B, di,
    N)).  Channels are independent.  The chunks' outputs are joined at the
    end (no preallocated buffer written in place)."""
    S = a.shape[1]
    ys = []
    for c0 in range(0, S, chunk):
        c1 = min(c0 + chunk, S)
        hs = scan(a[:, c0:c1], bx[:, c0:c1], h)           # (B, Q, di, N)
        ys.append(torch.einsum("bsdn,bsn->bsd", hs, Cc[:, c0:c1]))
        h = hs[:, -1]
    return torch.cat(ys, dim=1), h


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


# ---------------------------------------------------------------------------
# Mamba-2 / SSD (zamba2)
# ---------------------------------------------------------------------------


def mamba2_blueprint(cfg: ModelConfig) -> Dict[str, Any]:
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H = cfg.ssm_heads
    conv_dim = di + 2 * N          # conv over [x, B, C], single group
    return {
        # zxbcdt projection: [z(di), x(di), B(N), C(N), dt(H)]
        "in_proj": ParamSpec((d, 2 * di + 2 * N + H), ("embed", "ssm_inner")),
        "conv_w": ParamSpec((cfg.ssm_conv, conv_dim), ("conv", "ssm_inner")),
        "conv_b": ParamSpec((conv_dim,), ("ssm_inner",), "zeros"),
        "dt_bias": ParamSpec((H,), ("heads",), "zeros"),
        "A_log": ParamSpec((H,), ("heads",), "zeros"),
        "D": ParamSpec((H,), ("heads",), "ones"),
        "norm": rmsnorm_spec(di, "ssm_inner"),
        "out_proj": ParamSpec((di, d), ("ssm_inner", "embed")),
    }


def _segsum(loga: torch.Tensor) -> torch.Tensor:
    """Stable 'segment sum': out[..., i, j] = sum_{j<t<=i} loga[..., t],
    -inf for j > i.  loga: (..., Q) -> (..., Q, Q)."""
    Q = loga.shape[-1]
    cs = torch.cumsum(loga, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]            # sum_(j, i]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=loga.device).tril()
    return diff.masked_fill(~mask, -math.inf)


def _mamba2_project(p, cfg: ModelConfig, x: torch.Tensor, conv_prev):
    """The zxbcdt projection and the conv over [x, B, C]; returns z (act
    dtype), x per head (B, S, H, P), B and C (B, S, N) and delta (B, S, H),
    fp32, and the new conv state."""
    Bsz, S, _ = x.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    dt = x.dtype
    zxbcdt = x @ p["in_proj"].to(dt)
    z, xbc, dt_raw = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)
    xbc, conv_state = causal_conv1d(xbc, p["conv_w"], p["conv_b"], conv_prev)
    xbc = F.silu(xbc)
    xin, Bc, Cc = torch.split(xbc, [di, N, N], dim=-1)
    delta = F.softplus(dt_raw.float() + p["dt_bias"].float())   # (B, S, H)
    xh = xin.reshape(Bsz, S, H, P).float()
    return z, xh, Bc.float(), Cc.float(), delta, conv_state


def _mamba2_out(p, cfg: ModelConfig, y: torch.Tensor, xh: torch.Tensor,
                z: torch.Tensor) -> torch.Tensor:
    """y (B, S, H, P) fp32 plus the D skip, gated by silu(z), normed in the
    activation dtype and projected out."""
    Bsz, S = y.shape[:2]
    dt = z.dtype
    y = y + xh * p["D"].float()[:, None]
    y = y.reshape(Bsz, S, cfg.d_inner) * F.silu(z.float())
    y = rms_norm(y.to(dt), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"].to(dt)


def mamba2_full(
    p: Dict[str, Any],
    cfg: ModelConfig,
    x: torch.Tensor,                      # (B, S, d)
    *,
    chunk: int = 256,
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Chunked SSD (Mamba-2), single B/C group; returns (y, {"conv", "ssm"}
    final state), the SSM state (B, H, P, N) fp32."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    Bsz, S, _ = x.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_prev = None if state is None else state["conv"]
    z, xh, Bc, Cc, delta, conv_state = _mamba2_project(p, cfg, x, conv_prev)
    loga = delta * -torch.exp(p["A_log"].float())         # (B, S, H)

    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if state is None else state["ssm"].float())
    args = (xh, Bc, Cc, delta, loga, h)
    if type(xh).__name__ == "DTensor":    # a mesh: each device's heads
        rows, heads = {"batch": 0}, {"batch": 0, "heads": 2}
        y, h = ops.on_mesh(_ssd_chunks, args,
                           [heads, rows, rows, heads, heads,
                            {"batch": 0, "heads": 1}],
                           [heads, {"batch": 0, "heads": 1}], chunk=chunk)
    else:
        y, h = _ssd_chunks(*args, chunk=chunk)
    out = _mamba2_out(p, cfg, y, xh, z)
    return out, {"conv": conv_state, "ssm": h}


def _ssd_chunks(xh, Bc, Cc, delta, loga, h, *, chunk: int):
    """The chunked SSD over the sequence from state ``h``: (y (B, S, H, P),
    the last state (B, H, P, N)), fp32.  Heads are independent."""
    S = xh.shape[1]
    ys = []                       # joined at the end, as in mamba1_full
    for c0 in range(0, S, chunk):
        c1 = min(c0 + chunk, S)
        lah = loga[:, c0:c1].transpose(1, 2)               # (B, H, Q)
        xc, bc, cc = xh[:, c0:c1], Bc[:, c0:c1], Cc[:, c0:c1]
        dc = delta[:, c0:c1]                               # (B, Q, H)
        # intra-chunk: Y1[i] = sum_{j<=i} C_i.B_j L_ij dt_j x_j
        L = torch.exp(_segsum(lah))                        # (B, H, Q, Q)
        M = torch.einsum("bin,bjn->bij", cc, bc)[:, None] * L
        y_intra = torch.einsum("bhij,bjhp->bihp", M, dc[..., None] * xc)
        # inter-chunk: the carried state, decayed to each step
        cum = torch.cumsum(lah, dim=-1)                    # (B, H, Q)
        cumla = torch.exp(cum)
        y_inter = (torch.einsum("bin,bhpn->bihp", cc, h)
                   * cumla.transpose(1, 2)[..., None])
        ys.append(y_intra + y_inter)
        # state update: h' = a_tot h + sum_j (prod_{t>j} a) dt_j B_j x_j
        decay = torch.exp(
            torch.cumsum(lah.flip(-1), dim=-1).flip(-1) - lah)   # (B, H, Q)
        w = (dc * decay.transpose(1, 2))[..., None] * xc   # (B, Q, H, P)
        h = (h * cumla[..., -1, None, None]
             + torch.einsum("bjhp,bjn->bhpn", w, bc))
    return torch.cat(ys, dim=1), h


def mamba2_decode(
    p: Dict[str, Any],
    cfg: ModelConfig,
    x: torch.Tensor,                      # (B, 1, d)
    state: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One step of the SSD recurrence against the carried state."""
    z, xh, Bc, Cc, delta, conv_state = _mamba2_project(p, cfg, x,
                                                       state["conv"])
    d0 = delta[:, 0]                                       # (B, H)
    a = torch.exp(d0 * -torch.exp(p["A_log"].float()))
    x0 = xh[:, 0]                                          # (B, H, P)
    h = (state["ssm"].float() * a[..., None, None]
         + torch.einsum("bh,bn,bhp->bhpn", d0, Bc[:, 0], x0))
    y = torch.einsum("bhpn,bn->bhp", h, Cc[:, 0])[:, None]
    return _mamba2_out(p, cfg, y, xh, z), {"conv": conv_state, "ssm": h}


def mamba2_state_shapes(cfg: ModelConfig, batch: int) -> Dict[str, tuple]:
    return {
        "conv": (batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state),
        "ssm": (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
    }
