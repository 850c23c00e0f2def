"""Shared layers: norms, RoPE, activations, MLP blocks, embeddings
(counterpart of ``repro.models.layers``).

Norm and RoPE math runs in float32 and casts back to the input's dtype at
the same points as the reference.
"""

from __future__ import annotations

import contextlib

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.base import ParamSpec, dense_spec
from repro_torch.models.config import ModelConfig

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_spec(dim: int, axis: str = "embed") -> ParamSpec:
    return ParamSpec((dim,), (axis,), "ones")


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dt)


def layernorm_spec(dim: int, axis: str = "embed") -> dict:
    return {
        "scale": ParamSpec((dim,), (axis,), "ones"),
        "bias": ParamSpec((dim,), (axis,), "zeros"),
    }


def layer_norm(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in float32 (biased variance, as the
    reference), cast back to the input's dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), p["scale"].float(),
                     p["bias"].float(), eps)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_cos_sin(
    positions: torch.Tensor,     # (S,) or (B, S)
    head_dim: int,
    theta: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rotation ``apply_rope`` applies at ``positions``: cos and sin of
    shape (B|1, S, 1, head_dim // 2), fp32.  A model computes them once per
    step and hands them to every layer."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=positions.device) / half
    freq = 1.0 / (theta ** exponent)
    ang = positions[..., None].float() * freq     # (S,half) / (B,S,half)
    if ang.dim() == 2:
        ang = ang[None]                            # (1, S, half)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The rotation of ``apply_rope`` by precomputed ``rope_cos_sin``."""
    if x.dim() != 4:
        raise ValueError(f"apply_rope expects (B,S,H,D), got {tuple(x.shape)}")
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(
    x: torch.Tensor,             # (B, S, H, D)
    positions: torch.Tensor,     # (S,) or (B, S)
    theta: float,
) -> torch.Tensor:
    """Rotary position embedding on the trailing head_dim."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# Activations & MLP
# ---------------------------------------------------------------------------


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def mlp_blueprint(cfg: ModelConfig, d_ff: Optional[int] = None,
                  hidden_axis: str = "mlp") -> dict:
    """SwiGLU (silu) or plain 2-matrix MLP (gelu)."""
    d, f = cfg.d_model, d_ff if d_ff is not None else cfg.d_ff
    bp = {
        "wi": dense_spec(d, f, "embed", hidden_axis),
        "wo": dense_spec(f, d, hidden_axis, "embed"),
    }
    if cfg.mlp_gated:
        bp["wg"] = dense_spec(d, f, "embed", hidden_axis)
    return bp


def mlp_apply(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    act = activation(cfg.act)
    h = x @ p["wi"].to(x.dtype)
    if "wg" in p:                       # gated (SwiGLU / GeGLU)
        h = act(x @ p["wg"].to(x.dtype)) * h
    else:
        h = act(h)
    return h @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_spec(cfg: ModelConfig) -> ParamSpec:
    # normal(0.02): with tied unembedding, unit-normal embeddings would put
    # init logits at std ~ sqrt(d); 0.02 gives the standard ln(V) init loss.
    return ParamSpec(
        (cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), "embed",
        scale=0.02,
    )


def unembed_spec(cfg: ModelConfig) -> ParamSpec:
    return ParamSpec(
        (cfg.d_model, cfg.padded_vocab), ("embed", "vocab"), "normal"
    )


def remat_context():
    """``context_fn`` of a checkpointed layer: its recompute, which runs
    inside the backward pass, runs under the torch-function modes that were
    active at its forward (none on the train path; the dry run's
    ``ReplicateOnRefusal`` on a mesh), so both passes dispatch alike."""
    modes = list(torch.overrides._get_current_function_mode_stack())

    @contextlib.contextmanager
    def again():
        with contextlib.ExitStack() as stack:
            for mode in modes:
                stack.enter_context(mode)
            yield

    return contextlib.nullcontext(), again()


def residual_layout(x: torch.Tensor) -> torch.Tensor:
    """The residual stream as it enters a layer: a plain tensor as it is; on
    a mesh (a DTensor, the dry run's) rows over the data axes and the
    model dimension whole on every tensor-parallel device ("batch", "seq",
    "act_embed"), as Megatron keeps it.  DTensor would otherwise carry the
    partial sums of a row-parallel product (or of the vocabulary-parallel
    embedding) into the next projections and gather their weights whole."""
    if type(x).__name__ != "DTensor":
        return x
    from repro_torch.distributed.sharding import constrain

    return constrain(x, "batch", "seq", "act_embed")


def embed_tokens(embedding: torch.Tensor, tokens: torch.Tensor,
                 dtype: Any) -> torch.Tensor:
    """Gather then cast: the same values as the reference's cast-then-gather
    without casting the whole table.  On a mesh (a DTensor table sharded
    over the vocabulary), a table that takes no gradient is looked up by
    ``F.embedding``, for which DTensor looks up each device's shard and
    sums (its rowwise rule) into the residual layout at once, where
    indexing gathers the whole table to every device (torch 2.11's DTensor
    refuses to add the lookup's masked partial sum to a replicated tensor,
    whisper's positions); a trained table keeps indexing, since DTensor's
    embedding backward does not take the partial-sum gradient that rule
    leaves."""
    if type(embedding).__name__ == "DTensor" and not embedding.requires_grad:
        return residual_layout(F.embedding(tokens, embedding)).to(dtype)
    return embedding[tokens].to(dtype)


def logits_from_hidden(
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    embedding: Optional[torch.Tensor] = None,
    unembed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Project hidden states to (padded) vocab logits; padding masked."""
    if cfg.tie_embeddings:
        if embedding is None:
            raise ValueError("tied embeddings need the embedding table")
        logits = x @ embedding.to(x.dtype).T
    else:
        if unembed is None:
            raise ValueError("untied embeddings need the unembed matrix")
        logits = x @ unembed.to(x.dtype)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    if cfg.padded_vocab != cfg.vocab_size:
        pad = cfg.padded_vocab - cfg.vocab_size
        mask = torch.cat([
            torch.zeros(cfg.vocab_size, dtype=logits.dtype, device=logits.device),
            torch.full((pad,), torch.finfo(logits.dtype).min,
                       dtype=logits.dtype, device=logits.device),
        ])
        logits = logits + mask
    return logits
