"""Mixture-of-Experts layer (phi3.5-moe 16e/top-2, qwen3-moe 128e/top-8),
counterpart of ``repro.models.moe``.

GShard/Switch-style capacity-based dispatch with static shapes: per expert
capacity ``C = ceil(tokens * top_k / E * capacity_factor)``; an overflowing
(token, k) pair drops its contribution from that expert (its other experts
still fire).  The expert FFN runs as grouped matmuls over the expert axis
(``repro_torch.kernels.ops.moe_ffn``):

* ``impl="kernel"`` (default) goes through ``ops.moe_gmm``: the hand-written
  CUDA kernel for CUDA tensors, its plain version for CPU tensors.
* ``impl="plain"`` runs the same composition through the plain version on
  any device; ``chip_smoke.py`` holds the kernel path against it on the card.
* ``impl="blockwise"`` is the reference model's path, the train path: the
  expert FFN as batched einsums over the expert axis in the activation
  dtype, every expert row computed, which autograd differentiates.

The reference's model never passes ``impl`` to its ``moe_apply`` and so
always takes the einsum path; the reference's kernel path
(``impl="pallas"``) casts ``wi`` and ``wo`` but not ``wg`` to the activation
dtype.  The port casts all three, as the einsum path does.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.base import ParamSpec, dense_spec
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import activation

IMPLS = ("kernel", "plain", "blockwise")


def moe_blueprint(cfg: ModelConfig) -> Dict[str, Any]:
    d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.num_experts
    bp: Dict[str, Any] = {
        "router": dense_spec(d, e, "embed", None),
        "wi": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp")),
        "wo": ParamSpec((e, f, d), ("experts", "expert_mlp", "embed")),
    }
    if cfg.mlp_gated:
        bp["wg"] = ParamSpec((e, d, f), ("experts", "embed", "expert_mlp"))
    return bp


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = math.ceil(
        n_tokens * cfg.experts_per_token / cfg.num_experts
        * cfg.capacity_factor
    )
    return max(int(c), 1)


def route_topk(
    router_logits: torch.Tensor,   # (N, E) fp32
    top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing with softmax-renormalized combine weights: (weights
    (N, k), expert indices (N, k)), largest gate first."""
    gates = torch.softmax(router_logits, dim=-1)
    weights, idx = torch.topk(gates, top_k, dim=-1)
    weights = weights / weights.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return weights, idx


def _einsum_ffn(xe, wi, wg, wo, act: str) -> torch.Tensor:
    """The reference's einsum expert FFN: h = x @ wi, h = act(x @ wg) * h
    (or act(h) without a gate), then h @ wo, per expert."""
    a = activation(act)
    h = torch.einsum("ecd,edf->ecf", xe, wi)
    h = a(torch.einsum("ecd,edf->ecf", xe, wg)) * h if wg is not None else a(h)
    return torch.einsum("ecf,efd->ecd", h, wo)


def _chunks_on_mesh(p, cfg: ModelConfig, x, *, impl: str, return_aux: bool,
                    chunk_tokens: int):
    """``moe_apply`` of a chunked batch on a mesh (DTensors, the dry run's),
    expert-parallel: each device routes its own rows' chunks (a chunk of
    ``chunk_tokens`` tokens lies within one device's rows, so routing and
    capacity are the chunk's own, as without a mesh) over every expert,
    with the router gathered whole, and runs only the experts it holds; y
    is the devices' sum over the expert axis (``Partial``), aux the mean
    over the rows' devices."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = x.device_mesh
    rows = [isinstance(pl, Shard) and pl.dim == 0 for pl in x.placements]
    x_l = x.redistribute(mesh, [Shard(0) if r else Replicate()
                                for r in rows]).to_local()
    wi = p["wi"]
    ex = [i for i, pl in enumerate(wi.placements)
          if isinstance(pl, Shard) and pl.dim == 0]
    n_loc = wi.to_local().shape[0]
    lo = sum(mesh.get_local_rank(i) for i in ex) * n_loc if ex else 0
    local = {"router": p["router"].redistribute(
        mesh, [Replicate()] * mesh.ndim).to_local()}
    for name in ("wi", "wg", "wo"):
        if name in p:
            w = p[name]
            local[name] = w.redistribute(mesh, [
                Shard(0) if i in ex else Replicate()
                for i in range(mesh.ndim)]).to_local()
    y, aux = moe_apply(local, cfg, x_l, impl=impl, return_aux=return_aux,
                       chunk_tokens=chunk_tokens, experts=(lo, lo + n_loc))
    y = DTensor.from_local(y, mesh, [
        Shard(0) if r else Partial() if i in ex else Replicate()
        for i, r in enumerate(rows)], run_check=False)
    if aux is not None:
        aux = DTensor.from_local(aux, mesh, [
            Partial("avg") if r else Replicate() for r in rows],
            run_check=False)
    return y, aux


def moe_apply(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,                 # (B, S, d)
    *,
    impl: str = "kernel",
    return_aux: bool = False,
    chunk_tokens: int = 16_384,
    experts: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Capacity-based top-k MoE, chunked over tokens.

    When the token count N exceeds ``chunk_tokens`` and is a multiple of it,
    the tokens run in equal chunks with capacity per chunk (the reference's
    ``lax.scan`` over chunks, here a loop), so the dispatch buffer stays
    O(chunk x d).  Returns (y, aux_loss or None); aux is the Switch
    load-balancing loss.  ``experts=(lo, hi)`` holds only those experts'
    weights (``p``'s expert leaves are their slices): tokens routed
    elsewhere add nothing, so y is this slice's share of the sum."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; have {IMPLS}")
    B, S, d = x.shape
    N = B * S
    if N > chunk_tokens and N % chunk_tokens == 0 and type(x).__name__ == "DTensor":
        return _chunks_on_mesh(p, cfg, x, impl=impl, return_aux=return_aux,
                               chunk_tokens=chunk_tokens)
    if N > chunk_tokens and N % chunk_tokens == 0:
        n_chunks = N // chunk_tokens
        ys, aux_sum = [], torch.zeros((), dtype=torch.float32, device=x.device)
        for xc in x.reshape(n_chunks, 1, chunk_tokens, d):
            y, aux = moe_apply(p, cfg, xc, impl=impl, return_aux=return_aux,
                               chunk_tokens=chunk_tokens, experts=experts)
            ys.append(y)
            if aux is not None:
                aux_sum = aux_sum + aux
        y = torch.cat(ys, dim=0).reshape(B, S, d)
        return (y, aux_sum / n_chunks) if return_aux else (y, None)
    E, k = cfg.num_experts, cfg.experts_per_token
    C = _capacity(cfg, N)
    dt = x.dtype
    lo, hi = experts if experts is not None else (0, E)

    xf = x.reshape(N, d)
    router_logits = xf.float() @ p["router"].float()
    weights, expert_idx = route_topk(router_logits, k)    # (N, k)

    # ---- capacity assignment -------------------------------------------
    # position of each (token, k) in its expert's queue, token-major then k:
    # each expert's running count, read at the pair's own expert.  The count
    # runs along the last axis: along the first, a (7800, 128) scan (S = 975,
    # top-8 of 128) took 1.5 ms on an H100, a fifth of the prefill.
    onehot = F.one_hot(expert_idx, E)                      # (N, k, E)
    expert_flat = expert_idx.reshape(N * k)
    counts = onehot.reshape(N * k, E).T.contiguous().cumsum(1)   # (E, N*k)
    pos_in_expert = counts.gather(0, expert_flat[None])[0] - 1
    keep = pos_in_expert < C
    slot = torch.where(keep, pos_in_expert, C)             # C = overflow bin

    # ---- dispatch into (E, C+1, d), the overflow bin dropped -------------
    # Each kept (token, k) owns a unique slot, so a plain scatter writes it;
    # dropped pairs write zeros into their expert's overflow row, which is
    # never read.  With moe_dispatch_dtype the values take the reference's
    # round trip through the quantized wire format.
    wire_dt = (getattr(torch, cfg.moe_dispatch_dtype)
               if cfg.moe_dispatch_dtype else dt)
    if (lo, hi) != (0, E):
        # only experts [lo, hi) live here: the others' pairs go to the
        # overflow row of local expert 0 and weigh nothing in the combine
        mine = (expert_flat >= lo) & (expert_flat < hi)
        expert_flat = torch.where(mine, expert_flat - lo, 0)
        slot = torch.where(mine, slot, C)
        keep = keep & mine
    dispatch_idx = expert_flat * (C + 1) + slot            # (N*k,)
    token_idx = torch.arange(N, device=x.device)[:, None].expand(N, k).reshape(-1)
    vals = (xf[token_idx] * keep[:, None].to(dt)).to(wire_dt).to(dt)
    buf = vals.new_zeros(((hi - lo) * (C + 1), d))   # a DTensor's on a mesh
    buf[dispatch_idx] = vals
    xe = buf.view(hi - lo, C + 1, d)[:, :C]                # (E, C, d) view

    # ---- expert FFN -------------------------------------------------------
    # rows[e]: the leading rows of xe[e] that hold tokens, the capacity count
    # clamped to C, handed over on the device (no sync): the kernel reads no
    # weight of an empty expert, 120 of 128 in a qwen3-moe decode step
    wg = p["wg"].to(dt) if "wg" in p else None
    if impl == "blockwise":
        ye = _einsum_ffn(xe, p["wi"].to(dt), wg, p["wo"].to(dt), cfg.act)
    else:
        rows = counts[lo:hi, -1].clamp(max=C).to(torch.int32)
        ye = ops.moe_ffn(xe, p["wi"].to(dt), wg, p["wo"].to(dt), act=cfg.act,
                         impl=impl, rows=rows)

    # ---- combine (the same wire format on the way back) -----------------
    # The k contributions of a token are summed in a fixed order (no
    # scatter-add, whose atomics on the card add in a varying order).
    ye_flat = torch.cat([ye, ye.new_zeros((hi - lo, 1, d))], dim=1).reshape(
        (hi - lo) * (C + 1), d)
    gathered = ye_flat[dispatch_idx].to(wire_dt).to(dt)   # (N*k, d)
    w = (weights.reshape(N * k) * keep).to(dt)
    y = (gathered * w[:, None]).view(N, k, d).sum(1).reshape(B, S, d)

    if not return_aux:
        return y, None
    # Switch aux loss: E * sum_e f_e * P_e
    probs = torch.softmax(router_logits, dim=-1)           # (N, E)
    f = (onehot.sum(1) > 0).float().mean(0)                # (E,)
    pbar = probs.mean(0)
    aux = cfg.num_experts * (f * pbar).sum() * cfg.router_aux_coef
    return y, aux
