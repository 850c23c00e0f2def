"""Attention: GQA / sliding-window / prefix-LM, prefill + decode paths
(counterpart of ``repro.models.attention``).

Three compute paths, chosen by ``impl``:

* ``"kernel"`` (default) goes through ``repro_torch.kernels.ops``: the
  hand-written CUDA kernels for CUDA tensors, their plain versions for CPU
  tensors.  The kernels have no backward: their wrappers refuse inputs
  that need a gradient.
* ``"plain"`` runs the kernels' plain PyTorch versions on any device (fp32
  softmax and products, as in the kernels); ``chip_smoke.py`` holds the
  kernel path against it on the card.
* ``"blockwise"`` is the reference's default and its train path:
  ``blockwise_attention`` in full mode (online softmax over Q and KV
  blocks in torch ops, which autograd differentiates) and
  ``decode_attention`` in decode mode.

``naive_attention`` and ``decode_attention`` are the reference's model-level
oracles, kept for parity with it.

The KV cache is preallocated and written in place: the reference's
``dynamic_update_slice`` (which returns a new array) becomes a slice
assignment (prefill) or an ``index_copy_`` at the device length (decode)
into the cache tensors, and the returned cache is the same dict.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import ops
from repro_torch.models.base import ParamSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm, rmsnorm_spec, rope_cos_sin, rotate

NEG_INF = -1e30
IMPLS = ("kernel", "plain", "blockwise")


# ---------------------------------------------------------------------------
# Parameter blueprint
# ---------------------------------------------------------------------------


def attention_blueprint(cfg: ModelConfig) -> Dict[str, Any]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    bp: Dict[str, Any] = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        bp["bq"] = ParamSpec((h, hd), ("heads", "head_dim"), "zeros")
        bp["bk"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"), "zeros")
        bp["bv"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"), "zeros")
    if cfg.qk_norm:
        bp["q_norm"] = rmsnorm_spec(hd, "head_dim")
        bp["k_norm"] = rmsnorm_spec(hd, "head_dim")
    return bp


# ---------------------------------------------------------------------------
# Naive O(S^2) oracles
# ---------------------------------------------------------------------------


_PAD_POS = 2**31 - 2   # sentinel for padded kv slots


def _pair_mask(
    q_pos: torch.Tensor,     # (Sq,)
    kv_pos: torch.Tensor,    # (Skv,)
    *,
    causal: bool,
    window: Optional[int],
    prefix_len: int,
) -> torch.Tensor:
    """(Sq, Skv) boolean mask. prefix_len>0 = prefix-LM bidirectional zone.
    Padded KV slots (position == sentinel) are always masked."""
    m = (kv_pos[None, :] < _PAD_POS).expand(q_pos.shape[0], kv_pos.shape[0])
    if causal:
        c = q_pos[:, None] >= kv_pos[None, :]
        if prefix_len:
            c = c | (kv_pos[None, :] < prefix_len)
        m = m & c
    if window is not None:
        m = m & (q_pos[:, None] - kv_pos[None, :] < window)
    return m


def naive_attention(
    q: torch.Tensor,         # (B, Sq, H, D)
    k: torch.Tensor,         # (B, Skv, Kv, D)
    v: torch.Tensor,         # (B, Skv, Kv, D)
    *,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    prefix_len: int = 0,
    kv_valid: Optional[torch.Tensor] = None,   # (B, Skv) extra validity
) -> torch.Tensor:
    B, Sq, H, D = q.shape
    Kv = k.shape[2]
    G = H // Kv
    qg = q.reshape(B, Sq, Kv, G, D)
    scores = torch.einsum(
        "bqkgd,bmkd->bkgqm", qg.float(), k.float()
    ) / math.sqrt(D)
    mask = _pair_mask(
        q_pos, kv_pos, causal=causal, window=window, prefix_len=prefix_len
    )
    if kv_valid is not None:
        mask = mask[None] & kv_valid.bool()[:, None, :]
        mask = mask[:, None, None]          # (B,1,1,Sq,Skv)
    else:
        mask = mask[None, None, None]
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqm,bmkd->bqkgd", w.to(v.dtype), v)
    return out.reshape(B, Sq, H, D)


def decode_attention(
    q: torch.Tensor,         # (B, 1, H, D)
    k_cache: torch.Tensor,   # (B, S_cache, Kv, D) — RoPE already applied
    v_cache: torch.Tensor,
    *,
    kv_valid: torch.Tensor,  # (B, S_cache) bool — slot validity
) -> torch.Tensor:
    if type(q).__name__ == "DTensor":       # a mesh: each device's heads
        return ops.attention_on_mesh(
            lambda q, k, v, valid: decode_attention(q, k, v, kv_valid=valid),
            (q, k_cache, v_cache, kv_valid))
    B, _, H, D = q.shape
    Kv = k_cache.shape[2]
    G = H // Kv
    qg = q.reshape(B, Kv, G, D).float()
    s = torch.einsum("bkgd,bmkd->bkgm", qg, k_cache.float()) / math.sqrt(D)
    s = torch.where(kv_valid.bool()[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgm,bmkd->bkgd", w, v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Blockwise (memory-efficient) attention: the reference's train path
# ---------------------------------------------------------------------------


def blockwise_attention(
    q: torch.Tensor,         # (B, Sq, H, D)
    k: torch.Tensor,         # (B, Skv, Kv, D)
    v: torch.Tensor,
    *,
    q_pos: torch.Tensor,     # (Sq,) int
    kv_pos: torch.Tensor,    # (Skv,)
    causal: bool = True,
    window: Optional[int] = None,
    prefix_len: int = 0,
    q_block: int = 512,
    kv_block: int = 1024,
    causal_split: int = 2,   # triangle-decomposition depth (0 = off)
) -> torch.Tensor:
    """Online-softmax attention over Q and KV blocks, O(q_block x
    kv_block) live scores, in torch ops that autograd differentiates.

    Causal triangle decomposition (``causal_split`` > 0, as the
    reference): the lower-left quarter of a causal S x S square is an
    unmasked rectangle, so the sequence is halved, the rectangle and the
    lower-right triangle are attended apart and merged exactly through
    their (acc, m, l) states, and the upper-left triangle recurses.

    The reference visits, under a sliding window, only the KV blocks a Q
    block's window can reach; its block list is clipped at 0 and then
    repeats block 0 (counted two or more times when the window spans fewer
    blocks than the sequence).  Here every KV block is visited and the
    mask decides, which is exact in every case and O(S^2) in work.

    On a mesh (DTensors, the dry run's) each device attends its own rows
    and heads (``ops.attention_on_mesh``)."""
    if type(q).__name__ == "DTensor":
        return ops.attention_on_mesh(
            blockwise_attention, (q, k, v), q_pos=q_pos, kv_pos=kv_pos,
            causal=causal, window=window, prefix_len=prefix_len,
            q_block=q_block, kv_block=kv_block, causal_split=causal_split)
    S = q.shape[1]
    if (
        causal_split > 0
        and causal
        and window is None
        and S == k.shape[1]
        and S >= 4 * q_block
        and S % 2 == 0
        and prefix_len <= S // 2     # prefix-LM: the zone in the top half
    ):
        h = S // 2
        blocks = dict(q_block=q_block, kv_block=kv_block)
        top = blockwise_attention(
            q[:, :h], k[:, :h], v[:, :h], q_pos=q_pos[:h], kv_pos=kv_pos[:h],
            causal=True, prefix_len=prefix_len, causal_split=causal_split - 1,
            **blocks)
        # every q >= h attends every kv < h (under prefix-LM too): dense
        acc_l, m_l, l_l = _attend_raw(
            q[:, h:], k[:, :h], v[:, :h], q_pos=q_pos[h:], kv_pos=kv_pos[:h],
            causal=False, window=None, prefix_len=0, **blocks)
        acc_r, m_r, l_r = _attend_raw(
            q[:, h:], k[:, h:], v[:, h:], q_pos=q_pos[h:], kv_pos=kv_pos[h:],
            causal=True, window=None, prefix_len=0, **blocks)
        m = torch.maximum(m_l, m_r)
        wl, wr = torch.exp(m_l - m), torch.exp(m_r - m)
        l = torch.clamp(l_l * wl + l_r * wr, min=1e-20)
        acc = acc_l * wl[..., None] + acc_r * wr[..., None]
        B, _, Kv, G, D = acc.shape
        bottom = (acc / l[..., None]).reshape(B, S - h, Kv * G, D).to(q.dtype)
        return torch.cat([top, bottom], dim=1)
    acc, m, l = _attend_raw(
        q, k, v, q_pos=q_pos, kv_pos=kv_pos, causal=causal, window=window,
        prefix_len=prefix_len, q_block=q_block, kv_block=kv_block)
    B, Sq, Kv, G, D = acc.shape
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.reshape(B, Sq, Kv * G, D).to(q.dtype)


def _attend_raw(
    q: torch.Tensor,         # (B, Sq, H, D)
    k: torch.Tensor,         # (B, Skv, Kv, D)
    v: torch.Tensor,
    *,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    causal: bool,
    window: Optional[int],
    prefix_len: int,
    q_block: int,
    kv_block: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unnormalised online-softmax attention, fp32: (acc (B, Sq, Kv, G,
    D), m (B, Sq, Kv, G), l (B, Sq, Kv, G)), so that results over disjoint
    KV ranges merge exactly.  The reference pads Q and KV to whole blocks
    and masks the padded KV slots; here the last block of each is its true
    length, which adds the same nothing."""
    B, Sq, H, D = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    scale = 1.0 / math.sqrt(D)
    q_block, kv_block = min(q_block, Sq), min(kv_block, Skv)
    qf = q.reshape(B, Sq, Kv, G, D).float()
    kf, vf = k.float(), v.float()
    accs, ms, ls = [], [], []
    for q0 in range(0, Sq, q_block):
        q1 = min(q0 + q_block, Sq)
        qblk, qpos_i = qf[:, q0:q1], q_pos[q0:q1]
        m = torch.full((B, Kv, G, q1 - q0), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Kv, G, q1 - q0, D), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, Skv, kv_block):
            k1 = min(k0 + kv_block, Skv)
            s = torch.einsum("bqkgd,bmkd->bkgqm", qblk, kf[:, k0:k1]) * scale
            mask = _pair_mask(qpos_i, kv_pos[k0:k1], causal=causal,
                              window=window, prefix_len=prefix_len)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqm,bmkd->bkgqd", p, vf[:, k0:k1])
            m = m_new
        accs.append(acc.permute(0, 3, 1, 2, 4))
        ms.append(m.permute(0, 3, 1, 2))
        ls.append(l.permute(0, 3, 1, 2))
    return torch.cat(accs, dim=1), torch.cat(ms, dim=1), torch.cat(ls, dim=1)


# ---------------------------------------------------------------------------
# Full attention module (projections + rope + cache management)
# ---------------------------------------------------------------------------


def decode_slot_and_mask(
    cache_len: torch.Tensor,           # () int, on the cache's device
    slots: int,
    batch: int,
    ring: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where a decode step writes its token and which slots it reads, from
    the length on the device (no host sync): the slot index, (1,) int64,
    ``len`` (``len % slots`` in a sliding-window ring), and the (B, slots)
    bool mask ``arange(slots) < min(len + 1, slots)``.  A model builds both
    once per step for all its layers.  A cache that is not a ring must hold
    fewer than ``slots`` tokens: its owner checks that on the host."""
    n = cache_len.reshape(1).long()
    slot = n % slots if ring else n
    valid = torch.arange(slots, device=n.device) < torch.clamp(n + 1, max=slots)
    return slot, valid[None].expand(batch, slots)


def write_slot(cache: torch.Tensor, slot: torch.Tensor,
               new: torch.Tensor) -> None:
    """``cache[:, slot] = new`` in place (an ``index_copy_`` at a device
    index).  A cache sharded over its slots (a DTensor under the
    ``decode_cp`` rules, the dry run's) is written context-parallel: each
    device writes the token only if the slot falls in its own range."""
    if type(cache).__name__ != "DTensor":
        cache.index_copy_(1, slot, new)
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, local = cache.device_mesh, cache.to_local()
    offset = 0
    for i, p in enumerate(cache.placements):
        if isinstance(p, Shard) and p.dim == 1:
            offset += mesh.get_local_rank(i) * local.shape[1]
    new_pl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
              for p in cache.placements]
    new_l = new.redistribute(mesh, new_pl).to_local()
    slot_l = (slot.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
              if isinstance(slot, DTensor) else slot)
    rel = slot_l - offset
    inside = (rel >= 0) & (rel < local.shape[1])
    at = rel.clamp(0, local.shape[1] - 1)
    local.index_copy_(1, at, torch.where(inside, new_l,
                                         local.index_select(1, at)))


def attention_apply(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,                   # (B, S, d_model)
    *,
    positions: torch.Tensor,           # (S,) absolute positions
    mode: str,                         # "full" | "decode"
    layer_cache: Optional[Dict[str, torch.Tensor]] = None,  # (B, slots, Kv, D)
    cache_len: Union[int, torch.Tensor, None] = None,   # tokens in the cache
    causal: bool = True,
    prefix_len: int = 0,
    impl: str = "kernel",
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    decode_at: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (output (B,S,d_model), the layer cache written in place or
    None).

    Full mode writes K/V at slots [0, S) (prefill fills an empty cache; the
    reference writes at ``positions[0]``, which prefill sets to 0).  Decode
    mode writes the new token at slot ``cache_len`` (mod the ring size under
    a sliding window), and ``positions`` must be ``[cache_len]``.

    ``cache_len`` is the length on the device, a () int tensor, as the
    model keeps it: the slot write is an ``index_copy_`` at a device index
    and the valid mask is built on the device, so a decode step waits for
    nothing and can be captured in a CUDA graph; whoever owns the cache
    checks on the host that it is not full.  A host int is taken too, and
    then checked here.  ``rope`` (cos, sin from ``rope_cos_sin``) and
    ``decode_at`` (slot and mask from ``decode_slot_and_mask``) let a model
    build them once per step for every layer; without them they are built
    here from ``positions`` and ``cache_len``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; have {IMPLS}")
    B, S, d = x.shape
    hd = cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    dt = x.dtype

    # einsum("bsd,dhk->bshk") as one matmul per projection
    q = (x @ p["wq"].to(dt).reshape(d, h * hd)).view(B, S, h, hd)
    k = (x @ p["wk"].to(dt).reshape(d, kv * hd)).view(B, S, kv, hd)
    v = (x @ p["wv"].to(dt).reshape(d, kv * hd)).view(B, S, kv, hd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope:
        if rope is None:
            rope = rope_cos_sin(positions, hd, cfg.rope_theta)
        q = rotate(q, *rope)
        k = rotate(k, *rope)

    new_cache = None
    if mode == "full":
        if impl == "kernel":
            out = ops.flash_attention(
                q, k, v, causal=causal, window=cfg.sliding_window,
                prefix_len=prefix_len,
            )
        elif impl == "blockwise":
            out = blockwise_attention(
                q, k, v, q_pos=positions, kv_pos=positions, causal=causal,
                window=cfg.sliding_window, prefix_len=prefix_len,
            )
        else:
            out = _fa.plain(
                q, k, v, causal=causal, window=cfg.sliding_window,
                prefix_len=prefix_len,
            )
        if layer_cache is not None:
            ck, cv = layer_cache["k"], layer_cache["v"]
            slots = ck.shape[1]
            if cfg.sliding_window is not None and S > slots:
                # keep the last `slots` positions, ring-aligned
                idx = positions[-slots:] % slots
                ck[:, idx] = k[:, -slots:].to(ck.dtype)
                cv[:, idx] = v[:, -slots:].to(cv.dtype)
            else:
                if S > slots:
                    raise ValueError(f"prompt of {S} tokens exceeds the "
                                     f"cache's {slots} slots")
                ck[:, :S] = k.to(ck.dtype)
                cv[:, :S] = v.to(cv.dtype)
            new_cache = layer_cache
    elif mode == "decode":
        if layer_cache is None or (cache_len is None and decode_at is None):
            raise ValueError("decode mode needs layer_cache and cache_len")
        ck, cv = layer_cache["k"], layer_cache["v"]
        slots = ck.shape[1]
        if decode_at is None:
            if isinstance(cache_len, int):
                if cfg.sliding_window is None and cache_len >= slots:
                    raise ValueError(
                        f"cache full: {cache_len} of {slots} slots used")
                cache_len = torch.tensor(cache_len, device=x.device)
            decode_at = decode_slot_and_mask(
                cache_len, slots, B, cfg.sliding_window is not None)
        slot, valid = decode_at
        write_slot(ck, slot, k.to(ck.dtype))
        write_slot(cv, slot, v.to(cv.dtype))
        if impl == "kernel":
            out = ops.flash_decode(q, ck, cv, kv_valid=valid)
        elif impl == "blockwise":
            out = decode_attention(q, ck, cv, kv_valid=valid)
        else:
            out = _fd.plain(q, ck, cv, valid)
        new_cache = layer_cache
    else:
        raise ValueError(f"unknown mode {mode!r}")

    y = out.reshape(B, S, h * hd) @ p["wo"].to(dt).reshape(h * hd, d)
    return y, new_cache
