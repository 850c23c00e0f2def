"""TransformerLM — the decoder-only model: dense / GQA, MoE, Mamba-1 (SSM)
and zamba2's hybrid (Mamba-2 plus a shared attention block) paths
(counterpart of ``repro.models.lm``).

The reference stacks per-layer parameters and runs the layer stack as one
``lax.scan``; here the stack is a loop over an ``nn.ModuleList`` whose
entries hold one layer's parameters each, in the reference's shapes
(``attn.wq`` is (d_model, heads, head_dim), and so on).  An MoE layer holds
``moe`` in place of ``mlp``; its expert FFN follows the model's ``impl``
(the reference's model always takes its einsum path).

The hybrid model holds ``prelude[i]`` (Mamba-2 layers), ``blocks[i][j]``
(the Mamba-2 layers of super-block i) and one ``shared_attn``: the
attention block whose weights exist once and are applied at the head of
every super-block, each application with its own KV slice (weight sharing
is not cache sharing).  The reference's per-application LoRA adapters of
zamba2 are simplified away there, and here too.

Modes
-----
``forward``      full-sequence hidden states (``forward_aux``: and the
                 MoE aux loss summed over layers)
``loss``         mean next-token CE (``chunked_ce``) + the MoE aux loss
``prefill``      full sequence + KV cache write, last-position logits
``decode_step``  one token per sequence against the carried cache

Training
--------
The parameters are built frozen; ``model.requires_grad_(True)`` makes them
trainable (``repro_torch.launch.steps.build_train_step`` does).  The train
path is the reference's default, ``impl="blockwise"``: blockwise
attention, the Mamba-1 doubling scan, the einsum MoE, all in torch ops that
autograd differentiates (the kernel wrappers refuse inputs that need a
gradient).  ``remat=True`` checkpoints each layer (each Mamba-2 layer and
shared-block application of the hybrid) with
``torch.utils.checkpoint(use_reentrant=False)``, as the reference's
``jax.checkpoint`` of each scanned block.  A forward without a cache (the
loss's) adds each MoE layer's Switch aux loss, as the reference's
``forward`` does; prefill and decode drop it, as the reference does.

The cache is a dict ``{"len": (), "kv": {"k", "v"}}`` with K/V of shape
(layers, batch, slots, kv_heads, head_dim), or for the SSM family
``{"len": (), "ssm_state": {"conv", "ssm"}}`` with fp32 states of shape
(layers, batch, conv - 1, d_inner) and (layers, batch, d_inner, ssm_state).
The hybrid cache holds ``prelude_state`` (prelude, batch, ...) when there
is a prelude, ``block_state`` (blocks, every - 1, batch, ...) with the
Mamba-2 states (conv over [x, B, C], ssm (heads, head_dim, state)), and
``attn_kv`` {"k", "v"} (blocks, batch, slots, kv_heads, head_dim).
``len`` is an int32 tensor of shape () on the model's device, as in the
reference.  All of it is written in place and never replaced: ``prefill``
sets the length on the device, ``decode_step`` builds its positions, cache
slot and valid mask from it and advances it with ``add_``, so a decode step
waits for nothing on the host and a CUDA graph captured on a cache replays
on whatever the cache holds (``repro_torch.launch.steps``).  The host's
bookkeeping (is the cache empty, is it full) belongs to the cache's owner,
who knows the length without asking the device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe, ssm
from repro_torch.models.base import (
    draw_params,
    param_count,
    param_tree,
    stack_blueprint,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    remat_context,
    residual_layout,
    embed_spec,
    embed_tokens,
    logits_from_hidden,
    mlp_apply,
    mlp_blueprint,
    rms_norm,
    rmsnorm_spec,
    rope_cos_sin,
    unembed_spec,
)

def layer_blueprint(cfg: ModelConfig) -> Dict[str, Any]:
    """One decoder layer's parameters (dense / GQA, MoE or Mamba-1)."""
    bp: Dict[str, Any] = {"ln1": rmsnorm_spec(cfg.d_model)}
    if cfg.family == "ssm":
        bp["mixer"] = ssm.mamba1_blueprint(cfg)
        return bp
    bp["attn"] = attn.attention_blueprint(cfg)
    if not cfg.parallel_block:
        bp["ln2"] = rmsnorm_spec(cfg.d_model)
    if cfg.is_moe:
        bp["moe"] = moe.moe_blueprint(cfg)
    else:
        bp["mlp"] = mlp_blueprint(cfg)
    return bp


def mamba2_layer_blueprint(cfg: ModelConfig) -> Dict[str, Any]:
    """One Mamba-2 layer of the hybrid stack."""
    return {"ln1": rmsnorm_spec(cfg.d_model),
            "mixer": ssm.mamba2_blueprint(cfg)}


def shared_attn_blueprint(cfg: ModelConfig) -> Dict[str, Any]:
    """zamba2's shared attention block: attention and MLP, pre-norm."""
    return {
        "ln1": rmsnorm_spec(cfg.d_model),
        "attn": attn.attention_blueprint(cfg),
        "ln2": rmsnorm_spec(cfg.d_model),
        "mlp": mlp_blueprint(cfg),
    }


def hybrid_blueprints(cfg: ModelConfig) -> Dict[str, Any]:
    """zamba2: stacked Mamba-2 layers + ONE shared attention block."""
    m_bp = mamba2_layer_blueprint(cfg)
    n_pre = cfg.hybrid_prelude
    return {
        "prelude": stack_blueprint(m_bp, n_pre) if n_pre else {},
        "blocks": stack_blueprint(
            stack_blueprint(m_bp, cfg.hybrid_attn_every - 1),
            cfg.hybrid_blocks),
        "shared_attn": shared_attn_blueprint(cfg),
    }


def lm_blueprint(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's blueprint: per-layer leaves stacked on a leading
    'layers' axis under ``decoder`` (the hybrid family: ``prelude`` and
    ``blocks`` stacked, ``shared_attn`` once)."""
    bp: Dict[str, Any] = {"embed": embed_spec(cfg)}
    if not cfg.tie_embeddings:
        bp["unembed"] = unembed_spec(cfg)
    bp["final_norm"] = rmsnorm_spec(cfg.d_model)
    if cfg.family == "hybrid":
        bp["decoder"] = hybrid_blueprints(cfg)
    else:
        bp["decoder"] = stack_blueprint(layer_blueprint(cfg), cfg.num_layers)
    return bp


class TransformerLM(nn.Module):
    """Decoder-only LM over a ModelConfig (dense / GQA / SWA / VLM prefix,
    MoE, Mamba-1, hybrid Mamba-2 + shared attention)."""

    def __init__(
        self,
        cfg: ModelConfig,
        *,
        impl: str = "kernel",          # attention / MoE / scan: kernel | plain | blockwise
        ssm_chunk: int = 256,          # Mamba prefill: steps per chunk
        remat: bool = False,           # checkpoint each layer under grad
        device: Any = "cuda",
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if impl not in attn.IMPLS:
            raise ValueError(f"unknown impl {impl!r}; have {attn.IMPLS}")
        dev = resolve_device(device, allow_meta=True)
        if dev.type == "meta":
            generator = None             # shapes only: nothing is drawn
        elif generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        if generator is not None and generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device}, model on {dev}")
        self.cfg = cfg
        self.impl = impl
        self.ssm_chunk = ssm_chunk
        self.remat = remat

        bp = self.blueprint()
        top = draw_params({k: v for k, v in bp.items() if k != "decoder"},
                          generator, dtype)
        self.embed = nn.Parameter(top["embed"], requires_grad=False)
        self.final_norm = nn.Parameter(top["final_norm"], requires_grad=False)
        if "unembed" in top:
            self.unembed = nn.Parameter(top["unembed"], requires_grad=False)
        else:
            self.unembed = None
        if cfg.family == "hybrid":
            m_bp = mamba2_layer_blueprint(cfg)
            self.prelude = nn.ModuleList(
                param_tree(m_bp, generator, dtype)
                for _ in range(cfg.hybrid_prelude))
            self.blocks = nn.ModuleList(
                nn.ModuleList(param_tree(m_bp, generator, dtype)
                              for _ in range(cfg.hybrid_attn_every - 1))
                for _ in range(cfg.hybrid_blocks))
            self.shared_attn = param_tree(shared_attn_blueprint(cfg),
                                          generator, dtype)
        else:
            layer_bp = layer_blueprint(cfg)
            self.layers = nn.ModuleList(
                param_tree(layer_bp, generator, dtype)
                for _ in range(cfg.num_layers))

    def blueprint(self) -> Dict[str, Any]:
        return lm_blueprint(self.cfg)

    def num_params(self) -> int:
        return param_count(self.blueprint())

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ==================================================================
    # Cache
    # ==================================================================
    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
        cfg = self.cfg
        length = torch.zeros((), dtype=torch.int32, device=self.device)
        if cfg.family == "hybrid":
            # fp32 states, as in the reference; KV slots = max_len
            def states(lead):
                return {k: torch.zeros(lead + s, dtype=torch.float32,
                                       device=self.device)
                        for k, s in ssm.mamba2_state_shapes(cfg, batch).items()}

            n_blk = cfg.hybrid_blocks
            cache: Dict[str, Any] = {"len": length}
            if cfg.hybrid_prelude:
                cache["prelude_state"] = states((cfg.hybrid_prelude,))
            cache["block_state"] = states((n_blk, cfg.hybrid_attn_every - 1))
            shape = (n_blk, batch, max_len, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
            cache["attn_kv"] = {
                "k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device),
            }
            return cache
        if cfg.family == "ssm":
            # the states are fp32 whatever the activation dtype, as in the
            # reference; a bf16 conv state written here is exact
            L = cfg.num_layers
            return {
                "len": length,
                "ssm_state": {
                    k: torch.zeros((L,) + s, dtype=torch.float32,
                                   device=self.device)
                    for k, s in ssm.mamba1_state_shapes(cfg, batch).items()
                },
            }
        slots = (
            min(max_len, cfg.sliding_window)
            if cfg.sliding_window is not None
            else max_len
        )
        shape = (cfg.num_layers, batch, slots, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        return {
            "len": length,
            "kv": {
                "k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device),
            },
        }

    @staticmethod
    def reset_cache(cache: Dict[str, Any]) -> None:
        """Empty ``cache`` in place for the next prompt: length 0, K/V and
        states zero (a Mamba prefill starts from the states it finds).  The
        tensors stay the same ones, so a step captured on them still
        replays."""
        cache["len"].zero_()
        for key, group in cache.items():
            if key != "len":
                for t in group.values():
                    t.zero_()

    @staticmethod
    def cache_batch(cache: Dict[str, Any]) -> int:
        """The batch ``cache`` was made for."""
        if "ssm_state" in cache:
            return cache["ssm_state"]["ssm"].shape[1]
        return cache.get("kv", cache.get("attn_kv"))["k"].shape[1]

    def cache_capacity(self, cache: Dict[str, Any]) -> Optional[int]:
        """Tokens ``cache`` can hold, or None where it never fills (a
        sliding-window ring, a recurrent state).  A hybrid cache fills at
        its attention slots."""
        if "attn_kv" in cache:
            return cache["attn_kv"]["k"].shape[2]
        if "kv" not in cache or self.cfg.sliding_window is not None:
            return None
        return cache["kv"]["k"].shape[2]

    # ==================================================================
    # Blocks
    # ==================================================================
    def _layer(self, fn, lp, x, *args, **kwargs):
        """``fn(lp, x, *args, **kwargs)``, checkpointed under ``remat`` when
        autograd records; ``x`` in the residual layout (``residual_layout``)."""
        args = (lp, residual_layout(x)) + args
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=remat_context, **kwargs)
        return fn(*args, **kwargs)

    def _ffn(self, lp, h, aux: bool):
        """The layer's FFN, (y, aux loss or None): the MLP, or the MoE layer
        with its Switch aux loss when ``aux``."""
        if self.cfg.is_moe:
            return moe.moe_apply(lp["moe"], self.cfg, h, impl=self.impl,
                                 return_aux=aux)
        return mlp_apply(lp["mlp"], self.cfg, h), None

    def _attn_block(self, lp, x, *, positions, mode, layer_kv, prefix_len,
                    rope, decode_at, aux=False):
        """One attention layer: (x, its MoE aux loss or None)."""
        cfg = self.cfg
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _ = attn.attention_apply(
            lp["attn"], cfg, h,
            positions=positions, mode=mode, layer_cache=layer_kv,
            prefix_len=prefix_len, impl=self.impl, rope=rope,
            decode_at=decode_at,
        )
        if cfg.parallel_block:
            # command-r: attn and FFN read the SAME normed input, summed
            f, aux_l = self._ffn(lp, h, aux)
            return x + a + f, aux_l
        x = residual_layout(x + a)
        f, aux_l = self._ffn(lp, rms_norm(x, lp["ln2"], cfg.norm_eps), aux)
        return x + f, aux_l

    def _mamba_block(self, lp, x, *, mode, state, version):
        cfg = self.cfg
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if mode == "decode":
            fn = ssm.mamba1_decode if version == 1 else ssm.mamba2_decode
            y, new_state = fn(lp["mixer"], cfg, h, state)
        elif version == 1:
            y, new_state = ssm.mamba1_full(
                lp["mixer"], cfg, h, chunk=self.ssm_chunk, state=state,
                impl=self.impl,
            )
        else:
            y, new_state = ssm.mamba2_full(
                lp["mixer"], cfg, h, chunk=self.ssm_chunk, state=state)
        return x + y, new_state

    def _mamba_layer(self, lp, x, *, mode, states, at, version):
        """One Mamba layer; with cache ``states``, it reads its state at
        index ``at`` and writes the new one back in place.  Without them it
        starts from zeros, as the reference's zero states."""
        state = None if states is None else {k: v[at] for k, v in states.items()}
        x, new_state = self._mamba_block(lp, x, mode=mode, state=state,
                                         version=version)
        if state is not None:
            for k, v in state.items():
                v.copy_(new_state[k])
        return x

    def _run_ssm_stack(self, x, *, mode, cache):
        """Mamba-1 layers."""
        states = None if cache is None else cache["ssm_state"]
        for i, lp in enumerate(self.layers):
            x = self._layer(self._mamba_layer, lp, x, mode=mode, states=states,
                            at=i, version=1)
        return x

    def _step_attention(self, x, positions, mode, cache, kv_key):
        """Per-step work, once for all attention layers: the rotation at
        these positions, and in decode the new token's slot and the valid
        mask, from the device length and the slots of ``cache[kv_key]``."""
        cfg = self.cfg
        rope = (rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
                if cfg.rope else None)
        decode_at = None
        if mode == "decode":
            decode_at = attn.decode_slot_and_mask(
                cache["len"], cache[kv_key]["k"].shape[2], x.shape[0],
                cfg.sliding_window is not None)
        return rope, decode_at

    def _run_hybrid_stack(self, x, *, positions, mode, cache, prefix_len):
        """zamba2: the prelude's Mamba-2 layers, then super-blocks of the
        shared attention block (its own KV slice each) and a Mamba-2
        group."""
        rope, decode_at = self._step_attention(x, positions, mode, cache,
                                               "attn_kv")
        pre = blk = None
        if cache is not None:
            pre, blk = cache.get("prelude_state"), cache["block_state"]
        for i, lp in enumerate(self.prelude):
            x = self._layer(self._mamba_layer, lp, x, mode=mode, states=pre,
                            at=i, version=2)
        for b, group in enumerate(self.blocks):
            layer_kv = None
            if cache is not None:
                layer_kv = {k: t[b] for k, t in cache["attn_kv"].items()}
            x, _ = self._layer(
                self._attn_block, self.shared_attn, x, positions=positions,
                mode=mode, layer_kv=layer_kv, prefix_len=prefix_len,
                rope=rope, decode_at=decode_at,
            )
            for j, lp in enumerate(group):
                x = self._layer(self._mamba_layer, lp, x, mode=mode,
                                states=blk, at=(b, j), version=2)
        return x

    def _run_stack(self, x, *, positions, mode, cache, prefix_len):
        """The layer stack: (x, the MoE aux loss summed over layers, or None
        where no layer gave one: no MoE layer, or a cache)."""
        cfg = self.cfg
        aux = None
        if cfg.family == "ssm":
            return self._run_ssm_stack(x, mode=mode, cache=cache), aux
        if cfg.family == "hybrid":
            return self._run_hybrid_stack(x, positions=positions, mode=mode,
                                          cache=cache, prefix_len=prefix_len), aux
        rope, decode_at = self._step_attention(x, positions, mode, cache, "kv")
        for i, lp in enumerate(self.layers):
            layer_kv = None
            if cache is not None:
                layer_kv = {"k": cache["kv"]["k"][i], "v": cache["kv"]["v"][i]}
            x, aux_l = self._layer(
                self._attn_block, lp, x, positions=positions, mode=mode,
                layer_kv=layer_kv, prefix_len=prefix_len, rope=rope,
                decode_at=decode_at, aux=cache is None,
            )
            if aux_l is not None:
                aux = aux_l if aux is None else aux + aux_l
        return x, aux

    # ==================================================================
    # Public entry points
    # ==================================================================
    def _embed_inputs(self, tokens, prefix_embed, dtype) -> Tuple[torch.Tensor, int]:
        x = embed_tokens(self.embed, tokens, dtype)
        prefix_len = 0
        if prefix_embed is not None:
            x = torch.cat([prefix_embed.to(dtype), x], dim=1)
            prefix_len = prefix_embed.shape[1]
        return x, prefix_len

    def forward_aux(
        self,
        tokens: torch.Tensor,            # (B, S)
        *,
        prefix_embed: Optional[torch.Tensor] = None,
        dtype: torch.dtype = torch.bfloat16,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence hidden states (B, S', d) after the final norm, and
        the MoE aux loss summed over layers (the reference's ``forward``)."""
        x, prefix_len = self._embed_inputs(tokens, prefix_embed, dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        x, aux = self._run_stack(
            x, positions=positions, mode="full", cache=None,
            prefix_len=prefix_len if self.cfg.prefix_lm else 0,
        )
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return rms_norm(residual_layout(x), self.final_norm,
                        self.cfg.norm_eps), aux

    def forward(
        self,
        tokens: torch.Tensor,            # (B, S)
        *,
        prefix_embed: Optional[torch.Tensor] = None,
        dtype: torch.dtype = torch.bfloat16,
    ) -> torch.Tensor:
        """Full-sequence hidden states (B, S', d) after the final norm."""
        return self.forward_aux(tokens, prefix_embed=prefix_embed,
                                dtype=dtype)[0]

    def loss(
        self,
        tokens: torch.Tensor,            # (B, S)
        labels: torch.Tensor,            # (B, S): next-token targets
        *,
        prefix_embed: Optional[torch.Tensor] = None,
        dtype: torch.dtype = torch.bfloat16,
        ce_chunk: int = 512,
    ) -> torch.Tensor:
        """Mean next-token CE over the text positions + the MoE aux loss,
        an fp32 () tensor; the logits are computed ``ce_chunk`` positions
        at a time."""
        hidden, aux = self.forward_aux(tokens, prefix_embed=prefix_embed,
                                       dtype=dtype)
        if prefix_embed is not None:
            hidden = hidden[:, prefix_embed.shape[1]:]
        ce = chunked_ce(hidden, labels, self.cfg, embedding=self.embed,
                        unembed=self.unembed, chunk=ce_chunk)
        return ce + aux

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return logits_from_hidden(
            hidden, self.cfg, embedding=self.embed, unembed=self.unembed
        )

    def prefill(
        self,
        tokens: torch.Tensor,            # (B, S)
        cache: Dict[str, Any],
        *,
        prefix_embed: Optional[torch.Tensor] = None,
        dtype: torch.dtype = torch.bfloat16,
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Process the prompt, fill the cache in place, return the
        last-position logits (B, 1, V) and the cache.  The cache must be
        empty (fresh from ``init_cache`` or emptied by ``reset_cache``):
        its owner knows that on the host, and asking the device would
        wait for it."""
        x, prefix_len = self._embed_inputs(tokens, prefix_embed, dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _ = self._run_stack(
            x, positions=positions, mode="full", cache=cache,
            prefix_len=prefix_len if self.cfg.prefix_lm else 0,
        )
        x = rms_norm(residual_layout(x[:, -1:]), self.final_norm,
                     self.cfg.norm_eps)
        cache["len"].fill_(positions.shape[0])
        return self.logits(x), cache

    def decode_step(
        self,
        tokens: torch.Tensor,            # (B, 1)
        cache: Dict[str, Any],
        *,
        dtype: torch.dtype = torch.bfloat16,
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One decode step: next-token logits (B, 1, V) and the cache,
        updated in place.  The position is the device length, which the
        step advances in place at its end; nothing waits for the device."""
        x = embed_tokens(self.embed, tokens, dtype)
        positions = cache["len"].reshape(1)
        x, _ = self._run_stack(
            x, positions=positions, mode="decode", cache=cache, prefix_len=0,
        )
        x = rms_norm(residual_layout(x), self.final_norm, self.cfg.norm_eps)
        cache["len"].add_(1)
        return self.logits(x), cache


# ---------------------------------------------------------------------------
# Chunked cross-entropy
# ---------------------------------------------------------------------------


def label_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]``: a gather along the vocabulary.  Logits
    sharded over the vocabulary (a DTensor on a mesh, the dry run's) are
    picked vocabulary-parallel: each shard gathers the labels that fall in
    its slice, zeros elsewhere, and the shards' sum is the result
    (``Partial``), as a sharded one-hot product would give."""
    if type(logits).__name__ != "DTensor":
        return logits.gather(-1, labels[..., None].long())[..., 0]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    vdim, mesh = logits.dim() - 1, logits.device_mesh
    if any(isinstance(p, Partial) for p in logits.placements):
        logits = logits.redistribute(mesh, [
            Replicate() if isinstance(p, Partial) else p
            for p in logits.placements])
    local = logits.to_local()
    lab_pl, out_pl, offset = [], [], 0
    for i, p in enumerate(logits.placements):
        if isinstance(p, Shard) and p.dim == vdim:
            offset += mesh.get_local_rank(i) * local.shape[-1]
            lab_pl.append(Replicate())
            out_pl.append(Partial())
        else:
            lab_pl.append(p)
            out_pl.append(p)
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    rel = labels.redistribute(mesh, lab_pl).to_local().long() - offset
    inside = (rel >= 0) & (rel < local.shape[-1])
    picked = local.gather(-1, rel.clamp(0, local.shape[-1] - 1)[..., None])
    return DTensor.from_local(torch.where(inside, picked[..., 0], 0.0), mesh,
                              out_pl, run_check=False)


def chunked_ce(
    hidden: torch.Tensor,     # (B, S, d)
    labels: torch.Tensor,     # (B, S)
    cfg: ModelConfig,
    *,
    embedding: Optional[torch.Tensor],
    unembed: Optional[torch.Tensor],
    chunk: int = 512,
) -> torch.Tensor:
    """Mean next-token CE without materialising (B, S, V): the logits of
    ``chunk`` positions at a time, their fp32 logsumexp less the label's
    logit (a gather, where the reference takes a one-hot product).  Under
    autograd each chunk is checkpointed, so its logits are recomputed in
    the backward pass instead of kept.

    The reference pads S to a whole number of chunks and counts the padded
    positions' CE (zero hidden, label 0: log V each) in the mean over
    B x S; here the last chunk is its true length, so the mean is over the
    real positions only.  The two agree whenever ``chunk`` divides S or
    exceeds it."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)

    def part(h, lab):
        logits = logits_from_hidden(h, cfg, embedding=embedding,
                                    unembed=unembed).float()
        lse = torch.logsumexp(logits, dim=-1)
        return (lse - label_logits(logits, lab)).sum()

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, chunk):
        h, lab = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        total = total + (checkpoint(part, h, lab, use_reentrant=False,
                                    context_fn=remat_context)
                         if torch.is_grad_enabled() else part(h, lab))
    return total / (B * S)
