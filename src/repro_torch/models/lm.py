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
``forward``      full-sequence hidden states
``prefill``      full sequence + KV cache write, last-position logits
``decode_step``  one token per sequence against the carried cache

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

from repro_torch import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe, ssm
from repro_torch.models.base import (
    cast_params,
    init_params,
    param_count,
    param_tree,
    stack_blueprint,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
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
        impl: str = "kernel",          # attention / MoE / scan: kernel | plain
        ssm_chunk: int = 256,          # Mamba prefill: steps per chunk
        device: Any = "cuda",
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if impl not in attn.IMPLS:
            raise ValueError(f"unknown impl {impl!r}; have {attn.IMPLS}")
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        if generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device}, model on {dev}")
        self.cfg = cfg
        self.impl = impl
        self.ssm_chunk = ssm_chunk

        bp = self.blueprint()
        top = cast_params(
            init_params({k: v for k, v in bp.items() if k != "decoder"},
                        generator),
            dtype,
        )
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
    def _ffn(self, lp, h):
        """The layer's FFN: the MLP, or the MoE layer (no aux loss: the
        port serves)."""
        if self.cfg.is_moe:
            return moe.moe_apply(lp["moe"], self.cfg, h, impl=self.impl)[0]
        return mlp_apply(lp["mlp"], self.cfg, h)

    def _attn_block(self, lp, x, *, positions, mode, layer_kv, prefix_len,
                    rope, decode_at):
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
            return x + a + self._ffn(lp, h)
        x = x + a
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        return x + self._ffn(lp, h2)

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
            x = self._mamba_layer(lp, x, mode=mode, states=states, at=i,
                                  version=1)
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
            x = self._mamba_layer(lp, x, mode=mode, states=pre, at=i,
                                  version=2)
        for b, group in enumerate(self.blocks):
            layer_kv = None
            if cache is not None:
                layer_kv = {k: t[b] for k, t in cache["attn_kv"].items()}
            x = self._attn_block(
                self.shared_attn, x, positions=positions, mode=mode,
                layer_kv=layer_kv, prefix_len=prefix_len, rope=rope,
                decode_at=decode_at,
            )
            for j, lp in enumerate(group):
                x = self._mamba_layer(lp, x, mode=mode, states=blk,
                                      at=(b, j), version=2)
        return x

    def _run_stack(self, x, *, positions, mode, cache, prefix_len):
        cfg = self.cfg
        if cfg.family == "ssm":
            return self._run_ssm_stack(x, mode=mode, cache=cache)
        if cfg.family == "hybrid":
            return self._run_hybrid_stack(x, positions=positions, mode=mode,
                                          cache=cache, prefix_len=prefix_len)
        rope, decode_at = self._step_attention(x, positions, mode, cache, "kv")
        for i, lp in enumerate(self.layers):
            layer_kv = None
            if cache is not None:
                layer_kv = {"k": cache["kv"]["k"][i], "v": cache["kv"]["v"][i]}
            x = self._attn_block(
                lp, x, positions=positions, mode=mode, layer_kv=layer_kv,
                prefix_len=prefix_len, rope=rope, decode_at=decode_at,
            )
        return x

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

    def forward(
        self,
        tokens: torch.Tensor,            # (B, S)
        *,
        prefix_embed: Optional[torch.Tensor] = None,
        dtype: torch.dtype = torch.bfloat16,
    ) -> torch.Tensor:
        """Full-sequence hidden states (B, S', d) after the final norm."""
        x, prefix_len = self._embed_inputs(tokens, prefix_embed, dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        x = self._run_stack(
            x, positions=positions, mode="full", cache=None,
            prefix_len=prefix_len if self.cfg.prefix_lm else 0,
        )
        return rms_norm(x, self.final_norm, self.cfg.norm_eps)

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
        x = self._run_stack(
            x, positions=positions, mode="full", cache=cache,
            prefix_len=prefix_len if self.cfg.prefix_lm else 0,
        )
        x = rms_norm(x[:, -1:], self.final_norm, self.cfg.norm_eps)
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
        x = self._run_stack(
            x, positions=positions, mode="decode", cache=cache, prefix_len=0,
        )
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        cache["len"].add_(1)
        return self.logits(x), cache
