"""EncDecLM — the Whisper-style encoder-decoder (counterpart of
``repro.models.whisper``).

The audio frontend is a stub, as in the reference: a request brings its
precomputed frame embeddings (B, S_enc, d_model).  The backbone is the
reference's: LayerNorm, gelu MLPs, absolute sinusoidal positions (no RoPE),
bidirectional encoder self-attention, causal decoder self-attention with a
KV cache, and per-layer cross-attention whose K/V are computed once at
prefill and cached read-only.

Attention runs through the same kernels as the decoder-only models:
``flash_attention`` for the encoder (non-causal), the decoder's prompt
(causal) and the prompt's cross-attention (non-causal, Sq != Skv);
``flash_decode`` for the decoder's self-attention and its cross-attention
over a fully valid (B, S_enc) mask.  The reference computes the cross
forms with ``blockwise_attention`` and ``decode_attention``, the plain
functions those kernels replace.

The parameters follow the reference's ``blueprint()``: ``embed``,
``encoder.<i>`` (``ln1``, ``attn``, ``ln2``, ``mlp``), ``enc_norm``,
``decoder.<i>`` (``ln1``, ``self_attn``, ``ln_x``, ``cross_attn``, ``ln2``,
``mlp``), ``dec_norm``; the cross-attention has no biases.

Under ``impl="blockwise"`` (the reference's default and its train path)
the encoder, the decoder's self-attention and the prompt's cross-attention
run through ``blockwise_attention`` and decode through
``decode_attention``, in torch ops that autograd differentiates.
``loss`` is the reference's teacher-forced seq2seq CE: encode, the decoder
stack without a cache (each layer's cross K/V computed from the encoder's
output), ``dec_norm`` and ``chunked_ce`` with the tied embedding;
``remat=True`` checkpoints each encoder and decoder layer under autograd.

The cache is ``{"len", "kv": {"k", "v"}, "cross_k", "cross_v",
"cross_valid"}``: ``len`` a () int32 on the model's device, K/V of shape
(layers, batch, slots, kv_heads, head_dim), cross K/V of shape (layers,
batch, S_enc, kv_heads, head_dim) and the all-true (batch, S_enc) mask that
decode's cross-attention reads, made once with the cache.  Prefill writes
the cross K/V into the cache's tensors (``copy_``), never rebinding them,
so a serve step captured on the cache reads what the last prefill wrote.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models.base import (
    ParamSpec,
    draw_params,
    param_count,
    param_tree,
    stack_blueprint,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import chunked_ce
from repro_torch.models.layers import (
    remat_context,
    residual_layout,
    embed_spec,
    embed_tokens,
    layer_norm,
    layernorm_spec,
    logits_from_hidden,
    mlp_apply,
    mlp_blueprint,
)


def sinusoid_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """The sinusoidal embedding (n, d), float32, at ``positions`` (n,): sin
    then cos of pos / 10000^(2i / d), the reference's table rows."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=positions.device)
    ang = positions.float()[:, None] / torch.pow(10_000.0, 2 * dim / d)[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_positions(n: int, d: int, device: Any = "cpu") -> torch.Tensor:
    """The reference's (n, d) float32 position table."""
    return sinusoid_at(torch.arange(n, device=device), d)


def xattn_blueprint(cfg: ModelConfig) -> Dict[str, Any]:
    """Cross-attention projections: no biases, no norms."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed")),
    }


def enc_layer_blueprint(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "ln1": layernorm_spec(cfg.d_model),
        "attn": attn.attention_blueprint(cfg),
        "ln2": layernorm_spec(cfg.d_model),
        "mlp": mlp_blueprint(cfg),
    }


def dec_layer_blueprint(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "ln1": layernorm_spec(cfg.d_model),
        "self_attn": attn.attention_blueprint(cfg),
        "ln_x": layernorm_spec(cfg.d_model),
        "cross_attn": xattn_blueprint(cfg),
        "ln2": layernorm_spec(cfg.d_model),
        "mlp": mlp_blueprint(cfg),
    }


def encdec_blueprint(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's blueprint, per-layer leaves stacked."""
    return {
        "embed": embed_spec(cfg),
        "encoder": stack_blueprint(enc_layer_blueprint(cfg), cfg.encoder_layers),
        "enc_norm": layernorm_spec(cfg.d_model),
        "decoder": stack_blueprint(dec_layer_blueprint(cfg), cfg.num_layers),
        "dec_norm": layernorm_spec(cfg.d_model),
    }


class EncDecLM(nn.Module):
    """Whisper-medium-style encoder-decoder over a ModelConfig."""

    def __init__(
        self,
        cfg: ModelConfig,
        *,
        impl: str = "kernel",          # attention: kernel | plain | blockwise
        remat: bool = False,           # checkpoint each layer under grad
        device: Any = "cuda",
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if not cfg.is_encdec:
            raise ValueError(f"{cfg.name} is not an encoder-decoder config")
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
        self.remat = remat

        self.embed = nn.Parameter(
            draw_params(embed_spec(cfg), generator, dtype),
            requires_grad=False)
        enc_bp, dec_bp = enc_layer_blueprint(cfg), dec_layer_blueprint(cfg)
        self.encoder = nn.ModuleList(param_tree(enc_bp, generator, dtype)
                                     for _ in range(cfg.encoder_layers))
        self.enc_norm = param_tree(layernorm_spec(cfg.d_model), generator, dtype)
        self.decoder = nn.ModuleList(param_tree(dec_bp, generator, dtype)
                                     for _ in range(cfg.num_layers))
        self.dec_norm = param_tree(layernorm_spec(cfg.d_model), generator, dtype)

    def blueprint(self) -> Dict[str, Any]:
        return encdec_blueprint(self.cfg)

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
        enc_len = cfg.frontend_seq
        dev = self.device
        L, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
        self_shape = (L, batch, max_len, kv, hd)
        cross_shape = (L, batch, enc_len, kv, hd)
        return {
            "len": torch.zeros((), dtype=torch.int32, device=dev),
            "kv": {
                "k": torch.zeros(self_shape, dtype=dtype, device=dev),
                "v": torch.zeros(self_shape, dtype=dtype, device=dev),
            },
            "cross_k": torch.zeros(cross_shape, dtype=dtype, device=dev),
            "cross_v": torch.zeros(cross_shape, dtype=dtype, device=dev),
            "cross_valid": torch.ones((batch, enc_len), dtype=torch.bool,
                                      device=dev),
        }

    @staticmethod
    def reset_cache(cache: Dict[str, Any]) -> None:
        """Empty ``cache`` in place for the next request: length 0 and self
        K/V zero.  The cross K/V are left as they are, since every prefill
        overwrites them whole; the cross mask stays all true.  The tensors
        stay the same ones, so a step captured on them still replays."""
        cache["len"].zero_()
        for t in cache["kv"].values():
            t.zero_()

    @staticmethod
    def cache_batch(cache: Dict[str, Any]) -> int:
        """The batch ``cache`` was made for."""
        return cache["kv"]["k"].shape[1]

    @staticmethod
    def cache_capacity(cache: Dict[str, Any]) -> int:
        """Decoder tokens ``cache`` can hold."""
        return cache["kv"]["k"].shape[2]

    # ==================================================================
    # Encoder and cross-attention
    # ==================================================================
    def _layer(self, fn, lp, x, *args, **kwargs):
        """``fn(lp, x, *args, **kwargs)``, checkpointed under ``remat`` when
        autograd records; ``x`` in the residual layout (``residual_layout``)."""
        args = (lp, residual_layout(x)) + args
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=remat_context, **kwargs)
        return fn(*args, **kwargs)

    def _enc_layer(self, lp, x, positions):
        cfg = self.cfg
        h = layer_norm(x, lp["ln1"], cfg.norm_eps)
        a, _ = attn.attention_apply(lp["attn"], cfg, h, positions=positions,
                                    mode="full", causal=False, impl=self.impl)
        x = x + a
        return x + mlp_apply(lp["mlp"], cfg, layer_norm(x, lp["ln2"], cfg.norm_eps))

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, S_enc, d): the stub frontend's embeddings, in the
        activation dtype.  Returns the encoder's output after ``enc_norm``."""
        cfg = self.cfg
        S = frames.shape[1]
        pos = sinusoidal_positions(S, cfg.d_model, frames.device)
        x = frames + pos.to(frames.dtype)
        positions = torch.arange(S, device=x.device)
        for lp in self.encoder:
            x = self._layer(self._enc_layer, lp, x, positions)
        return layer_norm(x, self.enc_norm, cfg.norm_eps)

    def _cross_kv(self, p, enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B, S, d = enc_out.shape
        kv, hd = self.cfg.num_kv_heads, self.cfg.resolved_head_dim
        dt = enc_out.dtype
        k = (enc_out @ p["wk"].to(dt).reshape(d, kv * hd)).view(B, S, kv, hd)
        v = (enc_out @ p["wv"].to(dt).reshape(d, kv * hd)).view(B, S, kv, hd)
        return k, v

    def _cross_attend(self, p, x: torch.Tensor, ck: torch.Tensor,
                      cv: torch.Tensor,
                      valid: Optional[torch.Tensor]) -> torch.Tensor:
        """x (B, S, d) against one layer's cross K/V (B, S_enc, Kv, D): a
        decode token (``valid``, the cache's all-true mask, given) through
        flash_decode, a prompt through non-causal flash_attention (under
        ``impl="blockwise"``: ``decode_attention``, ``blockwise_attention``,
        as the reference)."""
        cfg = self.cfg
        B, S, d = x.shape
        h, hd = cfg.num_heads, cfg.resolved_head_dim
        dt = x.dtype
        q = (x @ p["wq"].to(dt).reshape(d, h * hd)).view(B, S, h, hd)
        if self.impl == "blockwise":
            if valid is not None:
                out = attn.decode_attention(q, ck, cv, kv_valid=valid)
            else:
                out = attn.blockwise_attention(
                    q, ck, cv, q_pos=torch.arange(S, device=x.device),
                    kv_pos=torch.arange(ck.shape[1], device=x.device),
                    causal=False)
        elif valid is not None:
            out = (ops.flash_decode(q, ck, cv, kv_valid=valid)
                   if self.impl == "kernel" else _fd.plain(q, ck, cv, valid))
        else:
            out = (ops.flash_attention(q, ck, cv, causal=False)
                   if self.impl == "kernel" else _fa.plain(q, ck, cv, causal=False))
        return out.reshape(B, S, h * hd) @ p["wo"].to(dt).reshape(h * hd, d)

    # ==================================================================
    # Decoder
    # ==================================================================
    def _dec_layer(self, lp, x, *, positions, mode, layer_kv, ck, cv, valid,
                   decode_at, enc_out):
        cfg = self.cfg
        if ck is None:      # no cache: this layer's cross K/V, as the reference
            ck, cv = self._cross_kv(lp["cross_attn"], enc_out)
        h = layer_norm(x, lp["ln1"], cfg.norm_eps)
        a, _ = attn.attention_apply(
            lp["self_attn"], cfg, h, positions=positions, mode=mode,
            layer_cache=layer_kv, impl=self.impl, decode_at=decode_at)
        x = x + a
        hx = layer_norm(x, lp["ln_x"], cfg.norm_eps)
        x = x + self._cross_attend(lp["cross_attn"], hx, ck, cv, valid)
        return x + mlp_apply(lp["mlp"], cfg, layer_norm(x, lp["ln2"], cfg.norm_eps))

    def _run_decoder(self, x, *, positions, mode, cache, enc_out=None):
        """The decoder stack.  Over a cache, each layer writes its self K/V
        in place and reads its cross K/V; without one (the loss's), each
        layer computes its cross K/V from ``enc_out``."""
        decode_at, valid = None, None
        if mode == "decode":
            decode_at = attn.decode_slot_and_mask(
                cache["len"], cache["kv"]["k"].shape[2], x.shape[0], False)
            valid = cache["cross_valid"]
        for i, lp in enumerate(self.decoder):
            layer_kv = ck = cv = None
            if cache is not None:
                layer_kv = {"k": cache["kv"]["k"][i], "v": cache["kv"]["v"][i]}
                ck, cv = cache["cross_k"][i], cache["cross_v"][i]
            x = self._layer(self._dec_layer, lp, x, positions=positions,
                            mode=mode, layer_kv=layer_kv, ck=ck, cv=cv,
                            valid=valid, decode_at=decode_at, enc_out=enc_out)
        return x

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Vocabulary logits of ``dec_norm``-ed hidden states (tied
        embedding)."""
        return logits_from_hidden(hidden, self.cfg, embedding=self.embed)

    # ==================================================================
    # Public entry points
    # ==================================================================
    def _embed_dec(self, tokens, dtype) -> torch.Tensor:
        S = tokens.shape[1]
        x = embed_tokens(self.embed, tokens, dtype)
        return x + sinusoidal_positions(S, self.cfg.d_model, x.device).to(dtype)

    def loss(
        self,
        frames: torch.Tensor,            # (B, S_enc, d_model)
        tokens: torch.Tensor,            # (B, S)
        labels: torch.Tensor,            # (B, S)
        *,
        dtype: torch.dtype = torch.bfloat16,
        ce_chunk: int = 512,
    ) -> torch.Tensor:
        """Teacher-forced seq2seq CE, an fp32 () tensor."""
        enc_out = self.encode(frames.to(dtype))
        x = self._embed_dec(tokens, dtype)
        positions = torch.arange(tokens.shape[1], device=x.device)
        x = self._run_decoder(x, positions=positions, mode="full", cache=None,
                              enc_out=enc_out)
        x = layer_norm(x, self.dec_norm, self.cfg.norm_eps)
        return chunked_ce(x, labels, self.cfg, embedding=self.embed,
                          unembed=None, chunk=ce_chunk)

    def prefill(
        self,
        frames: torch.Tensor,            # (B, S_enc, d_model)
        tokens: torch.Tensor,            # (B, S)
        cache: Dict[str, Any],
        *,
        dtype: torch.dtype = torch.bfloat16,
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Encode the audio, write every layer's cross K/V and the prompt's
        self K/V into ``cache`` in place, return the last position's logits
        (B, 1, V) and the cache.  The cache must be empty (fresh or
        emptied by ``reset_cache``), as ``TransformerLM.prefill`` asks."""
        cross_k, cross_v = cache["cross_k"], cache["cross_v"]
        if frames.shape[:2] != cross_k.shape[1:3]:
            raise ValueError(f"frames {tuple(frames.shape)} do not fit the "
                             "cross cache's (batch, S_enc) "
                             f"{tuple(cross_k.shape[1:3])}")
        enc_out = self.encode(frames.to(dtype))
        for i, lp in enumerate(self.decoder):
            k, v = self._cross_kv(lp["cross_attn"], enc_out)
            cross_k[i].copy_(k)
            cross_v[i].copy_(v)
        S = tokens.shape[1]
        x = self._embed_dec(tokens, dtype)
        positions = torch.arange(S, device=x.device)
        x = self._run_decoder(x, positions=positions, mode="full", cache=cache)
        cache["len"].fill_(S)
        x = layer_norm(x[:, -1:], self.dec_norm, self.cfg.norm_eps)
        return self.logits(x), cache

    def decode_step(
        self,
        tokens: torch.Tensor,            # (B, 1)
        cache: Dict[str, Any],
        *,
        dtype: torch.dtype = torch.bfloat16,
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One decode step: next-token logits (B, 1, V) and the cache,
        updated in place.  The position's sinusoid is computed at the
        device length, which the step advances in place; nothing waits for
        the device."""
        positions = cache["len"].reshape(1)
        x = embed_tokens(self.embed, tokens, dtype)
        x = x + sinusoid_at(positions, self.cfg.d_model).to(dtype)
        x = self._run_decoder(x, positions=positions, mode="decode", cache=cache)
        x = layer_norm(x, self.dec_norm, self.cfg.norm_eps)
        cache["len"].add_(1)
        return self.logits(x), cache
