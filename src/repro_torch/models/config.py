"""ModelConfig — a single declarative description covering all 10 assigned
architectures (dense / GQA / SWA / MoE / SSM / hybrid / enc-dec / VLM).

Every field is explicit; ``repro/configs/<arch>.py`` files instantiate the
exact published configurations.  ``scaled(...)`` derives the reduced smoke
configs (same family, small dims) required by the per-arch smoke tests.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # -- identity ----------------------------------------------------------
    name: str
    family: str                       # dense | ssm | moe | hybrid | audio | vlm

    # -- core dims -----------------------------------------------------------
    num_layers: int
    d_model: int
    num_heads: int                    # query heads (0 for attention-free)
    num_kv_heads: int                 # GQA kv heads
    d_ff: int                         # FFN hidden (0 for attention-free/MoE-only)
    vocab_size: int

    head_dim: Optional[int] = None    # defaults to d_model // num_heads

    # -- attention flavor ----------------------------------------------------
    rope: bool = True                      # False: absolute positions (whisper)
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None   # SWA window (h2o-danube3)
    qkv_bias: bool = False                 # qwen2.5
    qk_norm: bool = False                  # qwen3-moe
    prefix_lm: bool = False                # paligemma: bidirectional prefix
    logit_softcap: Optional[float] = None  # gemma-style logit soft capping

    # -- block structure -------------------------------------------------------
    parallel_block: bool = False      # command-r: attn + FFN in parallel
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    act: str = "silu"                 # silu (SwiGLU) | gelu
    gated_mlp: Optional[bool] = None  # default: gated iff act == "silu"

    # -- MoE ----------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: Optional[int] = None    # per-expert hidden (defaults to d_ff)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # quantize tokens for the EP dispatch/combine all-to-all (e.g.
    # "float8_e4m3fn" halves MoE collective bytes; None = native dtype)
    moe_dispatch_dtype: Optional[str] = None

    # -- SSM (mamba) -----------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    mamba_version: int = 0            # 1 (falcon-mamba) | 2/SSD (zamba2)
    ssm_head_dim: int = 64            # mamba2 head dim

    # -- hybrid (zamba2) ---------------------------------------------------
    # a SHARED attention block applied after every ``hybrid_attn_every``
    # mamba layers (0 = no hybrid attention)
    hybrid_attn_every: int = 0

    # -- encoder-decoder (whisper) ---------------------------------------------
    encoder_layers: int = 0
    cross_attention: bool = False

    # -- modality frontend (stub per assignment) --------------------------------
    frontend: Optional[str] = None    # "audio-stub" | "vision-stub"
    frontend_seq: int = 0             # frames / patches fed by input_specs()

    # -- numerics ---------------------------------------------------------------
    vocab_pad_multiple: int = 256

    # ------------------------------------------------------------------
    def __post_init__(self) -> None:
        if self.num_heads and self.num_kv_heads:
            if self.num_heads % self.num_kv_heads:
                raise ValueError(
                    f"{self.name}: num_heads {self.num_heads} not divisible "
                    f"by kv heads {self.num_kv_heads}"
                )

    # -- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        if not self.num_heads:
            return 0
        return self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def d_inner(self) -> int:
        """SSM inner dim."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        """Mamba-2 head count."""
        if self.mamba_version != 2:
            return 0
        return self.d_inner // self.ssm_head_dim

    @property
    def mlp_gated(self) -> bool:
        if self.gated_mlp is not None:
            return self.gated_mlp
        return self.act == "silu"

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing → runs the ``long_500k`` shape."""
        return (
            self.family in ("ssm", "hybrid")
            or self.sliding_window is not None
        )

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    # -- zamba2 layer arithmetic ------------------------------------------
    @property
    def hybrid_blocks(self) -> int:
        """Number of (shared-attn + mamba-group) super-blocks."""
        if not self.hybrid_attn_every:
            return 0
        # num_layers = prelude_mamba + blocks * (1 attn + (every-1) mamba)
        per_block = self.hybrid_attn_every
        return self.num_layers // per_block

    @property
    def hybrid_prelude(self) -> int:
        if not self.hybrid_attn_every:
            return 0
        return self.num_layers - self.hybrid_blocks * self.hybrid_attn_every

    @property
    def hybrid_mamba_layers(self) -> int:
        """Total mamba layers in the hybrid stack."""
        if not self.hybrid_attn_every:
            return 0
        return self.hybrid_prelude + self.hybrid_blocks * (
            self.hybrid_attn_every - 1
        )

    # ------------------------------------------------------------------
    def scaled(
        self,
        *,
        num_layers: Optional[int] = None,
        d_model: int = 128,
        d_ff_ratio: Optional[float] = None,
        vocab: int = 512,
        num_experts: Optional[int] = None,
        frontend_seq: Optional[int] = None,
    ) -> "ModelConfig":
        """A reduced same-family config for CPU smoke tests."""
        nh = self.num_heads
        nkv = self.num_kv_heads
        if nh:
            # keep the GQA *ratio*, shrink the counts
            ratio = nh // max(nkv, 1)
            nh = max(2, min(nh, 4))
            nkv = max(1, nh // min(ratio, nh))
        layers = num_layers
        if layers is None:
            layers = 2 if not self.hybrid_attn_every else self.hybrid_attn_every
        ratio_ff = (
            d_ff_ratio
            if d_ff_ratio is not None
            else (self.d_ff / self.d_model if self.d_ff else 0.0)
        )
        n_exp = num_experts if num_experts is not None else (
            min(self.num_experts, 8) if self.num_experts else 0
        )
        return dataclasses.replace(
            self,
            name=f"{self.name}-smoke",
            num_layers=layers,
            d_model=d_model,
            num_heads=nh,
            num_kv_heads=nkv,
            head_dim=(d_model // nh) if nh else None,
            d_ff=int(d_model * ratio_ff) if self.d_ff else 0,
            moe_d_ff=(
                max(32, int(d_model * (self.expert_d_ff / self.d_model)))
                if self.is_moe
                else None
            ),
            vocab_size=vocab,
            vocab_pad_multiple=64,
            num_experts=n_exp,
            experts_per_token=(
                min(self.experts_per_token, n_exp) if n_exp else 0
            ),
            sliding_window=(
                min(self.sliding_window, 64)
                if self.sliding_window is not None
                else None
            ),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.mamba_version == 2 else self.ssm_head_dim,
            encoder_layers=2 if self.encoder_layers else 0,
            frontend_seq=(
                frontend_seq
                if frontend_seq is not None
                else (16 if self.frontend_seq else 0)
            ),
        )

    # -- parameter count estimate (roofline MODEL_FLOPS uses the exact
    #    blueprint count; this is a sanity cross-check) ---------------------
    def approx_params(self) -> int:
        d, L, V = self.d_model, self.num_layers, self.padded_vocab
        hd = self.resolved_head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        attn = 0
        if self.num_heads:
            attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) \
                + self.num_heads * hd * d
        ffn = 0
        if self.d_ff and not self.is_moe:
            mult = 3 if self.act == "silu" else 2
            ffn = mult * d * self.d_ff
        if self.is_moe:
            ffn = self.num_experts * 3 * d * self.expert_d_ff
        return emb + L * (attn + ffn)
