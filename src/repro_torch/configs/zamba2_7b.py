"""zamba2-7b [hybrid]: 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba-2 (SSD) backbone + SHARED attention
blocks.  [arXiv:2411.15242]

Layer accounting (DESIGN.md §Arch-applicability): 81 layers =
3 prelude mamba2 + 13 super-blocks x (1 shared-attn + 5 mamba2)
= 68 mamba2 layers + 13 applications of the single shared attention block.
The real model's per-application LoRA adapters are simplified to plain
shared-weight application (documented deviation).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        num_layers=81,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,
        head_dim=112,
        d_ff=14_336,
        vocab_size=32_000,
        ssm_state=64,
        ssm_conv=4,
        ssm_expand=2,
        mamba_version=2,
        ssm_head_dim=64,
        hybrid_attn_every=6,
        tie_embeddings=True,
        act="silu",
    )
