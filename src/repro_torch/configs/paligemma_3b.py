"""paligemma-3b [vlm]: 18L d_model=2048 8H (GQA kv=1) d_ff=16384
vocab=257216 — SigLIP frontend (STUB: input_specs() provides precomputed
patch embeddings) + Gemma backbone with prefix-LM masking over the image
prefix.  [arXiv:2407.07726]"""

from repro_torch.models.config import ModelConfig

# SigLIP-So400m/14 @ 224px -> 256 patch tokens
NUM_PATCHES = 256


def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b",
        family="vlm",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16_384,
        vocab_size=257_216,
        rope_theta=10_000.0,
        prefix_lm=True,
        frontend="vision-stub",
        frontend_seq=NUM_PATCHES,
        tie_embeddings=True,
        act="gelu",
        gated_mlp=True,   # Gemma: GeGLU
    )
