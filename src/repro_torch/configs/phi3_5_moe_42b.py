"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, 16 experts top-2.  [hf:microsoft/Phi-3.5-MoE-instruct]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=6_400,
        vocab_size=32_064,
        rope_theta=10_000.0,
        num_experts=16,
        experts_per_token=2,
        tie_embeddings=False,
        act="silu",
        norm_eps=1e-5,
    )
