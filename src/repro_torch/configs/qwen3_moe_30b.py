"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4), per-expert
d_ff=768, vocab=151936, 128 experts top-8, QK-norm, head_dim=128 != d/H.
[hf:Qwen/Qwen3-30B-A3B]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=768,
        vocab_size=151_936,
        rope_theta=1_000_000.0,
        qk_norm=True,
        num_experts=128,
        experts_per_token=8,
        moe_d_ff=768,
        tie_embeddings=False,
        act="silu",
    )
