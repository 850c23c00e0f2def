"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936 — GQA, QKV bias.  [hf:Qwen/Qwen2.5-3B]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b",
        family="dense",
        num_layers=36,
        d_model=2048,
        num_heads=16,
        num_kv_heads=2,
        head_dim=128,
        d_ff=11_008,
        vocab_size=151_936,
        rope_theta=1_000_000.0,
        qkv_bias=True,
        tie_embeddings=True,
        act="silu",
    )
