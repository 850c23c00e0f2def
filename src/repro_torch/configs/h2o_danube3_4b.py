"""h2o-danube3-4b [dense]: 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000 — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube3-4b",
        family="dense",
        num_layers=24,
        d_model=3840,
        num_heads=32,
        num_kv_heads=8,
        head_dim=120,
        d_ff=10_240,
        vocab_size=32_000,
        rope_theta=10_000.0,
        sliding_window=4_096,
        tie_embeddings=True,
        act="silu",
    )
