"""falcon-mamba-7b [ssm]: 64L d_model=4096 attention-free, vocab=65024,
ssm_state=16 — Mamba-1 architecture.  [arXiv:2410.05355]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        num_layers=64,
        d_model=4096,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=65_024,
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
        mamba_version=1,
        tie_embeddings=False,
        act="silu",
    )
