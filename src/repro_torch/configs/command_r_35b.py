"""command-r-35b [dense]: 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000 — GQA, no-bias, parallel attn+FFN block, tied embeddings.
[hf:CohereForAI/c4ai-command-r-v01]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b",
        family="dense",
        num_layers=40,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=22_528,
        vocab_size=256_000,
        rope_theta=8_000_000.0,
        parallel_block=True,
        tie_embeddings=True,
        act="silu",
        norm_eps=1e-5,
    )
