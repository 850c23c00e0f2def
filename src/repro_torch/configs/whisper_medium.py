"""whisper-medium [audio]: 24L(enc) + 24L(dec) d_model=1024 16H (kv=16)
d_ff=4096 vocab=51865 — enc-dec; conv frontend is a STUB (input_specs()
provides precomputed frame embeddings).  [arXiv:2212.04356]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="audio",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=51_865,
        rope=False,
        qkv_bias=True,
        encoder_layers=24,
        cross_attention=True,
        frontend="audio-stub",
        frontend_seq=1500,
        tie_embeddings=True,
        act="gelu",
        norm_eps=1e-5,
    )
