"""Model zoo of the port (counterpart of ``repro.models``).

Every family of the reference is ported: ``TransformerLM`` (dense / GQA,
MoE, Mamba-1, the Mamba-2 hybrid) and the encoder-decoder ``EncDecLM``
(Whisper), built from a ``ModelConfig`` by ``registry.build_model``.
Parameters follow the reference's blueprints (``base.ParamSpec``), so
weights carry over from the JAX package with
``repro_torch.convert.params_from_jax``.
"""
