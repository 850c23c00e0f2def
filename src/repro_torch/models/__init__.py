"""Model zoo of the port (counterpart of ``repro.models``).

The decoder-only paths are ported (dense / GQA, MoE, Mamba-1):
``TransformerLM`` over a ``ModelConfig``, built by
``registry.build_model``.  Parameters follow the reference's blueprints
(``base.ParamSpec``), so weights carry over from the JAX package with
``repro_torch.convert.params_from_jax``.
"""
