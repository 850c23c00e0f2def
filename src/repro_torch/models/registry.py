"""Build a model object from a ModelConfig (counterpart of
``repro.models.registry``)."""

from __future__ import annotations

from typing import Any, Union

from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import TransformerLM
from repro_torch.models.whisper import EncDecLM


def build_model(cfg: ModelConfig, **kwargs: Any) -> Union[TransformerLM, EncDecLM]:
    """Instantiate the model for a config: :class:`EncDecLM` for an
    encoder-decoder config (Whisper), :class:`TransformerLM` for every
    other.  kwargs are forwarded (``impl``, ``device``, ``dtype``,
    ``generator``, ``ssm_chunk``; an ``EncDecLM`` has no Mamba layers and
    drops ``ssm_chunk``, as the reference's registry does)."""
    if cfg.is_encdec:
        kwargs.pop("ssm_chunk", None)
        return EncDecLM(cfg, **kwargs)
    return TransformerLM(cfg, **kwargs)
