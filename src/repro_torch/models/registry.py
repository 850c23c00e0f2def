"""Build a model object from a ModelConfig (counterpart of
``repro.models.registry``)."""

from __future__ import annotations

from typing import Any

from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import TransformerLM


def build_model(cfg: ModelConfig, **kwargs: Any) -> TransformerLM:
    """Instantiate the model for a config.

    kwargs are forwarded to :class:`TransformerLM` (``impl``, ``device``,
    ``dtype``, ``generator``).  Encoder-decoder configs (Whisper) are not
    ported yet.
    """
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder model is not ported yet; see "
            "ROADMAP Queue 1 item 10 (Whisper EncDecLM)"
        )
    return TransformerLM(cfg, **kwargs)
