"""The token engine's configuration: the port's own copy of
``repro.serving.token.config``.

* ``TokenSchedulerConfig`` holds the spec's knobs (the ``serving:``
  section): SLO targets, the prefill chunk, batch and KV caps, the
  per-iteration overhead and the goodput window.
* ``TokenEngineConfig`` is the physics one (model x instance) pair
  resolves to, derived from a ``LatencyModel`` (the roofline or a
  ``ProfiledLatencyModel``, whose measured MFU / MBU then price the
  prefill slope and the weight read):

  - ``weight_read_s``: one decode iteration's weight traffic over the
    effective HBM rate, ``LatencyModel.decode_s_per_token()``, read once
    per iteration and shared by the whole batch;
  - ``kv_read_s_per_token``: each decoding sequence re-reads its own KV,
    per resident token and iteration;
  - ``prefill_s_per_token``: ``2 N_active`` FLOPs a token over the
    effective FLOP rate;
  - ``kv_budget_tokens``: the HBM left after the weights, in tokens
    (``LatencyModel.max_concurrency``'s arithmetic kept in tokens); a model
    with no KV cache gets an unbounded budget and no KV read;
  - ``kv_bytes_per_token``: what one cached token occupies, and what a KV
    migration ships.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.serving.latency import LatencyModel

__all__ = ["TokenEngineConfig", "TokenSchedulerConfig", "UNBOUNDED_KV_TOKENS"]

#: the KV budget of a model with no KV cache
UNBOUNDED_KV_TOKENS = 1 << 40


@dataclasses.dataclass(frozen=True)
class TokenSchedulerConfig:
    """The continuous-batching scheduler's knobs."""

    slo_ttft_s: float = 10.0        # time-to-first-token target
    slo_tpot_s: float = 0.2         # time-per-output-token target
    prefill_chunk_tokens: int = 512  # prompt tokens an iteration prefills
    max_batch: Optional[int] = None  # sequences in flight (None: KV-bound)
    kv_budget_tokens: Optional[int] = None   # over the derived budget
    iter_overhead_s: float = 0.0    # scheduler overhead an iteration
    goodput_window_s: float = 60.0  # goodput aggregation window

    def __post_init__(self) -> None:
        if self.slo_ttft_s <= 0 or self.slo_tpot_s <= 0:
            raise ValueError(
                f"SLO targets must be positive, got ttft={self.slo_ttft_s} "
                f"tpot={self.slo_tpot_s}")
        if self.prefill_chunk_tokens < 1:
            raise ValueError(f"prefill_chunk_tokens must be >= 1, "
                             f"got {self.prefill_chunk_tokens}")
        if self.max_batch is not None and self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.kv_budget_tokens is not None and self.kv_budget_tokens < 1:
            raise ValueError(f"kv_budget_tokens must be >= 1, "
                             f"got {self.kv_budget_tokens}")
        if self.iter_overhead_s < 0:
            raise ValueError(f"iter_overhead_s must be >= 0, "
                             f"got {self.iter_overhead_s}")
        if self.goodput_window_s <= 0:
            raise ValueError(f"goodput_window_s must be positive, "
                             f"got {self.goodput_window_s}")


@dataclasses.dataclass(frozen=True)
class TokenEngineConfig:
    """The token engine's physics for one (model x instance) pair."""

    weight_read_s: float            # decode iteration floor (weights / HBM)
    kv_read_s_per_token: float      # a resident KV token's read, an iteration
    prefill_s_per_token: float      # compute-bound prefill slope
    overhead_s: float               # per-request tokenize / HTTP constant
    iter_overhead_s: float
    kv_budget_tokens: int
    prefill_chunk_tokens: int
    max_batch: int
    # bytes one cached token occupies: what a KV migration moves (0.0 for a
    # model with no KV cache)
    kv_bytes_per_token: float = 0.0

    @classmethod
    def from_latency(cls, lm: LatencyModel,
                     knobs: Optional[TokenSchedulerConfig] = None
                     ) -> "TokenEngineConfig":
        knobs = knobs or TokenSchedulerConfig()
        kv_bytes = lm.kv_bytes_per_token()
        if kv_bytes > 0:
            budget = max(1, int(lm.free_kv_hbm_bytes() / kv_bytes))
            kv_read = kv_bytes / lm.hbm_bytes_per_s
        else:
            budget = UNBOUNDED_KV_TOKENS
            kv_read = 0.0
        if knobs.kv_budget_tokens is not None:
            budget = knobs.kv_budget_tokens
        return cls(
            weight_read_s=lm.decode_s_per_token(),
            kv_read_s_per_token=kv_read,
            prefill_s_per_token=2.0 * lm._active_params / lm.flops_per_s,
            overhead_s=lm.overhead_s,
            iter_overhead_s=knobs.iter_overhead_s,
            kv_budget_tokens=budget,
            prefill_chunk_tokens=knobs.prefill_chunk_tokens,
            max_batch=(knobs.max_batch if knobs.max_batch is not None
                       else 1 << 30),
            kv_bytes_per_token=kv_bytes,
        )
