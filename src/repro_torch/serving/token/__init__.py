"""The token-level continuous-batching replica model (the port's own copy
of ``repro.serving.token``).

The request model prices a request with one frozen service time and an
interference factor.  This package models an LLM replica's engine:
iteration-level batching where requests join and leave per decode step, a
KV-cache token budget from the HBM left after the weights, a decode step
that depends on the batch (the weights read once for the batch, the KV per
sequence), chunked prefill, and preemptions that destroy the in-flight KV
so retried requests prefill again elsewhere.  A spec selects it with
``sim.replica_model: token`` and tunes it in its ``serving:`` section; a
token run's ``ServingResult`` carries ``TokenStats`` (TTFT / TPOT
percentiles, goodput against the SLO, the KV lost to preemptions).
"""

from repro_torch.serving.token.batch import (
    ContinuousBatch,
    KillReport,
    TokenCompletion,
)
from repro_torch.serving.token.config import (
    UNBOUNDED_KV_TOKENS,
    TokenEngineConfig,
    TokenSchedulerConfig,
)
from repro_torch.serving.token.metrics import TokenRecord, TokenStats
from repro_torch.serving.token.replica import TokenReplica

__all__ = [
    "ContinuousBatch", "KillReport", "TokenCompletion", "TokenEngineConfig",
    "TokenRecord", "TokenReplica", "TokenSchedulerConfig", "TokenStats",
    "UNBOUNDED_KV_TOKENS",
]
