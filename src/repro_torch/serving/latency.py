"""Request latency models, roofline and profiled: the port's own copy of
``repro.serving.latency``.

    prefill_s(P)      = 2·N·P FLOPs / (accels × peak_flops × MFU_prefill)
    decode_s_per_tok  = weight bytes / (accels × HBM_bw) / MBU_decode
    service_s(req)    = prefill + out_tokens × decode + overhead

Prefill is compute-bound, decode is bound by the weights read per token.
The constants are the reference's (MFU 0.45, MBU 0.70, 0.05 s overhead),
so a request's service time here is the reference's to the bit, and so is
the concurrency a replica's leftover HBM holds (``max_concurrency``), the
serving engine's default.

``ProfiledLatencyModel`` keeps that structure and takes ``mfu_prefill`` /
``mbu_decode`` from a step-time table of ``repro_torch.profiles``, with
the table's path, backend and mode as provenance.  ``make_latency_model``
picks one of the two from a spec's ``latency:`` section; when no profile
row matches it warns, counts ``latency_profile_fallback`` on the run's
metrics registry and returns the roofline, as the reference does.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

from repro_torch.cluster.catalog import InstanceType
from repro_torch.models.config import ModelConfig
from repro_torch.obs.registry import get_registry
from repro_torch.profiles.schema import (
    DEFAULT_PROFILE_DIR,
    ProfileEntry,
    load_profiles,
)

__all__ = ["LATENCY_SOURCES", "LatencyModel", "ProfiledLatencyModel",
           "make_latency_model"]


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    cfg: ModelConfig
    itype: InstanceType
    n_params: float
    mfu_prefill: float = 0.45
    mbu_decode: float = 0.70
    overhead_s: float = 0.05        # tokenize/detokenize/HTTP

    @classmethod
    def for_model(cls, cfg: ModelConfig, itype: InstanceType,
                  n_params: float = 0.0) -> "LatencyModel":
        n = n_params or float(cfg.approx_params())
        return cls(cfg=cfg, itype=itype, n_params=n)

    @property
    def _active_params(self) -> float:
        cfg = self.cfg
        if not cfg.is_moe:
            return self.n_params
        expert = (
            cfg.num_layers * cfg.num_experts
            * (3 if cfg.mlp_gated else 2) * cfg.d_model * cfg.expert_d_ff
        )
        return self.n_params - expert * (
            1.0 - cfg.experts_per_token / cfg.num_experts
        )

    @property
    def flops_per_s(self) -> float:
        return (
            self.itype.accel_count
            * self.itype.peak_bf16_tflops * 1e12
            * self.mfu_prefill
        )

    @property
    def hbm_bytes_per_s(self) -> float:
        return (
            self.itype.accel_count
            * self.itype.hbm_bytes_per_s
            * self.mbu_decode
        )

    def prefill_s(self, prompt_tokens: int) -> float:
        return 2.0 * self._active_params * prompt_tokens / self.flops_per_s

    def decode_s_per_token(self) -> float:
        weight_bytes = 2.0 * self._active_params     # bf16
        return weight_bytes / self.hbm_bytes_per_s

    def service_s(self, prompt_tokens: int, output_tokens: int) -> float:
        return (
            self.overhead_s
            + self.prefill_s(prompt_tokens)
            + output_tokens * self.decode_s_per_token()
        )

    def kv_bytes_per_token(self) -> float:
        """K+V bf16 bytes one cached token occupies (0: no KV cache)."""
        cfg = self.cfg
        if cfg.num_kv_heads and cfg.resolved_head_dim:
            return float(
                2 * cfg.num_layers * cfg.num_kv_heads
                * cfg.resolved_head_dim * 2
            )
        return 0.0

    def free_kv_hbm_bytes(self) -> float:
        """HBM left for KV cache: 90% usable minus bf16 weights, floored
        at 5%."""
        hbm = (
            self.itype.accel_count * self.itype.hbm_gib_per_accel * 2**30
        )
        weights = 2.0 * self.n_params
        return max(hbm * 0.9 - weights, hbm * 0.05)

    def max_concurrency(self, max_ctx: int = 4096) -> int:
        """Requests servable concurrently from leftover HBM (KV budget).
        Attention-free archs are compute-limited instead (use 32)."""
        cfg = self.cfg
        kv_tok = self.kv_bytes_per_token()
        if kv_tok:
            slots = min(max_ctx, cfg.sliding_window or max_ctx)
            return max(1, int(self.free_kv_hbm_bytes() / (kv_tok * slots)))
        return 32


@dataclasses.dataclass(frozen=True)
class ProfiledLatencyModel(LatencyModel):
    """Roofline latency with kernel-measured MFU/MBU, and which table
    measured them, where and how."""

    profile_path: str = ""
    profile_backend: str = ""       # "cuda" | "cpu": where the row was measured
    profile_mode: str = ""          # "compiled" | "eager"

    @classmethod
    def from_entry(cls, cfg: ModelConfig, itype: InstanceType,
                   entry: ProfileEntry, *, path: str = "",
                   n_params: float = 0.0) -> "ProfiledLatencyModel":
        n = n_params or float(cfg.approx_params())
        return cls(
            cfg=cfg,
            itype=itype,
            n_params=n,
            mfu_prefill=entry.mfu_prefill,
            mbu_decode=entry.mbu_decode,
            profile_path=path,
            profile_backend=entry.backend,
            profile_mode=entry.mode,
        )


LATENCY_SOURCES = ("roofline", "profile")


def make_latency_model(
    cfg: ModelConfig,
    itype: InstanceType,
    *,
    model_id: str,
    source: str = "roofline",
    profile: Optional[str] = None,
) -> LatencyModel:
    """The latency model a spec's ``latency:`` section asks for.

    ``source="roofline"`` is the analytic model.  ``source="profile"``
    loads the table(s) at ``profile`` (a JSON file or a directory of them,
    default ``artifacts/profiles/``) and looks up ``(model_id,
    itype.accelerator)``; with no table or no matching row it warns, counts
    ``latency_profile_fallback`` on the active registry (the calling run's,
    so a sweep can tell which cells left the measured profiles) and
    returns the roofline."""
    if source not in LATENCY_SOURCES:
        raise ValueError(
            f"latency source must be one of {list(LATENCY_SOURCES)}, "
            f"got {source!r}"
        )
    if source == "roofline":
        return LatencyModel.for_model(cfg, itype)
    path = profile or DEFAULT_PROFILE_DIR
    entry = load_profiles(path, missing_ok=True).lookup(
        model_id, itype.accelerator)
    if entry is None:
        get_registry().inc("latency_profile_fallback", model=model_id,
                           accelerator=itype.accelerator)
        warnings.warn(
            f"latency source 'profile': no profile entry for "
            f"({model_id!r}, {itype.accelerator!r}) under {path!r}; "
            "falling back to the analytic roofline model",
            stacklevel=2,
        )
        return LatencyModel.for_model(cfg, itype)
    return ProfiledLatencyModel.from_entry(cfg, itype, entry, path=str(path))
