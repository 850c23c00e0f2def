"""Roofline terms of a counted step, and its model FLOPs (counterpart of
``repro.launch.analysis``).

The reference prices a per-device XLA module at TPU v5e's constants.  The
port prices the per-device counts of ``launch.op_count`` at one H100 SXM's:

    compute    = FLOPs       / 989e12 FLOP/s   (dense bf16 tensor cores)
    memory     = bytes       / 3.35e12 B/s     (HBM3)
    collective = link bytes  / 450e9 B/s       (NVLink 4, per direction)

The first two are the port's ``h100`` instance
(``repro_torch.cluster.catalog.H100``), NVIDIA's data-sheet figures; the
link rate is the published NVLink 4 figure for an H100 SXM (900 GB/s both
directions, 450 GB/s each way, to the NVSwitch of its node).  All three
are published figures, not measurements.  A two-node mesh also crosses the
nodes' network, which is slower; the roofline prices every collective at
NVLink's rate, a lower bound for the ``pod`` axis.

``link_bytes`` applies the reference's per-op ring model: all-reduce 2x,
all-gather / reduce-scatter / all-to-all / broadcast 1x of the result.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from repro_torch.cluster.catalog import H100

PEAK_FLOPS_BF16 = H100.peak_bf16_tflops * 1e12
HBM_BW = H100.hbm_bytes_per_s
NVLINK_BW = 450e9       # published H100 SXM NVLink 4 rate, one direction


@dataclasses.dataclass
class Roofline:
    """Roofline terms.

    ``hlo_flops`` / ``hlo_bytes`` / ``collective_link_bytes`` are one
    device's counts (the names are the reference's, whose counts come from
    HLO; here they come from ``launch.op_count``), so the terms divide by
    one device's peaks.  ``model_flops`` is the *global* 6·N·D (train) /
    2·N·D (inference) figure; the useful fraction divides by
    (hlo_flops × chips)."""

    arch: str
    shape: str
    mesh_desc: str
    chips: int
    hlo_flops: float                    # per device
    hlo_bytes: float                    # per device
    collective_link_bytes: float        # per device
    model_flops: float                  # GLOBAL 6·N·D / 6·N_active·D (MoE)

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_link_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (FLOPs × chips): catches remat and redundancy."""
        if self.hlo_flops <= 0:
            return 0.0
        return self.model_flops / (self.hlo_flops * self.chips)

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline step time."""
        t = self.step_time_s
        if t <= 0:
            return 0.0
        return self.model_flops / (t * self.chips * PEAK_FLOPS_BF16)

    def row(self) -> Dict[str, Any]:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh_desc,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_link_bytes": self.collective_link_bytes,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_flops_fraction": self.useful_flops_fraction,
            "mfu_at_roofline": self.mfu,
        }


def blueprint_for(cfg) -> Dict[str, Any]:
    """The reference's parameter blueprint of ``cfg``'s model."""
    if cfg.is_encdec:
        from repro_torch.models.whisper import encdec_blueprint

        return encdec_blueprint(cfg)
    from repro_torch.models.lm import lm_blueprint

    return lm_blueprint(cfg)


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D for training, 2·N·D for inference (per step:
    D = tokens processed).  MoE uses active params; frontend stub tokens
    count as processed tokens."""
    from repro_torch.models.base import param_count

    n_total = param_count(blueprint_for(cfg))
    n = n_total
    if cfg.is_moe:
        # active params: replace full expert count with top-k experts
        expert_params = (
            cfg.num_layers
            * cfg.num_experts
            * (3 if cfg.mlp_gated else 2)
            * cfg.d_model
            * cfg.expert_d_ff
        )
        active_expert = expert_params * (
            cfg.experts_per_token / cfg.num_experts
        )
        n = n_total - expert_params + active_expert
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * (
            shape.seq_len + (cfg.frontend_seq or 0)
        )
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


__all__ = ["HBM_BW", "NVLINK_BW", "PEAK_FLOPS_BF16", "Roofline",
           "blueprint_for", "model_flops_for"]
