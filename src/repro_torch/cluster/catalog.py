"""The port's instance types: its own copy of ``InstanceType`` (the dataclass
of ``repro.cluster.catalog``), the one instance it runs on, an H100, and
``g5.48xlarge``, the reference's paper instance that its scenario matrix
prices requests on.

The reference's catalog has no H100 and resolves an accelerator's HBM rate
from a table by name.  The port keeps no such table: every instance type it
declares gives ``hbm_bytes_per_s`` itself, and one without it raises.  The
fields and their meaning are the reference's, so a test can build the
reference's ``InstanceType`` from the port's figures field for field.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class InstanceType:
    """A purchasable machine shape.

    ``spot_ratio`` is the spot / on-demand price ratio of the instance's
    cloud.  ``peak_bf16_tflops`` and ``hbm_bytes_per_s`` are per
    accelerator; the profiler divides measured rates by ``accel_count``
    times them."""

    name: str
    cloud: str
    accelerator: str            # e.g. "H100"
    accel_count: int
    od_price: float             # $/hour, on-demand
    spot_ratio: float           # spot price as fraction of on-demand
    hbm_gib_per_accel: float = 16.0
    peak_bf16_tflops: float = 197.0  # per accelerator
    hbm_bytes_per_s: Optional[float] = None  # per accelerator, peak

    def __post_init__(self) -> None:
        if self.hbm_bytes_per_s is None:
            raise ValueError(
                f"instance type {self.name!r}: the port keeps no HBM "
                "bandwidth table; give hbm_bytes_per_s explicitly"
            )

    @property
    def spot_price(self) -> float:
        return self.od_price * self.spot_ratio


# One H100 SXM (NVIDIA's data sheet: 80 GB of HBM3 at 3.35 TB/s, 989 dense
# bf16 TFLOP/s; the figures chip_smoke.py bounds the kernels with).
# od_price and spot_ratio are ASSUMPTIONS, not data: Table 1 of the paper has
# no H100 row and the port has no price source.  11.06 $/h stands for a
# one-GPU H100 instance's on-demand list price, and 0.33 borrows the GCP GPU
# spot bracket of Table 1.  Nothing in the port or its tests depends on them.
H100 = InstanceType(
    name="h100",
    cloud="gcp",
    accelerator="H100",
    accel_count=1,
    od_price=11.06,
    spot_ratio=0.33,
    hbm_gib_per_accel=80.0,
    peak_bf16_tflops=989.0,
    hbm_bytes_per_s=3.35e12,
)

# The paper's g5.48xlarge (8 x A10G; on-demand 16.3 $/h, spot 4.9 $/h,
# quoted in the paper), with every value of the reference's catalog entry
# given here: its HBM rate is the reference's A10G figure, 0.6e12 B/s.
G5_48XLARGE = InstanceType(
    name="g5.48xlarge",
    cloud="aws",
    accelerator="A10G",
    accel_count=8,
    od_price=16.3,
    spot_ratio=4.9 / 16.3,
    hbm_gib_per_accel=24.0,
    peak_bf16_tflops=70.0,
    hbm_bytes_per_s=0.6e12,
)

INSTANCE_TYPES: Dict[str, InstanceType] = {
    t.name: t for t in (H100, G5_48XLARGE)}


def instance_type(name: str) -> InstanceType:
    """The port's instance type called ``name``; raises KeyError naming
    the ones it has."""
    try:
        return INSTANCE_TYPES[name]
    except KeyError:
        raise KeyError(f"unknown instance type {name!r}; the port has "
                       f"{sorted(INSTANCE_TYPES)}") from None


__all__ = ["G5_48XLARGE", "H100", "INSTANCE_TYPES", "InstanceType", "instance_type"]
