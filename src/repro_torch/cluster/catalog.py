"""Cloud / region / zone / instance-type catalog: the port's own copy of
``repro.cluster.catalog``.

Spot prices are Table 1's spot / on-demand ratios per (cloud, accelerator)
applied to representative on-demand list prices (the paper's g5.48xlarge,
16.3 $/h on demand and 4.9 $/h spot, exactly).  A ``Zone`` is the paper's
failure domain: preemptions correlate within a region's zones and hardly
across regions (Fig. 3).

The reference resolves an accelerator's HBM rate from a table by name.  The
port keeps no such table: every instance type it declares gives
``hbm_bytes_per_s`` itself, and one without it raises.  Its values are the
reference's table entries, so every field of every type the reference
declares is the reference's.  The port adds one type of its own, ``h100``,
the instance it runs on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Instance types
# ---------------------------------------------------------------------------


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


# Table 1 (paper, Oct 2024): spot cost as a fraction of on-demand, per
# cloud x accelerator; ranges are encoded as their midpoint.
_TABLE1: Mapping[Tuple[str, str], float] = {
    ("aws", "A100"): 0.10,
    ("aws", "V100"): 0.165,   # 8-25%
    ("aws", "T4"): 0.15,      # 13-17%
    ("aws", "K80"): 0.19,     # 13-25%
    ("azure", "A100"): 0.50,
    ("azure", "V100"): 0.25,
    ("azure", "T4"): 0.10,
    ("azure", "K80"): 0.10,
    ("gcp", "A100"): 0.33,
    ("gcp", "V100"): 0.33,
    ("gcp", "T4"): 0.17,      # 14-20%
    ("gcp", "K80"): 0.10,
    ("gcp", "TPUv5e"): 0.33,
}


def _itype(name: str, cloud: str, accel: str, count: int, od: float, *,
           hbm_bytes_per_s: float, hbm: float = 16.0,
           tflops: float = 197.0) -> InstanceType:
    return InstanceType(
        name=name,
        cloud=cloud,
        accelerator=accel,
        accel_count=count,
        od_price=od,
        spot_ratio=_TABLE1[(cloud, accel)],
        hbm_gib_per_accel=hbm,
        peak_bf16_tflops=tflops,
        hbm_bytes_per_s=hbm_bytes_per_s,
    )


# The paper's g5.48xlarge (8 x A10G; on-demand 16.3 $/h, spot 4.9 $/h,
# quoted in the paper), the instance the scenario matrix prices requests on.
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

# The reference's instance types, in its order, each with the HBM rate of
# the reference's table for its accelerator.
DEFAULT_INSTANCE_TYPES: Tuple[InstanceType, ...] = (
    G5_48XLARGE,
    _itype("g4dn.12xlarge", "aws", "T4", 4, 3.912, hbm=16.0, tflops=65.0,
           hbm_bytes_per_s=0.3e12),
    _itype("p3.2xlarge", "aws", "V100", 1, 3.06, hbm=16.0, tflops=112.0,
           hbm_bytes_per_s=0.9e12),
    _itype("a2-ultragpu-4g", "gcp", "A100", 4, 20.55, hbm=80.0, tflops=312.0,
           hbm_bytes_per_s=2.0e12),
    _itype("p4d.24xlarge", "aws", "A100", 8, 32.77, hbm=40.0, tflops=312.0,
           hbm_bytes_per_s=2.0e12),
    _itype("Standard_NC24ads_A100_v4", "azure", "A100", 1, 3.67, hbm=80.0,
           tflops=312.0, hbm_bytes_per_s=2.0e12),
    _itype("v5e-8", "gcp", "TPUv5e", 8, 9.60, hbm_bytes_per_s=0.819e12),
    _itype("v5e-16", "gcp", "TPUv5e", 16, 19.20, hbm_bytes_per_s=0.819e12),
    _itype("v5e-256", "gcp", "TPUv5e", 256, 307.20,
           hbm_bytes_per_s=0.819e12),
)

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

INSTANCE_TYPES: Dict[str, InstanceType] = {
    t.name: t for t in DEFAULT_INSTANCE_TYPES + (H100,)}


def instance_type(name: str) -> InstanceType:
    """The port's instance type called ``name``; raises KeyError naming
    the ones it has."""
    try:
        return INSTANCE_TYPES[name]
    except KeyError:
        raise KeyError(f"unknown instance type {name!r}; the port has "
                       f"{sorted(INSTANCE_TYPES)}") from None


# ---------------------------------------------------------------------------
# Zones and regions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Zone:
    """A failure domain: (cloud, region, zone)."""

    name: str                   # e.g. "us-east-1a"
    region: str                 # e.g. "us-east-1"
    cloud: str                  # "aws" | "gcp" | "azure"
    # multiplier on the instance type's base price in this zone (spot
    # prices differ slightly across zones and regions)
    price_multiplier: float = 1.0

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return f"{self.cloud}:{self.name}"


@dataclasses.dataclass(frozen=True)
class CloudSpec:
    """Cloud-level behaviour knobs (preemption warning; see §2.3)."""

    name: str
    preemption_warning_s: float     # best-effort warning before a preemption
    warning_delivery_prob: float    # warnings are best-effort


DEFAULT_CLOUDS: Tuple[CloudSpec, ...] = (
    CloudSpec("aws", preemption_warning_s=120.0, warning_delivery_prob=0.9),
    CloudSpec("gcp", preemption_warning_s=30.0, warning_delivery_prob=0.9),
    CloudSpec("azure", preemption_warning_s=30.0, warning_delivery_prob=0.9),
)


# Inter-region RTT model (§3.1, Fig. 6b): ~100 ms US<->EU round trip, small
# within a region.  Keys are region prefixes.
_REGION_GEO: Mapping[str, str] = {
    "us-east": "us-east",
    "us-west": "us-west",
    "eu": "eu",
    "asia": "asia",
}

_GEO_RTT_MS: Mapping[Tuple[str, str], float] = {
    ("us-east", "us-east"): 2.0,
    ("us-west", "us-west"): 2.0,
    ("eu", "eu"): 2.0,
    ("asia", "asia"): 2.0,
    ("us-east", "us-west"): 60.0,
    ("us-east", "eu"): 95.0,
    ("us-west", "eu"): 140.0,
    ("us-east", "asia"): 180.0,
    ("us-west", "asia"): 110.0,
    ("eu", "asia"): 240.0,
}


def _geo_of(region: str) -> str:
    for prefix, geo in _REGION_GEO.items():
        if region.startswith(prefix):
            return geo
    return "us-east"


def region_rtt_ms(region_a: str, region_b: str) -> float:
    """Round-trip latency between two regions (Fig. 6b model)."""
    ga, gb = _geo_of(region_a), _geo_of(region_b)
    if (ga, gb) in _GEO_RTT_MS:
        return _GEO_RTT_MS[(ga, gb)]
    return _GEO_RTT_MS[(gb, ga)]


# Effective point-to-point bandwidth between two instances, by locality tier
# (per-flow rates a single TCP stream sustains, not NIC line rate).
INTRA_ZONE_GBPS = 25.0
INTRA_REGION_GBPS = 10.0
INTER_REGION_GBPS = 5.0          # same cloud, different region
INTER_CLOUD_GBPS = 1.0           # public internet


def link_bandwidth_gbps(
    cloud_a: str, region_a: str, zone_a: str,
    cloud_b: str, region_b: str, zone_b: str,
) -> float:
    """Locality-tiered bandwidth (Gbit/s) between two placements."""
    if cloud_a != cloud_b:
        return INTER_CLOUD_GBPS
    if region_a != region_b:
        return INTER_REGION_GBPS
    if zone_a != zone_b:
        return INTRA_REGION_GBPS
    return INTRA_ZONE_GBPS


def _mk_zones() -> Tuple[Zone, ...]:
    """The default zone universe, mirroring the zones of the paper's traces.

    AWS: us-east-1{a,c,f}, us-east-2{a,b}, us-west-2{a,b,c}, eu-central-1{a,b}
    GCP: us-central1{a,b,c}, us-west1{a,b}, europe-west4{a,b}
    Azure: eastus{1,2}, westeurope{1,2}
    """
    zones: List[Zone] = []

    def add(cloud: str, region: str, suffixes: Sequence[str],
            mult: float) -> None:
        for i, s in enumerate(suffixes):
            zones.append(Zone(name=f"{region}{s}", region=region, cloud=cloud,
                              price_multiplier=mult * (1.0 + 0.015 * i)))

    add("aws", "us-east-1", ["a", "c", "f"], 1.00)
    add("aws", "us-east-2", ["a", "b"], 0.97)
    add("aws", "us-west-2", ["a", "b", "c"], 0.95)
    add("aws", "eu-central-1", ["a", "b"], 1.08)
    add("gcp", "us-central1", ["-a", "-b", "-c"], 1.00)
    add("gcp", "us-west1", ["-a", "-b"], 0.98)
    add("gcp", "europe-west4", ["-a", "-b"], 1.06)
    add("azure", "eastus", ["-1", "-2"], 1.02)
    add("azure", "westeurope", ["-1", "-2"], 1.10)
    return tuple(zones)


DEFAULT_ZONES: Tuple[Zone, ...] = _mk_zones()


# ---------------------------------------------------------------------------
# Catalog
# ---------------------------------------------------------------------------


class Catalog:
    """Immutable lookup service over clouds, zones and instance types (the
    controller's pricing API when SELECT-NEXT-ZONE breaks ties by cost)."""

    def __init__(
        self,
        zones: Sequence[Zone] = DEFAULT_ZONES,
        instance_types: Sequence[InstanceType] = tuple(INSTANCE_TYPES.values()),
        clouds: Sequence[CloudSpec] = DEFAULT_CLOUDS,
    ) -> None:
        self._zones: Dict[str, Zone] = {z.name: z for z in zones}
        self._itypes: Dict[str, InstanceType] = {
            t.name: t for t in instance_types
        }
        self._clouds: Dict[str, CloudSpec] = {c.name: c for c in clouds}

    # -- zones ---------------------------------------------------------
    @property
    def zones(self) -> List[Zone]:
        return list(self._zones.values())

    def zone(self, name: str) -> Zone:
        return self._zones[name]

    def zones_in_region(self, region: str) -> List[Zone]:
        return [z for z in self._zones.values() if z.region == region]

    def zones_in_cloud(self, cloud: str) -> List[Zone]:
        return [z for z in self._zones.values() if z.cloud == cloud]

    def regions(self) -> List[str]:
        return sorted({z.region for z in self._zones.values()})

    def filter_zones(
        self,
        *,
        clouds: Optional[Sequence[str]] = None,
        regions: Optional[Sequence[str]] = None,
        exclude_zones: Optional[Sequence[str]] = None,
    ) -> List[Zone]:
        """Apply the user's ``any_of`` resource filter (Listing 1)."""
        out = []
        excl = set(exclude_zones or ())
        for z in self._zones.values():
            if clouds and z.cloud not in clouds:
                continue
            if regions and z.region not in regions:
                continue
            if z.name in excl:
                continue
            out.append(z)
        return out

    # -- instance types -------------------------------------------------
    def instance_type(self, name: str) -> InstanceType:
        return self._itypes[name]

    @property
    def instance_types(self) -> List[InstanceType]:
        return list(self._itypes.values())

    # -- pricing ---------------------------------------------------------
    def spot_price(self, itype: str, zone: str) -> float:
        t, z = self._itypes[itype], self._zones[zone]
        return t.spot_price * z.price_multiplier

    def od_price(self, itype: str, zone: str) -> float:
        t, z = self._itypes[itype], self._zones[zone]
        return t.od_price * z.price_multiplier

    def cheapest_zone(
        self, itype: str, candidates: Sequence[str], *, spot: bool = True
    ) -> str:
        """MIN-COST from Alg. 1 (line 20/22)."""
        if not candidates:
            raise ValueError("cheapest_zone: empty candidate set")
        price = self.spot_price if spot else self.od_price
        return min(candidates, key=lambda z: (price(itype, z), z))

    # -- clouds ----------------------------------------------------------
    def cloud(self, name: str) -> CloudSpec:
        return self._clouds[name]

    def rtt_ms(self, region_a: str, region_b: str) -> float:
        return region_rtt_ms(region_a, region_b)

    def bandwidth_gbps(self, zone_a: str, zone_b: str) -> float:
        """Locality-tiered link bandwidth between two catalog zones."""
        za, zb = self._zones[zone_a], self._zones[zone_b]
        return link_bandwidth_gbps(
            za.cloud, za.region, za.name, zb.cloud, zb.region, zb.name
        )

    def bandwidth_bytes_per_s(self, zone_a: str, zone_b: str) -> float:
        return self.bandwidth_gbps(zone_a, zone_b) * 1e9 / 8.0


def default_catalog() -> Catalog:
    return Catalog()


__all__ = [
    "Catalog", "CloudSpec", "DEFAULT_CLOUDS", "DEFAULT_INSTANCE_TYPES",
    "DEFAULT_ZONES", "G5_48XLARGE", "H100", "INSTANCE_TYPES", "InstanceType",
    "Zone", "default_catalog", "instance_type", "link_bandwidth_gbps",
    "region_rtt_ms",
]
