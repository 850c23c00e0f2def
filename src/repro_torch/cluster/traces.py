"""Spot-obtainability traces: the port's own copy of ``repro.cluster.traces``
(the replay format and the correlated synthetic generator).

A trace is an integer capacity matrix ``cap[T, Z]``, the number of spot
instances launchable in zone ``z`` during step ``t``, with a step of ``dt``
seconds.  The paper's traces (AWS 1/2/3, GCP 1) are not redistributable, so
the named datasets are synthesised from fixed seeds with the paper's
documented structure: preemptions correlated within a region and nearly
independent across regions (Fig. 3), volatile spot GPUs against stable spot
CPUs (Fig. 4), whole-region dropouts (§2.2).  The draws are the reference's,
in its order, from ``np.random.default_rng(seed)``: every named trace here
is the reference's to the bit.  ``python -m repro_torch.cluster.traces
[name ...] [--json]`` prints each trace's per-zone availability,
preemption rate and sibling correlation.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Trace container
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SpotTrace:
    """Per-zone spot capacity over time.

    cap[t, z]  — integer launchable spot capacity in zone ``zones[z]``
                 during step ``t``  (0 == unobtainable; preempt running spot).
    dt         — seconds per step.
    """

    zones: Tuple[str, ...]
    cap: np.ndarray           # int32 [T, Z]
    dt: float
    name: str = "trace"
    # Optional override of the *cloud's* advance-preemption-warning lead
    # time for runs replaying this trace (None -> use the cloud default).
    # Real trace datasets sometimes come with their own observed lead.
    preemption_warning_s: Optional[float] = None

    def __post_init__(self) -> None:
        self.cap = np.asarray(self.cap, dtype=np.int32)
        if self.cap.ndim != 2 or self.cap.shape[1] != len(self.zones):
            raise ValueError(
                f"cap shape {self.cap.shape} inconsistent with "
                f"{len(self.zones)} zones"
            )
        # zone -> column index; capacity()/capacity_row() sit on the
        # simulator hot path, where a linear zones.index() per call adds up
        self._zone_idx: Dict[str, int] = {
            z: j for j, z in enumerate(self.zones)
        }
        # memoized dense per-tick tensors (dense_ticks); traces are
        # immutable by convention so cached views never go stale
        self._dense_cache: Dict[Tuple, np.ndarray] = {}
        if self.preemption_warning_s is not None:
            w = float(self.preemption_warning_s)
            if not (w >= 0.0):
                raise ValueError(
                    f"preemption_warning_s must be >= 0, got {w!r}"
                )
            self.preemption_warning_s = w

    def zone_index(self, zone: str) -> int:
        try:
            return self._zone_idx[zone]
        except KeyError:
            raise ValueError(
                f"zone {zone!r} not in trace {self.name!r} "
                f"(zones: {list(self.zones)})"
            ) from None

    # -- basic accessors -------------------------------------------------
    @property
    def steps(self) -> int:
        return int(self.cap.shape[0])

    @property
    def duration_s(self) -> float:
        return self.steps * self.dt

    def step_of(self, t: float) -> int:
        return min(int(t / self.dt), self.steps - 1)

    def capacity(self, zone: str, t: float) -> int:
        """Launchable spot capacity C(z, t)."""
        return int(self.cap[self.step_of(t), self._zone_idx[zone]])

    def capacity_row(self, t: float) -> Dict[str, int]:
        row = self.cap[self.step_of(t)]
        return {z: int(c) for z, c in zip(self.zones, row)}

    def dense_ticks(
        self,
        dt: float,
        ticks: int,
        zones: Optional[Sequence[str]] = None,
        offset_s: float = 0.0,
    ) -> np.ndarray:
        """Dense per-tick capacity tensor for a fixed control interval.

        ``out[k, j]`` equals ``capacity(zones[j], k*dt + offset_s)`` for
        every tick ``k < ticks`` — same clamped ``step_of`` indexing and
        the same float arithmetic (``k*dt`` then ``+ offset``) as the
        scalar accessors, so replacing per-tick ``capacity_row`` calls
        with one precomputed tensor is bit-exact.  The simulator run loop
        and the JAX scenario engine both consume these; results are
        memoized (read-only views) since suites replay one trace across
        many cells.
        """
        key = (
            float(dt), int(ticks),
            tuple(zones) if zones is not None else None,
            float(offset_s),
        )
        out = self._dense_cache.get(key)
        if out is None:
            t = np.arange(int(ticks), dtype=np.float64) * float(dt) \
                + float(offset_s)
            idx = np.minimum(
                (t / self.dt).astype(np.int64), self.steps - 1
            )
            cols = (
                np.arange(len(self.zones))
                if zones is None
                else np.array([self.zone_index(z) for z in zones])
            )
            out = self.cap[np.ix_(idx, cols)]
            out.setflags(write=False)
            self._dense_cache[key] = out
        return out

    # -- statistics (used by the Fig. 3 / Fig. 5 benchmarks) -------------
    def availability(self, zone: str) -> float:
        """Fraction of time the zone has any spot capacity."""
        return float((self.cap[:, self.zone_index(zone)] > 0).mean())

    def preemption_indicator(self) -> np.ndarray:
        """bool [T, Z]: step where capacity *dropped* (a preemption event)."""
        drops = np.zeros_like(self.cap, dtype=bool)
        drops[1:] = self.cap[1:] < self.cap[:-1]
        return drops

    def zone_correlation(self, bin_steps: int = 5) -> np.ndarray:
        """Pearson correlation of per-zone preemption indicators (Fig. 3c).

        Indicators are aggregated over ``bin_steps`` windows before
        correlating — the paper's own correlated-preemption statistic is
        "at least one more follows within 5 minutes", i.e. same-window, not
        same-instant (§2.2).
        """
        ind = self.preemption_indicator().astype(np.float64)
        if bin_steps > 1:
            T = (ind.shape[0] // bin_steps) * bin_steps
            ind = (
                ind[:T]
                .reshape(-1, bin_steps, ind.shape[1])
                .max(axis=1)
            )
        Z = ind.shape[1]
        out = np.eye(Z)
        for i in range(Z):
            for j in range(i + 1, Z):
                a, b = ind[:, i], ind[:, j]
                sa, sb = a.std(), b.std()
                if sa == 0 or sb == 0:
                    r = 0.0
                else:
                    r = float(np.corrcoef(a, b)[0, 1])
                out[i, j] = out[j, i] = r
        return out

    def slice_zones(self, zones: Sequence[str]) -> "SpotTrace":
        idx = [self.zone_index(z) for z in zones]
        return SpotTrace(
            zones=tuple(zones),
            cap=self.cap[:, idx].copy(),
            dt=self.dt,
            name=self.name,
            preemption_warning_s=self.preemption_warning_s,
        )

    # -- (de)serialization -------------------------------------------------
    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            cap=self.cap,
            dt=np.float64(self.dt),
            zones=np.array(self.zones, dtype=object),
            name=np.array(self.name, dtype=object),
            # nan encodes "no override" (npz has no native None)
            preemption_warning_s=np.float64(
                np.nan
                if self.preemption_warning_s is None
                else self.preemption_warning_s
            ),
        )

    @staticmethod
    def load(path: str) -> "SpotTrace":
        with np.load(path, allow_pickle=True) as f:
            warn: Optional[float] = None
            if "preemption_warning_s" in f:
                w = float(f["preemption_warning_s"])
                warn = None if np.isnan(w) else w
            return SpotTrace(
                zones=tuple(str(z) for z in f["zones"]),
                cap=f["cap"],
                dt=float(f["dt"]),
                name=str(f["name"]),
                preemption_warning_s=warn,
            )

    @staticmethod
    def from_json(path: str) -> "SpotTrace":
        """Load the simple JSON interchange format.

        {"dt": 60, "zones": ["us-east-1a", ...],
         "cap": [[4, 4, 0], [4, 3, 0], ...]}
        """
        with open(path) as f:
            d = json.load(f)
        warn = d.get("preemption_warning_s")
        return SpotTrace(
            zones=tuple(d["zones"]),
            cap=np.asarray(d["cap"], dtype=np.int32),
            dt=float(d["dt"]),
            name=d.get("name", os.path.basename(path)),
            preemption_warning_s=None if warn is None else float(warn),
        )


def infer_region(zone: str) -> str:
    """Heuristic zone -> region mapping when no catalog is available.

    AWS zones end in a bare letter (``us-west-2a`` -> ``us-west-2``);
    GCP zones end in ``-<letter>`` (``us-central1-a`` -> ``us-central1``).
    Unrecognized names map to themselves (their own failure domain).
    """
    if len(zone) >= 3 and zone[-2] == "-" and zone[-1].isalpha():
        return zone.rsplit("-", 1)[0]
    if len(zone) >= 2 and zone[-1].isalpha() and zone[-2].isdigit():
        return zone[:-1]
    return zone


def trace_stats(trace: SpotTrace) -> Dict[str, object]:
    """The per-zone quantities forecasters and backtests consume.

    For each zone: availability fraction (any capacity), preemption rate
    (capacity-drop events per day), and mean preemption correlation with
    *sibling* zones of the same region (the Fig. 3 statistic).  Computed
    here once instead of being re-derived ad hoc by every benchmark.
    """
    corr = trace.zone_correlation()
    drops = trace.preemption_indicator()
    days = trace.duration_s / 86400.0
    regions = {z: infer_region(z) for z in trace.zones}
    zones: Dict[str, Dict[str, float]] = {}
    for j, z in enumerate(trace.zones):
        sib = [
            i
            for i, other in enumerate(trace.zones)
            if other != z and regions[other] == regions[z]
        ]
        zones[z] = {
            "region": regions[z],
            "availability": round(float(trace.availability(z)), 6),
            "preemptions_per_day": round(
                float(drops[:, j].sum()) / max(days, 1e-9), 4
            ),
            "mean_sibling_corr": round(
                float(np.mean([corr[j, i] for i in sib])) if sib else 0.0, 4
            ),
        }
    return {
        "name": trace.name,
        "steps": trace.steps,
        "dt_s": trace.dt,
        "duration_days": round(days, 3),
        "mean_availability": round(
            float(np.mean([s["availability"] for s in zones.values()])), 6
        ),
        "zones": zones,
    }


# ---------------------------------------------------------------------------
# Synthetic correlated generator
# ---------------------------------------------------------------------------


def _two_state_markov(
    rng: np.random.Generator,
    steps: int,
    p_up_down: float,
    p_down_up: float,
    start_up: bool = True,
) -> np.ndarray:
    """Sample a 2-state Markov chain (1=up, 0=down) of length ``steps``."""
    # Vectorized: draw all uniforms, then scan.  The scan is cheap in numpy
    # for the trace lengths we use (<= ~100k steps).
    u = rng.random(steps)
    out = np.empty(steps, dtype=np.int8)
    s = 1 if start_up else 0
    for t in range(steps):
        if s == 1 and u[t] < p_up_down:
            s = 0
        elif s == 0 and u[t] < p_down_up:
            s = 1
        out[t] = s
    return out


def synth_correlated_trace(
    zones: Sequence[str],
    zone_region: Mapping[str, str],
    *,
    steps: int,
    dt: float = 60.0,
    max_capacity: int = 4,
    # regional crunch process: expected crunch every ~mean_up steps lasting
    # ~mean_down steps.  These defaults give region availability ~70-90%.
    region_mean_up_steps: float = 700.0,
    region_mean_down_steps: float = 120.0,
    # zone-local volatility on top of the regional state
    zone_mean_up_steps: float = 900.0,
    zone_mean_down_steps: float = 45.0,
    region_availability: Optional[Mapping[str, float]] = None,
    # a zone joins a regional crunch with this probability (correlation is
    # strong but not perfect — Fig. 3c reports r ~ 0.3-0.6, not 1.0) ...
    crunch_participation: float = 0.85,
    # ... and with a random onset lag (paper: follow-on preemptions arrive
    # within ~minutes of the first, not the same instant)
    crunch_max_lag_steps: int = 5,
    seed: int = 0,
    name: str = "synthetic",
) -> SpotTrace:
    """Generate a trace with intra-region correlated preemptions (Fig. 3).

    Mechanism: each *region* has a hidden 2-state Markov "capacity crunch"
    process.  When a region is in crunch, all its zones lose capacity
    (simultaneous preemption — the §2.2 correlated-preemption signature).
    Each zone additionally has an independent local Markov process, so zones
    also preempt on their own.  Cross-region correlation is ~0 because the
    regional processes are independent.

    ``region_availability`` optionally biases specific regions (e.g. the
    paper's us-west-2 at ~79% availability).
    """
    rng = np.random.default_rng(seed)
    regions = sorted({zone_region[z] for z in zones})

    region_state: Dict[str, np.ndarray] = {}
    for r in regions:
        avail = (region_availability or {}).get(r)
        if avail is None:
            up, down = region_mean_up_steps, region_mean_down_steps
        else:
            # choose mean sojourn times that hit the requested availability
            # while keeping the crunch length realistic (~2h at dt=60)
            down = region_mean_down_steps
            avail = min(max(avail, 0.01), 0.995)
            up = down * avail / (1.0 - avail)
        region_state[r] = _two_state_markov(
            rng, steps, p_up_down=1.0 / up, p_down_up=1.0 / down
        )

    def _zone_view_of_region(region_up: np.ndarray) -> np.ndarray:
        """Per-zone copy of the regional crunch: each crunch segment is
        joined with prob ``crunch_participation`` and a small onset lag."""
        view = np.ones(steps, dtype=np.int8)
        t = 0
        while t < steps:
            if region_up[t] == 0:
                # find the crunch segment [t, e)
                e = t
                while e < steps and region_up[e] == 0:
                    e += 1
                if rng.random() < crunch_participation:
                    lag = int(rng.integers(0, crunch_max_lag_steps + 1))
                    view[min(t + lag, steps) : e] = 0
                t = e
            else:
                t += 1
        return view

    cap = np.zeros((steps, len(zones)), dtype=np.int32)
    for j, z in enumerate(zones):
        local = _two_state_markov(
            rng,
            steps,
            p_up_down=1.0 / zone_mean_up_steps,
            p_down_up=1.0 / zone_mean_down_steps,
        )
        # Partial-capacity wobble: when up, zones occasionally serve fewer
        # than max_capacity instances (quota / partial crunch).  Piecewise
        # constant over multi-hour segments — capacity changes are rare
        # events, not per-minute noise.
        seg_len = max(1, int(6 * 3600 / dt))
        n_seg = steps // seg_len + 1
        seg_vals = rng.integers(
            low=max(1, max_capacity - 1), high=max_capacity + 1, size=n_seg
        )
        partial = np.repeat(seg_vals, seg_len)[:steps]
        zone_region_up = _zone_view_of_region(region_state[zone_region[z]])
        up = (zone_region_up & local).astype(np.int32)
        cap[:, j] = up * np.minimum(max_capacity, partial)
    return SpotTrace(zones=tuple(zones), cap=cap, dt=dt, name=name)


# ---------------------------------------------------------------------------
# The paper's four datasets (synthetic stand-ins, fixed seeds)
# ---------------------------------------------------------------------------

_DAY = 24 * 3600.0


def _aws_zone_map(zs: Sequence[str]) -> Dict[str, str]:
    return {z: z[:-1] for z in zs}  # "us-east-1a" -> "us-east-1"


def _dataset_aws1() -> SpotTrace:
    """AWS 1: 2-week trace, 4 p3.2xlarge, 3 zones (one region)."""
    zones = ["us-west-2a", "us-west-2b", "us-west-2c"]
    return synth_correlated_trace(
        zones,
        _aws_zone_map(zones),
        steps=int(14 * _DAY / 60),
        dt=60.0,
        max_capacity=4,
        region_availability={"us-west-2": 0.79},  # §5.1: unavailable 21% of time
        zone_mean_up_steps=800.0,
        zone_mean_down_steps=50.0,
        seed=101,
        name="aws-1",
    )


def _dataset_aws2() -> SpotTrace:
    """AWS 2: 3-week trace, 16 p3.2xlarge, 3 zones; 33.1% all-zone dropout."""
    zones = ["us-east-1a", "us-east-1c", "us-east-1f"]
    return synth_correlated_trace(
        zones,
        _aws_zone_map(zones),
        steps=int(21 * _DAY / 60),
        dt=60.0,
        max_capacity=16,
        region_availability={"us-east-1": 0.67},  # -> ~33% region dropout
        zone_mean_up_steps=700.0,
        zone_mean_down_steps=60.0,
        crunch_participation=0.97,  # deep region-wide outages (§2.2)
        seed=202,
        name="aws-2",
    )


def _dataset_aws3() -> SpotTrace:
    """AWS 3: 2-month trace, p3.2xlarge, 9 zones across 3 regions."""
    zones = [
        "us-east-1a", "us-east-1c", "us-east-1f",
        "us-east-2a", "us-east-2b",
        "us-west-2a", "us-west-2b", "us-west-2c",
        "eu-central-1a",
    ]
    return synth_correlated_trace(
        zones,
        _aws_zone_map(zones),
        steps=int(60 * _DAY / 300),
        dt=300.0,
        max_capacity=4,
        region_availability={
            "us-east-1": 0.80,
            "us-east-2": 0.88,
            "us-west-2": 0.75,
            "eu-central-1": 0.93,
        },
        zone_mean_up_steps=260.0,
        zone_mean_down_steps=12.0,
        crunch_max_lag_steps=1,   # dt=300s: one step already ~= the paper's
                                  # minutes-scale preemption stagger
        seed=303,
        name="aws-3",
    )


def _dataset_gcp1() -> SpotTrace:
    """GCP 1: 3-day trace, 4 a2-ultragpu-4g, 6 zones (A100 — scarce)."""
    zones = [
        "us-central1-a", "us-central1-b", "us-central1-c",
        "us-west1-a", "us-west1-b",
        "europe-west4-a",
    ]
    zmap = {z: z.rsplit("-", 1)[0] for z in zones}
    return synth_correlated_trace(
        zones,
        zmap,
        steps=int(3 * _DAY / 60),
        dt=60.0,
        max_capacity=4,
        region_availability={
            "us-central1": 0.60,   # A100s: very volatile (Fig. 4)
            "us-west1": 0.50,
            "europe-west4": 0.75,
        },
        zone_mean_up_steps=420.0,
        zone_mean_down_steps=40.0,
        seed=404,
        name="gcp-1",
    )


def _dataset_cpu() -> SpotTrace:
    """Spot *CPU* reference trace (Fig. 4b: 95.6-99.9% available)."""
    zones = ["us-east-1a", "us-east-1c", "us-east-1f"]
    return synth_correlated_trace(
        zones,
        _aws_zone_map(zones),
        steps=int(14 * _DAY / 60),
        dt=60.0,
        max_capacity=16,
        region_availability={"us-east-1": 0.999},
        zone_mean_up_steps=4000.0,
        zone_mean_down_steps=8.0,
        seed=505,
        name="cpu-ref",
    )


_DATASETS = {
    "aws-1": _dataset_aws1,
    "aws-2": _dataset_aws2,
    "aws-3": _dataset_aws3,
    "gcp-1": _dataset_gcp1,
    "cpu-ref": _dataset_cpu,
}


_TRACE_CACHE: Dict[str, SpotTrace] = {}


class TraceLibrary:
    """Named access to the benchmark trace datasets (memoized).

    The cache is process-global: the synthetic generators walk a Markov
    chain over every trace step, so regenerating a multi-week dataset per
    ``TraceLibrary()`` instantiation (one per scenario cell) would dwarf
    the simulation itself.  Traces are treated as immutable by all
    consumers (slicing copies).
    """

    def __init__(self) -> None:
        self._cache: Dict[str, SpotTrace] = _TRACE_CACHE

    def names(self) -> List[str]:
        return sorted(_DATASETS)

    def get(self, name: str) -> SpotTrace:
        if name not in self._cache:
            if name not in _DATASETS:
                raise KeyError(
                    f"unknown trace {name!r}; have {sorted(_DATASETS)}"
                )
            self._cache[name] = _DATASETS[name]()
        return self._cache[name]


def load_trace(name_or_path: str) -> SpotTrace:
    """Load a trace by dataset name, .npz path, or .json path."""
    if name_or_path in _DATASETS:
        return TraceLibrary().get(name_or_path)
    if name_or_path.endswith(".json"):
        return SpotTrace.from_json(name_or_path)
    return SpotTrace.load(name_or_path)


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.cluster.traces [name ...]
# ---------------------------------------------------------------------------


def _print_stats(stats: Dict[str, object]) -> None:
    print(
        f"{stats['name']}: {stats['steps']} steps x {stats['dt_s']:g}s "
        f"({stats['duration_days']:g} days), "
        f"mean availability {stats['mean_availability']:.2%}"
    )
    print(
        f"  {'zone':<16s} {'region':<14s} {'avail':>7s} "
        f"{'preempt/day':>12s} {'sibling r':>10s}"
    )
    for z, s in stats["zones"].items():  # type: ignore[union-attr]
        print(
            f"  {z:<16s} {s['region']:<14s} {s['availability']:7.2%} "
            f"{s['preemptions_per_day']:12.2f} {s['mean_sibling_corr']:10.3f}"
        )


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Per-zone availability / preemption-rate / "
        "sibling-correlation stats of the benchmark traces"
    )
    ap.add_argument(
        "traces", nargs="*",
        help="named datasets or .json/.npz trace paths "
        "(default: every named dataset)",
    )
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON document instead of tables")
    args = ap.parse_args(argv)

    names = args.traces or TraceLibrary().names()
    all_stats = [trace_stats(load_trace(n)) for n in names]
    if args.json:
        print(json.dumps(all_stats, indent=1))
    else:
        for stats in all_stats:
            _print_stats(stats)
    return 0


if __name__ == "__main__":
    import sys

    # ``python -m repro_torch.cluster.traces`` re-executes this file as
    # ``__main__`` after the package __init__ already imported the
    # canonical module; delegate so the CLI runs with the canonical
    # SpotTrace / TraceLibrary (one cache, one class identity), not
    # this duplicate copy.
    from repro_torch.cluster.traces import main as _canonical_main

    sys.exit(_canonical_main())
