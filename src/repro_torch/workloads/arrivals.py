"""Request arrival processes: the port's own copy of
``repro.workloads.arrivals``.

* ``PoissonWorkload`` — homogeneous Poisson arrivals.
* ``ArenaWorkload``   — Chatbot-Arena-like bursty traffic: a
  Markov-modulated Poisson process (quiet / normal / burst regimes) with
  occasional spike minutes.
* ``MAFWorkload``     — Azure-Functions-like diurnal traffic with
  invocation spikes and shorter outputs.

The draws are the reference's, in the reference's order, from numpy's
``default_rng(seed)``: a tape made here from a seed is the reference's tape
to the bit (arrival times, token lengths and client regions).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import List, Mapping, Optional, Sequence, Union

import numpy as np

_req_ids = itertools.count()

# client_regions accepts {region: weight} or a bare region sequence
ClientRegions = Union[Mapping[str, float], Sequence[str]]


@dataclasses.dataclass
class Request:
    arrival_s: float
    prompt_tokens: int
    output_tokens: int
    id: int = dataclasses.field(default_factory=lambda: next(_req_ids))
    client_region: str = "us-west-2"

    @property
    def total_tokens(self) -> int:
        return self.prompt_tokens + self.output_tokens


class Workload:
    """Base class: generate requests over [0, duration_s).

    ``client_regions`` mixes request origins across regions, as a
    ``{region: weight}`` mapping or a bare region list (equal weights).
    ``None`` sends every request from ``us-west-2`` and draws nothing: the
    regions come from their own stream derived from ``seed``, so arrival
    times and token lengths do not depend on the mixture.
    """

    name = "workload"

    def __init__(self, seed: int = 0,
                 client_regions: Optional[ClientRegions] = None) -> None:
        self.seed = seed
        self.client_regions: Optional[List[str]] = None
        self._region_probs: Optional[np.ndarray] = None
        if client_regions is not None:
            if isinstance(client_regions, Mapping):
                regions = list(client_regions)
                weights = [float(client_regions[r]) for r in regions]
            else:
                regions = list(client_regions)
                weights = [1.0] * len(regions)
            if not regions:
                raise ValueError("client_regions must name >= 1 region")
            if any(not r or not isinstance(r, str) for r in regions):
                raise ValueError(
                    f"client_regions entries must be non-empty region "
                    f"strings, got {regions!r}"
                )
            if any(w < 0 for w in weights) or sum(weights) <= 0:
                raise ValueError(
                    f"client_regions weights must be >= 0 and sum > 0, "
                    f"got {weights!r}"
                )
            self.client_regions = regions
            self._region_probs = (
                np.asarray(weights, dtype=np.float64) / sum(weights)
            )

    def _assign_regions(self, requests: List[Request]) -> List[Request]:
        """Stamp client regions from the mixture (no-op by default)."""
        if self.client_regions is None or not requests:
            return requests
        rng = np.random.default_rng([int(self.seed) & 0x7FFFFFFF, 0xC119])
        picks = rng.choice(
            len(self.client_regions), size=len(requests),
            p=self._region_probs,
        )
        for req, k in zip(requests, picks):
            req.client_region = self.client_regions[int(k)]
        return requests

    def generate(self, duration_s: float) -> List[Request]:
        raise NotImplementedError

    @staticmethod
    def _sample_lengths(
        rng: np.random.Generator, n: int,
        prompt_mu: float = 5.3, prompt_sigma: float = 1.0,
        out_mu: float = 5.0, out_sigma: float = 0.8,
        max_tokens: int = 2048,
    ) -> tuple:
        """Lognormal token lengths (Arena-like medians ~200/150 tokens)."""
        p = np.clip(
            rng.lognormal(prompt_mu, prompt_sigma, n).astype(int), 1,
            max_tokens,
        )
        o = np.clip(
            rng.lognormal(out_mu, out_sigma, n).astype(int), 1, max_tokens
        )
        return p, o


class PoissonWorkload(Workload):
    """Homogeneous Poisson arrivals (§5.2: λ = 0.15)."""

    name = "poisson"

    def __init__(self, rate_per_s: float = 0.15, seed: int = 0,
                 client_regions: Optional[ClientRegions] = None) -> None:
        super().__init__(seed, client_regions=client_regions)
        if rate_per_s <= 0:
            raise ValueError("rate must be positive")
        self.rate = float(rate_per_s)

    def generate(self, duration_s: float) -> List[Request]:
        rng = np.random.default_rng(self.seed)
        n_expect = int(self.rate * duration_s * 1.3) + 16
        gaps = rng.exponential(1.0 / self.rate, n_expect)
        times = np.cumsum(gaps)
        times = times[times < duration_s]
        p, o = self._sample_lengths(rng, len(times))
        return self._assign_regions([
            Request(arrival_s=float(t), prompt_tokens=int(pi),
                    output_tokens=int(oi))
            for t, pi, oi in zip(times, p, o)
        ])


class ArenaWorkload(Workload):
    """Markov-modulated Poisson: bursty Chatbot-Arena-like traffic.

    Three regimes (quiet / normal / burst) with mean rates ``base_rate *
    REGIME_MULT`` and exponential sojourn times; within a regime, Poisson
    arrivals minute by minute, a minute a spike with ``spike_prob``."""

    name = "arena"

    REGIME_MULT = (0.4, 1.0, 2.0)
    REGIME_MEAN_S = (1800.0, 3600.0, 900.0)
    TRANSITION = np.array(
        [
            [0.0, 0.9, 0.1],
            [0.4, 0.0, 0.6],
            [0.1, 0.9, 0.0],
        ]
    )

    def __init__(self, base_rate_per_s: float = 0.3, seed: int = 0,
                 spike_prob: float = 0.002, spike_mult: float = 12.0,
                 client_regions: Optional[ClientRegions] = None) -> None:
        super().__init__(seed, client_regions=client_regions)
        self.base_rate = float(base_rate_per_s)
        self.spike_prob = float(spike_prob)
        self.spike_mult = float(spike_mult)

    def generate(self, duration_s: float) -> List[Request]:
        rng = np.random.default_rng(self.seed)
        t, regime = 0.0, 1
        out: List[Request] = []
        while t < duration_s:
            sojourn = rng.exponential(self.REGIME_MEAN_S[regime])
            end = min(t + sojourn, duration_s)
            rate = self.base_rate * self.REGIME_MULT[regime]
            seg = t
            while seg < end:
                seg_end = min(seg + 60.0, end)
                r = rate * (
                    self.spike_mult if rng.random() < self.spike_prob else 1.0
                )
                n = rng.poisson(r * (seg_end - seg))
                times = rng.uniform(seg, seg_end, n)
                p, o = self._sample_lengths(rng, n)
                out.extend(
                    Request(arrival_s=float(tt), prompt_tokens=int(pi),
                            output_tokens=int(oi))
                    for tt, pi, oi in zip(times, p, o)
                )
                seg = seg_end
            regime = int(rng.choice(3, p=self.TRANSITION[regime]))
            t = end
        out.sort(key=lambda r: r.arrival_s)
        return self._assign_regions(out)


class MAFWorkload(Workload):
    """Azure-Functions-like diurnal workload with invocation spikes."""

    name = "maf"

    def __init__(self, base_rate_per_s: float = 0.25, seed: int = 0,
                 diurnal_depth: float = 0.8,
                 spike_prob_per_min: float = 0.004,
                 spike_mult: float = 20.0,
                 client_regions: Optional[ClientRegions] = None) -> None:
        super().__init__(seed, client_regions=client_regions)
        self.base_rate = float(base_rate_per_s)
        self.depth = float(diurnal_depth)
        self.spike_prob = float(spike_prob_per_min)
        self.spike_mult = float(spike_mult)

    def _rate(self, t: float) -> float:
        phase = 2.0 * math.pi * (t % 86400.0) / 86400.0
        return self.base_rate * (
            1.0 - self.depth * 0.5 * (1.0 + math.cos(phase))
            + self.depth
        )

    def generate(self, duration_s: float) -> List[Request]:
        rng = np.random.default_rng(self.seed)
        out: List[Request] = []
        t = 0.0
        while t < duration_s:
            end = min(t + 60.0, duration_s)
            r = self._rate(t)
            if rng.random() < self.spike_prob:
                r *= self.spike_mult
            n = rng.poisson(r * (end - t))
            times = rng.uniform(t, end, n)
            # serverless-style shorter outputs
            p, o = self._sample_lengths(rng, n, out_mu=4.2)
            out.extend(
                Request(arrival_s=float(tt), prompt_tokens=int(pi),
                        output_tokens=int(oi))
                for tt, pi, oi in zip(times, p, o)
            )
            t = end
        out.sort(key=lambda r: r.arrival_s)
        return self._assign_regions(out)


_WORKLOADS = {
    "poisson": PoissonWorkload,
    "arena": ArenaWorkload,
    "maf": MAFWorkload,
}


def make_workload(name: str, **kwargs) -> Workload:
    if name not in _WORKLOADS:
        raise KeyError(f"unknown workload {name!r}; have {sorted(_WORKLOADS)}")
    return _WORKLOADS[name](**kwargs)


def interarrival_stats(requests: List[Request]) -> dict:
    """Gap statistics of a tape (the reference's Fig. 11 summary)."""
    if len(requests) < 2:
        return {"n": len(requests)}
    times = np.array([r.arrival_s for r in requests])
    gaps = np.diff(times)
    return {
        "n": len(requests),
        "mean_gap_s": float(gaps.mean()),
        "p50_gap_s": float(np.percentile(gaps, 50)),
        "p99_gap_s": float(np.percentile(gaps, 99)),
        "cv": float(gaps.std() / max(gaps.mean(), 1e-9)),
        "peak_to_mean": float(
            np.histogram(times, bins=max(int(times[-1] // 60), 1))[0].max()
            / max(len(requests) / max(times[-1] / 60.0, 1e-9), 1e-9)
        ),
    }
