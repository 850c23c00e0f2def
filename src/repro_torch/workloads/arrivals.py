"""Request arrival processes: the port's own copy of ``Request``,
``Workload`` and ``PoissonWorkload`` from ``repro.workloads.arrivals``.

The draws are the reference's, in the reference's order, from numpy's
``default_rng(seed)``: a tape made here from a seed is the reference's tape
to the bit (arrival times, token lengths and client regions).  The bursty
Arena and diurnal MAF workloads are not ported yet.
"""

from __future__ import annotations

import dataclasses
import itertools
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


_WORKLOADS = {"poisson": PoissonWorkload}


def make_workload(name: str, **kwargs) -> Workload:
    if name not in _WORKLOADS:
        raise KeyError(f"unknown workload {name!r}; the port has "
                       f"{sorted(_WORKLOADS)}")
    return _WORKLOADS[name](**kwargs)
