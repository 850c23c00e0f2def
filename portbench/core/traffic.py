"""The one traffic generator: reads a mix's parameters
(``portbench/traffic/<mix>.json``) and makes a run's requests from its seed.

The lengths are the port's lognormal ones (``workloads/arrivals.py``
``Workload._sample_lengths``: ``lognormal(mu, sigma).astype(int)``, then
clipped) and the arrivals its homogeneous Poisson process (exponential
gaps), drawn as a trace is: the distributions' quantiles at (i + 0.5) / n,
put in an order that ``--seed`` draws.  So every seed sends the same set
of prompt lengths, answer lengths and gaps between arrivals, each seed in
its own order, and the seed also draws what the requests say (the
prompts' tokens), the weights and the checked sample.

A mix may ask for a backlog: requests admitted in set-up, one per serving
slot, so that a window above the program's capacity opens in steady state.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    due_s: float            # seconds after the window opens; backlog: 0
    prompt: np.ndarray      # token ids, int64
    out_tokens: int         # tokens generated in all, the first by prefill
    backlog: bool = False


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def lognormal_lengths(n: int, spec: dict, rng: np.random.Generator) -> np.ndarray:
    """The lognormal(mu, sigma) quantiles of ``n`` stratified levels,
    truncated to ints and clipped to [min, max], in the seed's order."""
    inv = NormalDist().inv_cdf
    vals = [math.exp(spec["mu"] + spec["sigma"] * inv(q)) for q in _quantiles(n)]
    lengths = np.clip(np.array(vals).astype(np.int64), spec["min"], spec["max"])
    return rng.permutation(lengths)


def exponential_gaps(n: int, rate: float) -> np.ndarray:
    return -np.log1p(-_quantiles(n)) / rate


def poisson_due(n: int, rate: float, rng: np.random.Generator) -> np.ndarray:
    """Due times of ``n`` arrivals at ``rate``: the exponential gaps'
    quantiles in the seed's order, summed."""
    return np.cumsum(rng.permutation(exponential_gaps(n, rate)))


def backlog_size(mix: dict) -> int:
    reps = mix["replicas"]
    return reps["serving"] * reps["slots"] if mix.get("backlog") else 0


def arrivals_in(mix: dict, seconds: float) -> int:
    """rate x seconds arrivals, fewer if their gaps would not all fit in
    the window (the same count for every seed: the gaps' sum does not
    depend on their order)."""
    rate = mix["arrivals"]["rate_per_s"]
    n = max(1, int(round(rate * seconds)))
    while n > 1 and exponential_gaps(n, rate).sum() >= seconds:
        n -= 1
    return n


def make_requests(mix: dict, seconds: float, seed: int, vocab: int, *,
                  stream: int = 0, first_rid: int = 0,
                  after_s: float = 0.0) -> List[Request]:
    """The run's requests: the backlog (due 0) and then the window's
    arrivals in due order, lengths, gaps and tokens drawn from ``seed``.
    ``stream`` 1 makes the arrivals that follow the window in a traced run
    (no backlog; ids from ``first_rid``, due ``after_s`` and later)."""
    if mix["arrivals"]["process"] != "poisson":
        raise ValueError(f"unknown arrival process {mix['arrivals']['process']!r}")
    rng = [np.random.default_rng(s) for s in np.random.SeedSequence(
        [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, 0x9E37, stream]).spawn(6)]
    n_back = backlog_size(mix) if stream == 0 else 0
    n = arrivals_in(mix, seconds)
    due = after_s + poisson_due(n, mix["arrivals"]["rate_per_s"], rng[0])
    p_len = lognormal_lengths(n, mix["prompt_tokens"], rng[1])
    o_len = lognormal_lengths(n, mix["output_tokens"], rng[2])
    reqs: List[Request] = []
    if n_back:
        bp = lognormal_lengths(n_back, mix["prompt_tokens"], rng[3])
        bo = lognormal_lengths(n_back, mix["output_tokens"], rng[4])
        for i in range(n_back):
            reqs.append(Request(first_rid + i, 0.0,
                                rng[5].integers(0, vocab, int(bp[i])),
                                int(bo[i]), backlog=True))
    for t, p, o in zip(due, p_len, o_len):
        reqs.append(Request(first_rid + len(reqs), float(t),
                            rng[5].integers(0, vocab, int(p)), int(o)))
    return reqs
