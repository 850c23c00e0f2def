"""The end-to-end metrics, from the client's own clock over the whole window.

* ``tokens_per_s`` (``tokens_per_s.<cell>``): tokens that reached the
  client in the window, over the window's seconds (from its opening to its
  close); the tokens of an attempt that a preemption discarded do not
  count.
* ``tpot_p<q>_ms``: the q-th percentile of every gap between consecutive
  tokens of every attempt, both tokens inside the window.
* ``ttft_p<q>_ms``: the q-th percentile, over every request due in the
  window, of the time from its due time to the first token of its last
  attempt; a request with none by the window's end counts the time it has
  waited until then.
* ``setup_s``: from the process's start to the window's opening.

Percentiles are numpy's (linear between the two nearest ranks), over all
samples.
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np


def window_tokens(win) -> int:
    return sum(1 for a in win.attempts if not a.discarded
               for t in a.times if win.start <= t <= win.close)


def tokens_per_s(win) -> float:
    return window_tokens(win) / (win.close - win.start)


def token_gaps(win) -> List[float]:
    return [b - a for att in win.attempts
            for a, b in zip(att.times, att.times[1:])
            if a >= win.start and b <= win.close]


def ttfts(win) -> List[float]:
    out = []
    for rid, due in win.due.items():
        a = win.final.get(rid)
        first = a.times[0] if a is not None and a.times[0] <= win.close else win.close
        out.append(first - due)
    return out


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def value(name: str, win, setup_s: float) -> float:
    name = name.split(".")[0]
    if name == "tokens_per_s":
        return tokens_per_s(win)
    if name == "setup_s":
        return setup_s
    kind, q = re.fullmatch(r"(tpot|ttft)_p(\d+)_ms", name).groups()
    return 1e3 * percentile(token_gaps(win) if kind == "tpot" else ttfts(win),
                            float(q))


def compute(names, win, setup_s: float) -> Dict[str, float]:
    return {n: value(n, win, setup_s) for n in names}
