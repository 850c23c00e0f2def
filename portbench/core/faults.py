"""Faults planted under the timed path, for the tests and ``readings.py``
to see that the comparison reads them as not correct (not part of the
benchmark's runs).

Each works on a replica built and captured before it is planted: it wraps
the program's Python calls around the replay, never what a graph holds.

* ``stale``: a decode step that leaves its state unchanged (the cache's
  length does not advance, so the next step writes over this one's slot).
* ``half``: a replica's step that leaves out half of its requests in
  flight; they repeat their last token instead of decoding.
* ``alter``: every fifth decode step's token altered where the step makes
  it.

``plant(name, put)`` plants a fault with ``put(owner, attr, value)`` (a
test's ``monkeypatch.setattr``); ``planted(name)`` plants it for a
``with`` block.
"""

from __future__ import annotations

import contextlib


def _stale(put) -> None:
    from repro_torch.launch.steps import ServeStep

    orig = ServeStep.__call__

    def call(self, tokens=None):
        out = orig(self, tokens)
        self.cache["len"].sub_(1)
        return out

    put(ServeStep, "__call__", call)


def _half(put) -> None:
    from repro_torch.serving.live import LiveReplica

    orig = LiveReplica.step

    def step(self):
        n = (len(self.inflight) + 1) // 2
        left = self.inflight[n:]
        self.inflight = self.inflight[:n]
        done = orig(self)
        for r in left:
            r.out.append(r.out[-1])
            r.length += 1
            r.remaining -= 1
            if r.remaining <= 0:
                done.append((r.req_id, r.out))
                self.free.append(r.slot)
            else:
                self.inflight.append(r)
        return done

    put(LiveReplica, "step", step)


def _alter(put) -> None:
    from repro_torch.launch.steps import ServeStep

    orig = ServeStep.__call__
    calls = [0]

    def call(self, tokens=None):
        out = orig(self, tokens)
        calls[0] += 1
        if calls[0] % 5 == 0:
            out.copy_(out + 1 - 2 * (out > 0).long())
        return out

    put(ServeStep, "__call__", call)


FAULTS = {"stale": _stale, "half": _half, "alter": _alter}


def plant(name: str, put) -> None:
    FAULTS[name](put)


@contextlib.contextmanager
def planted(name: str):
    saved = []

    def put(owner, attr, value):
        saved.append((owner, attr, owner.__dict__[attr]))
        setattr(owner, attr, value)

    plant(name, put)
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
