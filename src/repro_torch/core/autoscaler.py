"""Load-based autoscaler with hysteresis (§4 "Autoscaler"): the port's own
copy of ``repro.core.autoscaler``.

``N_Can = ceil(R_t / Q_Tar)`` where ``R_t`` is the average request rate over
a trailing window (default 60 s).  ``N_Tar`` only moves to ``N_Can`` after
the candidate has been consistently above (below) the current target for
``upscale_delay_s`` (``downscale_delay_s``) — the paper quotes ~10 minutes
of consistency before changing the target.
"""

from __future__ import annotations

import collections
import math
from typing import Deque, Optional, Tuple


class Autoscaler:
    """Interface: ``observe`` request arrivals, ``target`` returns N_Tar."""

    def observe(self, now: float, num_requests: int) -> None:
        raise NotImplementedError

    def observe_batch(self, events: "list[Tuple[float, int]]") -> None:
        """Record several ``(now, num_requests)`` observations at once.

        Equivalent to calling :meth:`observe` per event in order (events
        must be time-ordered); exists so hot loops can amortize the call
        overhead between target() reads.
        """
        for now, n in events:
            self.observe(now, n)

    def target(self, now: float) -> int:
        raise NotImplementedError


class ConstantTarget(Autoscaler):
    """Fixed N_Tar (used by the §5.2 policy benchmarks)."""

    def __init__(self, n_target: int) -> None:
        self.n_target = int(n_target)

    def observe(self, now: float, num_requests: int) -> None:
        pass

    def observe_batch(self, events: "list[Tuple[float, int]]") -> None:
        pass

    def target(self, now: float) -> int:
        return self.n_target


class LoadAutoscaler(Autoscaler):
    """The paper's QPS autoscaler with hysteresis."""

    def __init__(
        self,
        target_qps_per_replica: float,
        *,
        window_s: float = 60.0,
        upscale_delay_s: float = 300.0,
        downscale_delay_s: float = 1200.0,
        min_replicas: int = 1,
        max_replicas: int = 1_000,
        initial_target: Optional[int] = None,
    ) -> None:
        if target_qps_per_replica <= 0:
            raise ValueError("target_qps_per_replica must be positive")
        self.q_tar = float(target_qps_per_replica)
        self.window_s = float(window_s)
        self.upscale_delay_s = float(upscale_delay_s)
        self.downscale_delay_s = float(downscale_delay_s)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self._events: Deque[Tuple[float, int]] = collections.deque()
        self._n_tar = int(initial_target or min_replicas)
        # time at which the candidate first diverged in the current direction
        self._diverged_since: Optional[float] = None
        self._diverge_dir = 0

    # ------------------------------------------------------------------
    def observe(self, now: float, num_requests: int) -> None:
        if num_requests > 0:
            self._events.append((now, num_requests))
        self._evict(now)

    def observe_batch(self, events: "list[Tuple[float, int]]") -> None:
        # eviction is idempotent and driven by `now`, so appending the
        # whole (time-ordered) batch and evicting once at the latest time
        # leaves the window in exactly the per-call state
        if events:
            self._events.extend(e for e in events if e[1] > 0)
            self._evict(events[-1][0])

    def _evict(self, now: float) -> None:
        # half-open window (now - window_s, now]
        while self._events and self._events[0][0] <= now - self.window_s:
            self._events.popleft()

    def _rate(self, now: float) -> float:
        self._evict(now)
        total = sum(n for _, n in self._events)
        return total / self.window_s

    def candidate(self, now: float) -> int:
        n_can = math.ceil(self._rate(now) / self.q_tar)
        return max(self.min_replicas, min(self.max_replicas, n_can))

    # ------------------------------------------------------------------
    def target(self, now: float) -> int:
        n_can = self.candidate(now)
        if n_can == self._n_tar:
            self._diverged_since, self._diverge_dir = None, 0
            return self._n_tar
        direction = 1 if n_can > self._n_tar else -1
        if direction != self._diverge_dir:
            self._diverged_since, self._diverge_dir = now, direction
            return self._n_tar
        assert self._diverged_since is not None
        held = now - self._diverged_since
        delay = (
            self.upscale_delay_s if direction > 0 else self.downscale_delay_s
        )
        if held >= delay:
            self._n_tar = n_can
            self._diverged_since, self._diverge_dir = None, 0
        return self._n_tar
