"""The built-in forecasters, persistence, EWMA and regional Markov: the
port's own copy of ``repro.forecast.estimators``.

* ``PersistenceForecaster``: the no-skill baseline, whatever a zone did
  last it keeps doing (hard 0/1 probabilities).
* ``EWMAForecaster``: per-zone exponentially weighted availability mean and
  down-transition hazard; forecasts relax from the current state toward
  the long-run mean as the horizon grows.
* ``MarkovRegionalForecaster``: a 2-state Markov chain per zone with online
  transition estimates, conditioned on whether a sibling zone of the same
  region is down (regional crunches hit sibling zones together, Fig. 3).

Every update and prediction is float64 Python arithmetic in the
reference's order, so the scores are the reference's to the bit.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.forecast.base import (
    Forecaster,
    ZoneForecast,
    register_forecaster,
)

__all__ = [
    "PersistenceForecaster",
    "EWMAForecaster",
    "MarkovRegionalForecaster",
]


class _ZoneStateMixin(Forecaster):
    """Shared per-zone last-observed-state bookkeeping."""

    def reset(self, zones, zone_region=None, dt: float = 60.0) -> None:
        super().reset(zones, zone_region, dt)
        self._state: Dict[str, Optional[bool]] = {z: None for z in zones}
        self._seen_at: Dict[str, float] = {}

    def _note(self, now: float, zone: str, up: bool) -> None:
        self._state[zone] = up
        self._seen_at[zone] = now


@register_forecaster
class PersistenceForecaster(_ZoneStateMixin):
    """Predict that the last observed state persists indefinitely.

    ``prior`` is returned for zones never observed (0.5 = "no idea").
    """

    name = "persistence"

    def __init__(self, prior: float = 0.5) -> None:
        super().__init__()
        self.prior = float(prior)
        if not 0.0 <= self.prior <= 1.0:
            raise ValueError(f"prior must be a probability, got {prior}")

    def observe(self, now: float, available: Mapping[str, bool]) -> None:
        for zone, up in available.items():
            if zone in self._state:
                self._note(now, zone, bool(up))

    def _predict_zone(
        self, zone: str, now: float, horizon_s: float
    ) -> ZoneForecast:
        s = self._state[zone]
        if s is None:
            p_avail = self.prior
        else:
            p_avail = 1.0 if s else 0.0
        # persistence claims nothing ever changes: a running instance is
        # never preempted unless the zone is already observed down
        return ZoneForecast(
            zone=zone,
            p_available=p_avail,
            p_preempt=1.0 - p_avail,
        )


@register_forecaster
class EWMAForecaster(_ZoneStateMixin):
    """Per-zone EW availability mean + EW preemption hazard.

    State updates use irregular-interval exponential decay (the policy
    path observes zones at uneven times), expressed via half-lives:

    * ``halflife_s``     — memory of the availability mean;
    * ``mix_halflife_s`` — how fast a forecast relaxes from the current
      state toward the long-run mean as the horizon grows;
    * the hazard estimator counts down-transitions per second of observed
      up-time, decayed with ``halflife_s``.
    """

    name = "ewma"

    def __init__(
        self,
        halflife_s: float = 6 * 3600.0,
        mix_halflife_s: float = 1800.0,
        prior: float = 0.5,
    ) -> None:
        super().__init__()
        if halflife_s <= 0 or mix_halflife_s <= 0:
            raise ValueError("half-lives must be positive")
        if not 0.0 <= prior <= 1.0:
            raise ValueError(f"prior must be a probability, got {prior}")
        self.halflife_s = float(halflife_s)
        self.mix_halflife_s = float(mix_halflife_s)
        self.prior = float(prior)

    def reset(self, zones, zone_region=None, dt: float = 60.0) -> None:
        super().reset(zones, zone_region, dt)
        self._mean: Dict[str, float] = {z: self.prior for z in zones}
        # EW (down-transition count, observed up-seconds) per zone
        self._haz_events: Dict[str, float] = {z: 0.0 for z in zones}
        self._haz_time: Dict[str, float] = {z: 0.0 for z in zones}

    def observe(self, now: float, available: Mapping[str, bool]) -> None:
        ln2 = math.log(2.0)
        for zone, up_raw in available.items():
            if zone not in self._state:
                continue
            up = bool(up_raw)
            prev = self._state[zone]
            # same-instant duplicates (k preemptions of one zone arrive as
            # k events at one tick): latest evidence wins, but only one
            # observation may move the statistics or the k-1 repeats
            # masquerade as extra dt-spaced steps
            if prev is not None and now <= self._seen_at.get(zone, now):
                self._note(now, zone, up)
                continue
            gap = max(now - self._seen_at.get(zone, now), 0.0)
            decay = math.exp(-ln2 * gap / self.halflife_s)
            w = 1.0 - math.exp(-ln2 * max(gap, self._dt) / self.halflife_s)
            self._mean[zone] += w * ((1.0 if up else 0.0) - self._mean[zone])
            self._haz_events[zone] *= decay
            self._haz_time[zone] *= decay
            if prev is True:
                # the elapsed gap was observed up-time; a flip to down is
                # one preemption event in that exposure window
                self._haz_time[zone] += max(gap, self._dt)
                if not up:
                    self._haz_events[zone] += 1.0
            self._note(now, zone, up)

    def _hazard(self, zone: str) -> float:
        """Down-transitions per second of up-time (with a weak prior of
        one event per week so unseen zones aren't scored risk-free)."""
        prior_events, prior_time = 1.0, 7 * 24 * 3600.0
        return (self._haz_events[zone] + prior_events) / (
            self._haz_time[zone] + prior_time
        )

    def _predict_zone(
        self, zone: str, now: float, horizon_s: float
    ) -> ZoneForecast:
        s = self._state[zone]
        mean = self._clip(self._mean[zone])
        if s is None:
            p_avail = mean
        else:
            # relax from the current state toward the long-run mean over
            # the *effective* horizon (staleness since last sighting
            # counts — old knowledge is worth less)
            h_eff = horizon_s + max(now - self._seen_at.get(zone, now), 0.0)
            w = math.exp(-math.log(2.0) * h_eff / self.mix_halflife_s)
            p_avail = self._clip(w * (1.0 if s else 0.0) + (1.0 - w) * mean)
        if s is False:
            p_preempt = 1.0
        else:
            p_preempt = self._clip(
                1.0 - math.exp(-self._hazard(zone) * horizon_s)
            )
        return ZoneForecast(
            zone=zone, p_available=p_avail, p_preempt=p_preempt
        )


@register_forecaster
class MarkovRegionalForecaster(_ZoneStateMixin):
    """Online 2-state Markov chain per zone, sibling-crunch conditioned.

    Transition statistics are kept in two buckets per zone: *calm* (no
    sibling zone of the same region observed down) and *crunch* (at least
    one sibling down).  Each bucket's up->down probability ``p`` and
    down->up probability ``q`` is estimated with hierarchical smoothing —
    bucket counts shrink toward the zone's pooled estimate, which shrinks
    toward a weak global prior — so the crunch bucket only departs from
    the calm one once the data shows sibling correlation.

    Prediction uses the closed-form n-step transition of the 2-state
    chain: with ``r = 1 - p - q`` and stationary availability
    ``pi = q / (p + q)``,

        P(up at n | up now)   = pi + (1 - pi) * r**n
        P(up at n | down now) = pi - pi * r**n

    Staleness folds in naturally: ``n`` counts steps since the zone was
    last *observed*, so an old sighting decays toward ``pi``.
    """

    name = "markov"

    #: pseudo-count strength of the bucket->pooled and pooled->global
    #: shrinkage, in observations
    smoothing: float = 20.0
    #: weak global priors: rare transitions in both directions
    prior_p_down: float = 0.02      # up -> down per step
    prior_p_up: float = 0.10        # down -> up per step

    def __init__(self, smoothing: Optional[float] = None) -> None:
        super().__init__()
        if smoothing is not None:
            if smoothing <= 0:
                raise ValueError("smoothing must be positive")
            self.smoothing = float(smoothing)

    def reset(self, zones, zone_region=None, dt: float = 60.0) -> None:
        super().reset(zones, zone_region, dt)
        # counts[zone][bucket] = [n_uu, n_ud, n_dd, n_du]
        self._counts: Dict[str, Dict[str, list]] = {
            z: {"calm": [0.0] * 4, "crunch": [0.0] * 4} for z in zones
        }
        self._sibs: Dict[str, Tuple[str, ...]] = {
            z: tuple(self._siblings(z)) for z in zones
        }
        # smoothed (p, q) per (zone, bucket), invalidated on observe —
        # predict() is called once per horizon per backtest step, and
        # the hierarchical smoothing is the dominant cost
        self._rates_cache: Dict[Tuple[str, str], Tuple[float, float]] = {}

    # -- state updates ---------------------------------------------------
    def _bucket(self, zone: str) -> str:
        return (
            "crunch"
            if any(self._state[s] is False for s in self._sibs[zone])
            else "calm"
        )

    def observe(self, now: float, available: Mapping[str, bool]) -> None:
        # condition on sibling states *before* this row lands, so a
        # simultaneous region-wide drop is attributed to the calm bucket
        # (the first domino) while the crunch bucket captures persistence
        # and follow-on drops — the predictive part of the correlation
        self._rates_cache.clear()
        buckets = {
            z: self._bucket(z) for z in available if z in self._state
        }
        for zone, up_raw in available.items():
            if zone not in self._state:
                continue
            up = bool(up_raw)
            prev = self._state[zone]
            gap = now - self._seen_at.get(zone, now)
            # 0 < gap: same-instant duplicate events must not count as
            # extra dt-spaced transitions; <= 3 dt: stale pairs carry no
            # per-step transition information
            if prev is not None and 0.0 < gap <= 3.0 * self._dt:
                c = self._counts[zone][buckets[zone]]
                if prev and up:
                    c[0] += 1.0
                elif prev and not up:
                    c[1] += 1.0
                elif not prev and not up:
                    c[2] += 1.0
                else:
                    c[3] += 1.0
            self._note(now, zone, up)

    # -- estimation ------------------------------------------------------
    def _rates(self, zone: str, bucket: str) -> Tuple[float, float]:
        """(p, q) = (up->down, down->up) per-step probabilities for the
        zone under ``bucket``, hierarchically smoothed (memoized until
        the next observation)."""
        cached = self._rates_cache.get((zone, bucket))
        if cached is not None:
            return cached
        w = self.smoothing
        pooled = [0.0] * 4
        for b in ("calm", "crunch"):
            for i, v in enumerate(self._counts[zone][b]):
                pooled[i] += v
        p_pool = (pooled[1] + w * self.prior_p_down) / (
            pooled[0] + pooled[1] + w
        )
        q_pool = (pooled[3] + w * self.prior_p_up) / (
            pooled[2] + pooled[3] + w
        )
        c = self._counts[zone][bucket]
        p = (c[1] + w * p_pool) / (c[0] + c[1] + w)
        q = (c[3] + w * q_pool) / (c[2] + c[3] + w)
        eps = 1e-6
        out = (min(max(p, eps), 1.0 - eps), min(max(q, eps), 1.0 - eps))
        self._rates_cache[(zone, bucket)] = out
        return out

    # -- prediction ------------------------------------------------------
    def _predict_zone(
        self, zone: str, now: float, horizon_s: float
    ) -> ZoneForecast:
        p, q = self._rates(zone, self._bucket(zone))
        pi = q / (p + q)
        r = 1.0 - p - q
        s = self._state[zone]
        stale_s = max(now - self._seen_at.get(zone, now), 0.0)
        n = max(1, int(round((horizon_s + stale_s) / self._dt)))
        if s is None:
            p_avail = pi
        elif s:
            p_avail = pi + (1.0 - pi) * r ** n
        else:
            p_avail = pi - pi * r ** n
        # preemption risk of an instance running *now*: survival of the
        # up state over the horizon itself (staleness excluded — the live
        # instance is the freshest possible up-observation)
        n_h = max(1, int(round(horizon_s / self._dt)))
        p_preempt = 1.0 - (1.0 - p) ** n_h
        if s is False:
            p_preempt = 1.0
        return ZoneForecast(
            zone=zone,
            p_available=self._clip(p_avail),
            p_preempt=self._clip(p_preempt),
        )

    # -- introspection (tests / dashboards) ------------------------------
    def rates(self, zone: str) -> Dict[str, Tuple[float, float]]:
        """Smoothed (p, q) per bucket for one zone."""
        return {b: self._rates(zone, b) for b in ("calm", "crunch")}
