"""Forecaster interface, per-zone spot availability and preemption risk:
the port's own copy of ``repro.forecast.base``.

A ``Forecaster`` turns the observation stream a placement policy already
receives (preemption / launch-failure / ready events, plus which zones host
live replicas) into forward-looking per-zone scores over ``horizon_s``:

* ``p_available``: probability the zone has obtainable spot capacity then;
* ``p_preempt``: probability a spot instance running in the zone is
  preempted within the horizon.

``observe`` takes a (partial) row of binary availability observations;
``observe_event`` folds a ``ControllerEvent`` into the same state
(preemptions and launch failures are down evidence, ready launches up
evidence, warnings are ignored).  Implementations register with
``register_forecaster`` so specs and sweeps can name them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

from repro_torch.cluster.traces import infer_region
from repro_torch.core.policy import ControllerEvent, EventKind

__all__ = [
    "ZoneForecast",
    "Forecaster",
    "infer_region",
    "register_forecaster",
    "make_forecaster",
    "registered_forecasters",
]


@dataclasses.dataclass(frozen=True)
class ZoneForecast:
    """One zone's forward-looking scores over a fixed horizon."""

    zone: str
    p_available: float      # P(any spot capacity at now + horizon)
    p_preempt: float        # P(running instance preempted within horizon)

    def __post_init__(self) -> None:
        for field in ("p_available", "p_preempt"):
            v = getattr(self, field)
            if not 0.0 <= v <= 1.0:
                raise ValueError(
                    f"{field} must be a probability, got {v!r} "
                    f"for zone {self.zone!r}"
                )


class Forecaster:
    """Base class.  Subclasses implement ``_predict_zone`` and the state
    updates behind ``observe``."""

    name: str = "forecaster"

    def __init__(self) -> None:
        self._zones: List[str] = []
        self._region_of: Dict[str, str] = {}
        self._dt: float = 60.0

    # -- lifecycle -----------------------------------------------------
    def reset(
        self,
        zones: Sequence[str],
        zone_region: Optional[Mapping[str, str]] = None,
        dt: float = 60.0,
    ) -> None:
        """Start a fresh history over ``zones``.

        ``zone_region`` scopes sibling-correlation features; missing
        entries fall back to :func:`infer_region`.  ``dt`` is the
        expected observation cadence in seconds — estimators express
        their transition statistics per ``dt`` step.
        """
        self._zones = list(zones)
        self._region_of = {
            z: (zone_region or {}).get(z, infer_region(z)) for z in zones
        }
        self._dt = float(dt)

    # -- observation channels ------------------------------------------
    def observe(self, now: float, available: Mapping[str, bool]) -> None:
        """Record a (partial) row of binary availability observations."""
        raise NotImplementedError

    def observe_event(self, event: ControllerEvent) -> None:
        """Fold one controller transition into the availability history."""
        if event.kind in (EventKind.PREEMPTION, EventKind.LAUNCH_FAILURE):
            self.observe(event.now, {event.zone: False})
        elif event.kind is EventKind.READY:
            self.observe(event.now, {event.zone: True})
        # WARNING: advisory only — not a capacity measurement

    # -- prediction ----------------------------------------------------
    def predict(
        self, now: float, horizon_s: float
    ) -> Dict[str, ZoneForecast]:
        """Per-zone forecast ``horizon_s`` seconds ahead of ``now``."""
        if horizon_s <= 0:
            raise ValueError(f"horizon_s must be positive, got {horizon_s}")
        return {
            z: self._predict_zone(z, now, horizon_s) for z in self._zones
        }

    def _predict_zone(
        self, zone: str, now: float, horizon_s: float
    ) -> ZoneForecast:
        raise NotImplementedError

    # -- shared helpers --------------------------------------------------
    def _siblings(self, zone: str) -> List[str]:
        region = self._region_of.get(zone, infer_region(zone))
        return [
            z for z in self._zones
            if z != zone and self._region_of.get(z) == region
        ]

    @staticmethod
    def _clip(p: float) -> float:
        return min(1.0, max(0.0, float(p)))


# ---------------------------------------------------------------------------
# Registry (mirrors repro_torch.core.policy's)
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, type] = {}


def register_forecaster(cls: type) -> type:
    _REGISTRY[cls.name] = cls
    return cls


def _load_builtin() -> None:
    # Import for registration side effects.
    from repro_torch.forecast import estimators as _e  # noqa: F401


def make_forecaster(name: str, **kwargs) -> Forecaster:
    """Instantiate a forecaster by registered name (spec / CLI entry)."""
    _load_builtin()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown forecaster {name!r}; have {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name](**kwargs)


def registered_forecasters() -> List[str]:
    _load_builtin()
    return sorted(_REGISTRY)
