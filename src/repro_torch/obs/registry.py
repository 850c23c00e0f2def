"""Run-scoped metrics registry: counters, gauges, histograms with labels.

The old telemetry surface was two module-global ``FALLBACK_COUNTS``
dicts (``serving/latency.py``, ``distributed/sharding.py``): counts bled
across sweep cells and repeated ``Service.run()`` calls, and counts
incremented inside ``ProcessPoolExecutor`` workers vanished.  The
registry fixes both: each run owns a :class:`MetricsRegistry` (reachable
from library code via :func:`get_registry` inside a
:func:`use_registry` scope), its :meth:`~MetricsRegistry.snapshot` is a
plain JSON-able dict that pickles across process boundaries, and
snapshots :meth:`merge <MetricsRegistry.merge_snapshots>` associatively
so a scenario suite can aggregate its cells.

Label handling: metrics are keyed by ``name{k=v,...}`` with labels
sorted by key, so the snapshot's key order is deterministic and two
registries that saw the same increments serialize identically.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterable, Iterator, List, Mapping, Optional

__all__ = ["MetricsRegistry", "get_registry", "use_registry"]


def _series_key(name: str, labels: Mapping[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Counters / gauges / histograms for one run."""

    def __init__(self) -> None:
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Dict[str, float]] = {}

    # ------------------------------------------------------------------
    def inc(self, name: str, value: float = 1, **labels: Any) -> None:
        key = _series_key(name, labels)
        self._counters[key] = self._counters.get(key, 0) + value

    def gauge(self, name: str, value: float, **labels: Any) -> None:
        self._gauges[_series_key(name, labels)] = value

    def observe(self, name: str, value: float, **labels: Any) -> None:
        key = _series_key(name, labels)
        h = self._hists.get(key)
        if h is None:
            h = self._hists[key] = {
                "count": 0, "sum": 0.0,
                "min": float("inf"), "max": float("-inf"),
            }
        h["count"] += 1
        h["sum"] += value
        h["min"] = min(h["min"], value)
        h["max"] = max(h["max"], value)

    # ------------------------------------------------------------------
    def counter(self, name: str, **labels: Any) -> float:
        return self._counters.get(_series_key(name, labels), 0)

    def __bool__(self) -> bool:
        return bool(self._counters or self._gauges or self._hists)

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """A plain JSON-able, picklable view (sorted keys)."""
        out: Dict[str, Any] = {}
        if self._counters:
            out["counters"] = {
                k: self._counters[k] for k in sorted(self._counters)
            }
        if self._gauges:
            out["gauges"] = {k: self._gauges[k] for k in sorted(self._gauges)}
        if self._hists:
            out["histograms"] = {
                k: dict(self._hists[k]) for k in sorted(self._hists)
            }
        return out

    @staticmethod
    def merge_snapshots(
        snaps: Iterable[Optional[Mapping[str, Any]]]
    ) -> Dict[str, Any]:
        """Aggregate cell snapshots: counters/histogram moments add,
        gauges keep the last written value (cells are ordered)."""
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        hists: Dict[str, Dict[str, float]] = {}
        for snap in snaps:
            if not snap:
                continue
            for k, v in snap.get("counters", {}).items():
                counters[k] = counters.get(k, 0) + v
            gauges.update(snap.get("gauges", {}))
            for k, h in snap.get("histograms", {}).items():
                m = hists.get(k)
                if m is None:
                    hists[k] = dict(h)
                else:
                    m["count"] += h["count"]
                    m["sum"] += h["sum"]
                    m["min"] = min(m["min"], h["min"])
                    m["max"] = max(m["max"], h["max"])
        out: Dict[str, Any] = {}
        if counters:
            out["counters"] = {k: counters[k] for k in sorted(counters)}
        if gauges:
            out["gauges"] = {k: gauges[k] for k in sorted(gauges)}
        if hists:
            out["histograms"] = {k: hists[k] for k in sorted(hists)}
        return out


# ----------------------------------------------------------------------
# active-registry scope: library code with no run handle (the latency
# model factory, the sharding helpers) records into whatever registry
# the enclosing run activated; outside any scope a process-default
# registry absorbs the counts so telemetry is never silently dropped.

_DEFAULT = MetricsRegistry()
_STACK: List[MetricsRegistry] = []


def get_registry() -> MetricsRegistry:
    """The innermost active registry, or the process default."""
    return _STACK[-1] if _STACK else _DEFAULT


@contextlib.contextmanager
def use_registry(registry: MetricsRegistry) -> Iterator[MetricsRegistry]:
    """Route :func:`get_registry` to ``registry`` within the scope."""
    _STACK.append(registry)
    try:
        yield registry
    finally:
        _STACK.pop()
