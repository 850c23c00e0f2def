"""The per-run observability recorder.

One :class:`ObsRecorder` is shared by every emitter of a run — the
cluster simulator, the serving engine's tick, the migration runtime and
(via :func:`repro_torch.obs.registry.use_registry`) the latency-model factory.
The ``detail`` knob gates cost:

* ``off`` — nothing is recorded; emitters short-circuit on
  :attr:`enabled` before even constructing event objects.
* ``decisions`` (default) — control-plane events (policy decisions with
  reasons, replica lifecycle, warnings, launch failures, migration
  plans) and registry metrics.
* ``full`` — additionally, windowed data-plane samples
  (:class:`~repro_torch.obs.events.WindowSampleEvent` every ``window_s``) and
  artifact export by the :class:`~repro_torch.service.Service` facade.

Recording is pure observation: no RNG draws, no engine state mutation —
golden metrics are byte-identical at every detail level
(tests/test_torch_obs.py pins this).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from repro_torch.obs.events import Event
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.slo import SLOBurnConfig, burn_summary

__all__ = ["DETAIL_LEVELS", "ObsRecorder"]

DETAIL_LEVELS = ("off", "decisions", "full")


class ObsRecorder:
    """Event sink + metrics registry for one run."""

    def __init__(
        self,
        detail: str = "decisions",
        window_s: float = 60.0,
        trace_sample: float = 0.01,
        slo_burn: Optional[SLOBurnConfig] = None,
    ) -> None:
        if detail not in DETAIL_LEVELS:
            raise ValueError(
                f"observability detail must be one of {DETAIL_LEVELS}, "
                f"got {detail!r}"
            )
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if not 0.0 <= trace_sample <= 1.0:
            raise ValueError(
                f"trace_sample must be in [0, 1], got {trace_sample}"
            )
        self.detail = detail
        self.window_s = float(window_s)
        self.trace_sample = float(trace_sample)
        self.slo_burn = slo_burn if slo_burn is not None else SLOBurnConfig()
        self.events: List[Event] = []
        self.registry = MetricsRegistry()
        self.spans = None    # SpanCollector, attached by span_collector()
        self._ordinals: Dict[int, int] = {}

    def replica_ordinal(self, instance_id: int) -> int:
        """Run-local dense id for an instance.

        ``Instance.id`` comes from a process-global counter, so two runs
        in one process would never produce identical event logs if raw
        ids leaked into events.  Emitters translate through this map;
        first-use order is deterministic (provision order), so equal
        runs yield byte-identical streams.
        """
        ordinal = self._ordinals.get(instance_id)
        if ordinal is None:
            ordinal = self._ordinals[instance_id] = len(self._ordinals)
        return ordinal

    # ------------------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self.detail != "off"

    @property
    def wants_windows(self) -> bool:
        return self.detail == "full"

    def emit(self, event: Event) -> None:
        if self.detail != "off":
            self.events.append(event)

    def emit_window(self, event: Event) -> None:
        if self.detail == "full":
            self.events.append(event)

    def span_collector(self, requests: Sequence):
        """Attach (or return) the run's request-span collector.

        ``None`` when recording is off, sampling is disabled or the
        tape is empty — engines bind the result once and skip all span
        taps when it is ``None``.
        """
        if not self.enabled or self.trace_sample <= 0.0 or not requests:
            return None
        if self.spans is None:
            from repro_torch.obs.spans import SpanCollector

            self.spans = SpanCollector(self.trace_sample, requests)
        return self.spans

    # ------------------------------------------------------------------
    def fresh(self) -> "ObsRecorder":
        """An empty recorder with the same configuration (the card
        engine's oracle fallback re-runs a cell from scratch and must
        not double-record phase-A events)."""
        return ObsRecorder(
            detail=self.detail,
            window_s=self.window_s,
            trace_sample=self.trace_sample,
            slo_burn=self.slo_burn,
        )

    def records(self) -> List[Dict[str, Any]]:
        return [e.to_record() for e in self.events]

    def event_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for e in self.events:
            counts[e.KIND] = counts.get(e.KIND, 0) + 1
        return {k: counts[k] for k in sorted(counts)}

    def window_records(self) -> List[Dict[str, Any]]:
        return [e.to_record() for e in self.events if e.KIND == "window"]

    def span_records(self) -> List[Dict[str, Any]]:
        return self.spans.records() if self.spans is not None else []

    def slo_burn_summary(self) -> Optional[Dict[str, Any]]:
        """Per-run burn summary (``None`` below detail ``full``)."""
        return burn_summary(
            e.to_record() for e in self.events if e.KIND == "slo_burn"
        )
