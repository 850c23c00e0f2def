"""repro_torch.obs: unified event tracing, metrics and decision attribution,
the port's own copy of ``repro.obs`` (framework-free, no line of it changes
a result).

The observability substrate every engine of the port shares:

* :mod:`repro_torch.obs.events` — typed, schema-versioned event dataclasses
  for control-plane decisions (with machine-readable *reasons*), replica
  lifecycle transitions, migration plans, preemption warnings and
  windowed data-plane samples.
* :mod:`repro_torch.obs.registry` — a run-scoped metrics registry
  (counters / gauges / histograms with labels) replacing the old
  process-global ``FALLBACK_COUNTS`` module dicts.
* :mod:`repro_torch.obs.recorder` — the per-run :class:`ObsRecorder` that the
  cluster simulator and serving engines emit into, with a ``detail``
  level knob (``off`` | ``decisions`` | ``full``).
* :mod:`repro_torch.obs.export` — byte-deterministic JSONL event logs and a
  Chrome-trace-event (Perfetto-loadable) per-replica timeline.
* :mod:`repro_torch.obs.attribution` — charges each dollar and each failed
  request back to the policy decision (or preemption) that produced it.
* ``python -m repro_torch.obs`` — summarize a run, diff two runs, render the
  attribution report, convert a log to a Perfetto trace.

Events are emitted at the *shared* choke points (``ClusterSimulator``,
``MigrationRuntime``, the engine tick), so the legacy and vectorized
engines produce byte-identical JSONL on the same spec and the card engine
(``TorchServingEngine``) reproduces the control-plane stream through its
phase-A replay and rebuilds sampled request spans from ``scenario_scan``'s
span timelines (tests/test_torch_obs.py, tests/test_torch_spans.py).
"""

from repro_torch.obs.attribution import attribution_report
from repro_torch.obs.events import (
    SCHEMA_VERSION,
    AutoscalerTargetEvent,
    Event,
    LaunchFailureEvent,
    MigrationPlanEvent,
    PolicyDecisionEvent,
    PreemptionWarningEvent,
    ReplicaLifecycleEvent,
    SLOBurnEvent,
    WindowSampleEvent,
    control_plane_records,
)
from repro_torch.obs.export import (
    chrome_trace,
    diff_summaries,
    dumps_jsonl,
    read_jsonl,
    summarize,
    write_chrome_trace,
    write_jsonl,
)
from repro_torch.obs.recorder import DETAIL_LEVELS, ObsRecorder
from repro_torch.obs.registry import (
    MetricsRegistry,
    get_registry,
    use_registry,
)
from repro_torch.obs.slo import (
    SLOBurnConfig,
    SLOBurnMonitor,
    burn_summary,
    burn_table,
)
from repro_torch.obs.spans import SpanCollector, span_sampled

__all__ = [
    "SCHEMA_VERSION",
    "DETAIL_LEVELS",
    "Event",
    "PolicyDecisionEvent",
    "ReplicaLifecycleEvent",
    "MigrationPlanEvent",
    "PreemptionWarningEvent",
    "LaunchFailureEvent",
    "WindowSampleEvent",
    "SLOBurnEvent",
    "AutoscalerTargetEvent",
    "control_plane_records",
    "ObsRecorder",
    "SLOBurnConfig",
    "SLOBurnMonitor",
    "burn_summary",
    "burn_table",
    "SpanCollector",
    "span_sampled",
    "MetricsRegistry",
    "get_registry",
    "use_registry",
    "dumps_jsonl",
    "write_jsonl",
    "read_jsonl",
    "chrome_trace",
    "write_chrome_trace",
    "summarize",
    "diff_summaries",
    "attribution_report",
]
