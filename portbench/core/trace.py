"""The traced run's profiler and the reduction of its trace.

With ``--trace 1`` the harness marks its calls into the program with
``torch.profiler.record_function`` spans (``pb.prefill`` around ``submit``,
``pb.decode`` around ``step``, ``pb.dispatch``, ``pb.preempt``,
``pb.wait``), and ``torch.profiler`` records one stretch of serving (CPU
and CUDA activity).  Kineto puts each span on the device's timeline too,
so a kernel belongs to the span whose device interval holds its start.

The stretch follows the window: CUPTI is not started before the window
closes, so the window's host counters are those of an untraced run.  Then
the loop serves on (the mix's arrivals go on, moved later by the time the
profiler took to start: CUPTI's first start in a process takes seconds),
one warm-up cycle's events are dropped (a trace started cold loses its
first kernels), and the stretch of a few seconds is recorded (a decode step
of these models runs 2,000 to 5,000 kernels).  The profiler's stop
processes the stretch's events, after the loop has ended.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import re
import time
from typing import Dict, List, Optional, Tuple

import torch

SPANS = ("pb.prefill", "pb.decode", "pb.dispatch", "pb.preempt", "pb.wait")


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Tracer:
    """Profiles a stretch of ``seconds`` that follows the window, after one
    warm-up cycle of ``warm_s``.  ``tick()`` is called on every pass of the
    client's loop once the window has closed; the loop ends when
    ``ended``."""

    def __init__(self, seconds: float, warm_s: float = 0.3) -> None:
        self.seconds, self.warm_s = seconds, warm_s
        self.phase = "idle"
        self.prof = None
        self.stretch: Optional[Tuple[float, float]] = None      # perf_counter
        self.stretch_ns: Optional[Tuple[int, int]] = None       # the trace's clock
        self._t = 0.0

    @staticmethod
    def span(name: str):
        return torch.profiler.record_function(name)

    @property
    def ended(self) -> bool:
        return self.phase == "ended"

    def tick(self) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule

        now = time.perf_counter()
        if self.phase == "idle":
            self.prof = profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
            self.prof.__enter__()
            self.phase, self._t = "warm", time.perf_counter()
        elif self.phase == "warm" and now >= self._t + self.warm_s:
            _sync()
            self.prof.step()
            self.stretch = (time.perf_counter(), None)
            self.stretch_ns = (time.time_ns(), None)
            self.phase = "active"
        elif self.phase == "active" and now >= self.stretch[0] + self.seconds:
            self.phase = "ended"

    def finish(self) -> None:
        """Stop the profiler (after the loop has ended)."""
        if self.phase not in ("warm", "active", "ended"):
            return
        _sync()
        if self.phase != "warm":
            self.stretch = (self.stretch[0], time.perf_counter())
            self.stretch_ns = (self.stretch_ns[0], time.time_ns())
            self.prof.step()
        self.prof.__exit__(None, None, None)
        self.phase = "done" if self.phase != "warm" else "lost"

    def events(self):
        return self.prof.profiler.kineto_results.events() if self.phase == "done" else []


@dataclasses.dataclass
class Kernel:
    name: str
    start: int
    end: int
    span: Optional[str]        # the harness span it ran in
    span_idx: int              # that span's index among its kind, or -1


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: List[Kernel]
    spans: Dict[str, List[Tuple[int, int]]]    # device intervals by span kind
    idle_by_host: Dict[str, float]             # idle seconds by host span
    device_ops: List[Tuple[str, float]]        # seconds by kernel, top 10


def short_name(name: str) -> str:
    """A kernel's name without return type, namespace and template
    arguments: ``void (anonymous namespace)::flash_decode_kernel<...>(...)``
    reads ``flash_decode_kernel``."""
    name = re.sub(r"^void\s+", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    base = "".join(out).strip()
    return base.rsplit("::", 1)[-1] or name[:60]


def _intervals(events, device: bool):
    out = collections.defaultdict(list)
    for e in events:
        if e.is_user_annotation() and e.name() in SPANS and (
                (e.device_type() == torch.autograd.DeviceType.CUDA) == device):
            out[e.name()].append((e.start_ns(), e.end_ns()))
    return {k: sorted(v) for k, v in out.items()}


def _find(intervals, t):
    """Index of the interval of the sorted, disjoint ``intervals`` holding
    ``t``, or -1."""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i if i >= 0 and intervals[i][0] <= t <= intervals[i][1] else -1


def reduce(events, stretch_ns: Tuple[int, int]) -> Optional[TraceSummary]:
    """The stretch's kernels with their spans, busy and idle time, idle time
    by what the host was doing, and the device's heaviest operations."""
    t0, t1 = stretch_ns
    dev_spans, host_spans = _intervals(events, True), _intervals(events, False)
    kernels: List[Kernel] = []
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CUDA or e.is_user_annotation():
            continue
        s, end = e.start_ns(), e.end_ns()
        if end <= t0 or s >= t1:
            continue
        span, idx = None, -1
        for kind, ivs in dev_spans.items():
            j = _find(ivs, s)
            if j >= 0:
                span, idx = kind, j
                break
        kernels.append(Kernel(short_name(e.name()), max(s, t0), min(end, t1),
                              span, idx))
    if not kernels:
        return None
    busy, idle = 0, collections.Counter()
    host_flat = sorted((s, e, k) for k, ivs in host_spans.items() for s, e in ivs)
    starts = [h[0] for h in host_flat]

    def label(t):
        i = bisect.bisect_right(starts, t) - 1
        return host_flat[i][2][3:] if i >= 0 and host_flat[i][1] >= t else "client"

    cur_s = cur_e = None
    gaps = []
    for k in sorted(kernels, key=lambda k: k.start):
        if cur_e is None or k.start > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, k.start))
            else:
                gaps.append((t0, k.start))
            cur_s, cur_e = k.start, k.end
        else:
            cur_e = max(cur_e, k.end)
    busy += cur_e - cur_s
    gaps.append((cur_e, t1))
    for a, b in gaps:
        if b > a:
            idle[label((a + b) // 2)] += (b - a) / 1e9
    ops = collections.Counter()
    for k in kernels:
        ops[k.name] += (k.end - k.start) / 1e9
    return TraceSummary((t1 - t0) / 1e9, busy / 1e9, kernels, dev_spans,
                        dict(idle), ops.most_common(10))
