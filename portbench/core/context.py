"""What a per-layer metric's reader is given: the window's records, the
program's own counters, the trace's reduction and the frozen formulas."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from portbench.core import cost


@dataclasses.dataclass
class Context:
    win: object                       # client.Window
    replicas: Dict[str, object]       # name -> the program's LiveReplica
    shape: cost.ModelShape
    cache_slots: int                  # cache slots of every request's cache
    trace: Optional[object] = None    # trace.TraceSummary of the traced run
    tracer: Optional[object] = None
    cost = cost

    def window_prefills(self) -> List[object]:
        """The prefills of the window, from its opening to its close."""
        return [p for p in self.win.prefills
                if p.start >= self.win.start and p.end <= self.win.close]

    def window_rounds(self) -> List[object]:
        return [r for r in self.win.rounds if r.end <= self.win.close]

    def prefill_s(self, p) -> float:
        return self.replicas[p.replica].prefill_s[p.prefill_idx]

    def decode_s(self, r) -> List[float]:
        return self.replicas[r.replica].decode_s[slice(*r.decode_idx)]

    def _traced(self, items, kind: str) -> List[object]:
        """``items`` inside the traced stretch, if the trace holds one
        device span for each (else the profiler lost some: nothing)."""
        if self.trace is None or self.tracer.stretch is None:
            return []
        s, e = self.tracer.stretch
        inside = [x for x in items if x.start >= s and x.end <= e]
        return inside if len(inside) == len(self.trace.spans.get(kind, [])) else []

    def traced_rounds(self) -> List[object]:
        return self._traced(self.win.rounds, "pb.decode")

    def traced_prefills(self) -> List[object]:
        return self._traced(self.win.prefills, "pb.prefill")

    def kernel_seconds(self, span: str, prefix: str) -> float:
        """Device seconds of the kernels named ``prefix``... in ``span``."""
        if self.trace is None:
            return 0.0
        return sum(k.end - k.start for k in self.trace.kernels
                   if k.span == span and k.name.startswith(prefix)) / 1e9
