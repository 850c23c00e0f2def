"""``WindowSampler``, the windowed data-plane samples of observability
detail ``full``: the port's own copy of the reference's
(``repro.serving.sim``).

Both host engines call this one code path at the control-tick boundary with
order-independent inputs (cumulative counters, the cluster's state at the
boundary), so their window samples, and with them their event logs, are
byte-identical.  Every sample window also folds its error counts into the
SLO burn monitor's trailing fast and slow windows and records one
``SLOBurnEvent``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.cluster.instance import Instance, InstanceKind, InstanceState
from repro_torch.obs.events import WindowSampleEvent
from repro_torch.obs.recorder import ObsRecorder
from repro_torch.obs.slo import SLOBurnMonitor
from repro_torch.serving.token.metrics import TokenRecord

__all__ = ["WindowSampler"]


class WindowSampler:
    """One window sample and one burn event every ``obs.window_s``."""

    def __init__(
        self,
        obs: ObsRecorder,
        slo_ttft_s: Optional[float] = None,
        slo_tpot_s: Optional[float] = None,
    ) -> None:
        self.obs = obs
        self._next_t = 0.0
        self._last_t = 0.0
        self._last_completed = 0
        self._last_failed = 0
        self._records_seen = 0
        self._burn = SLOBurnMonitor(obs.slo_burn, slo_ttft_s=slo_ttft_s,
                                    slo_tpot_s=slo_tpot_s)

    def maybe_emit(
        self,
        now: float,
        *,
        delivered: int,
        completed: int,
        failed: int,
        instances: Sequence[Instance],
        token_records: Optional[Sequence[TokenRecord]] = None,
    ) -> None:
        if not self.obs.wants_windows or now < self._next_t:
            return
        n_ready = n_spot = n_od = 0
        cost_per_h = 0.0
        for inst in instances:
            cost_per_h += inst.hourly_price
            if inst.state is InstanceState.READY:
                n_ready += 1
                if inst.kind is InstanceKind.SPOT:
                    n_spot += 1
                else:
                    n_od += 1
        elapsed = now - self._last_t
        delta = completed - self._last_completed
        goodput = delta / elapsed if elapsed > 0 else 0.0
        ttft_p50: Optional[float] = None
        new: Optional[Sequence[TokenRecord]] = None
        if token_records is not None:
            new = token_records[self._records_seen:]
            self._records_seen = len(token_records)
            if new:
                # the median of the window's completions as a multiset, so
                # no engine's completion order shows in the sample
                ttft_p50 = float(np.median(sorted(r.ttft_s for r in new)))
        self.obs.emit_window(WindowSampleEvent(
            t=now,
            queue_depth=delivered - completed - failed,
            n_ready=n_ready,
            n_spot=n_spot,
            n_od=n_od,
            cost_per_h=cost_per_h,
            n_completed=completed,
            n_failed=failed,
            goodput_rps=goodput,
            ttft_p50_s=ttft_p50,
        ))
        # the burn rates, from the same order-independent window deltas
        self.obs.emit_window(self._burn.observe(
            now,
            d_completed=delta,
            d_failed=failed - self._last_failed,
            new_records=new,
        ))
        self._last_t = now
        self._last_completed = completed
        self._last_failed = failed
        self._next_t = now + self.obs.window_s
