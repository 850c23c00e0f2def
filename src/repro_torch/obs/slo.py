"""SLO burn-rate monitoring (Google-SRE style multi-window alerts).

A *burn rate* is the ratio between the observed error fraction over a
trailing window and the SLO's error budget (``1 - target``): burn 1.0
consumes exactly the budget over the SLO period, burn 14.4 consumes a
30-day budget in ~2 days.  Following the multiwindow-multi-burn-rate
recipe, an SLO is *alerting* when both a fast (default 5 min) and a
slow (default 1 h) trailing window exceed their thresholds — the fast
window gives low detection latency, the slow window suppresses blips.

Three SLOs are tracked where signals exist:

* ``availability`` — failed / (completed + failed), both replica
  models;
* ``ttft`` / ``tpot`` — per-request violations of the serving SLO
  targets, token replica model only (request cells have no token
  timings).

The monitor is fed once per sample window from the engines' shared
``WindowSampler`` choke point with *order-independent* inputs (window
deltas of cumulative counters, violation counts over the window's new
token records), so the legacy and vectorized engines emit byte
-identical ``SLOBurnEvent`` streams.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.events import SLOBurnEvent

__all__ = [
    "SLOBurnConfig",
    "SLOBurnMonitor",
    "burn_summary",
    "burn_table",
]


@dataclasses.dataclass(frozen=True)
class SLOBurnConfig:
    """Burn-rate windows and alert thresholds.

    Defaults are the classic SRE-workbook pairing: a 5-minute fast
    window at 14.4× budget burn plus a 1-hour slow window at 6×.
    """

    target: float = 0.99
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    fast_threshold: float = 14.4
    slow_threshold: float = 6.0

    def __post_init__(self) -> None:
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"slo_burn.target must be in (0, 1), got {self.target}"
            )
        if self.fast_window_s <= 0 or self.slow_window_s <= 0:
            raise ValueError("slo_burn windows must be positive")
        if self.fast_window_s > self.slow_window_s:
            raise ValueError(
                "slo_burn.fast_window_s must not exceed slow_window_s"
            )
        if self.fast_threshold <= 0 or self.slow_threshold <= 0:
            raise ValueError("slo_burn thresholds must be positive")

    @property
    def budget(self) -> float:
        return 1.0 - self.target


#: SLO names in emission order
SLO_NAMES = ("availability", "ttft", "tpot")


class SLOBurnMonitor:
    """Accumulates per-window error counts; emits one event per window.

    All inputs are integer counts, so trailing-window aggregation is
    order-independent and the derived burn rates are bit-identical
    across engines.
    """

    def __init__(
        self,
        cfg: SLOBurnConfig,
        slo_ttft_s: Optional[float] = None,
        slo_tpot_s: Optional[float] = None,
    ) -> None:
        self.cfg = cfg
        self.slo_ttft_s = slo_ttft_s
        self.slo_tpot_s = slo_tpot_s
        # (t_end, {name: (err, tot)})
        self._hist: List[Tuple[float, Dict[str, Tuple[int, int]]]] = []

    def _burn(self, name: str, now: float, horizon: float):
        err = tot = 0
        t0 = now - horizon
        for t_end, counts in self._hist:
            if t_end <= t0:
                continue
            e, n = counts.get(name, (0, 0))
            err += e
            tot += n
        if tot == 0:
            return None
        return (err / tot) / self.cfg.budget

    def observe(
        self,
        now: float,
        *,
        d_completed: int,
        d_failed: int,
        new_records: Optional[Sequence] = None,
    ) -> SLOBurnEvent:
        """Fold one sample window in; return the window's burn event."""
        counts: Dict[str, Tuple[int, int]] = {
            "availability": (int(d_failed), int(d_completed + d_failed)),
        }
        if new_records is not None:
            if self.slo_ttft_s is not None:
                counts["ttft"] = (
                    sum(1 for r in new_records
                        if r.ttft_s > self.slo_ttft_s),
                    len(new_records),
                )
            if self.slo_tpot_s is not None:
                counts["tpot"] = (
                    sum(1 for r in new_records
                        if r.tpot_s > self.slo_tpot_s),
                    len(new_records),
                )
        self._hist.append((now, counts))

        cfg = self.cfg
        fields: Dict[str, Optional[float]] = {}
        alerting = []
        for name in SLO_NAMES:
            if name != "availability" and name not in counts:
                continue
            fast = self._burn(name, now, cfg.fast_window_s)
            slow = self._burn(name, now, cfg.slow_window_s)
            fields[f"{name}_fast"] = fast
            fields[f"{name}_slow"] = slow
            if (
                fast is not None
                and slow is not None
                and fast > cfg.fast_threshold
                and slow > cfg.slow_threshold
            ):
                alerting.append(name)
        return SLOBurnEvent(
            t=now,
            alerting=tuple(alerting) if alerting else None,
            **fields,
        )


def burn_summary(records: Sequence[dict]) -> Optional[dict]:
    """Aggregate ``slo_burn`` records into a per-cell summary.

    ``records`` is any event-record stream (dicts); non-burn records
    are ignored.  Returns ``None`` when the stream has no burn windows
    (e.g. detail below ``full``).
    """
    burns = [r for r in records if r.get("event") == "slo_burn"]
    if not burns:
        return None
    by_slo: Dict[str, int] = {}
    alert_windows = 0
    t_prev: Optional[float] = None
    alert_s = 0.0
    window_s = 0.0
    for r in burns:
        t = float(r["t"])
        dt = (t - t_prev) if t_prev is not None else 0.0
        if dt > 0:
            window_s = dt
        t_prev = t
        names = r.get("alerting") or []
        if names:
            alert_windows += 1
            alert_s += window_s
            for n in names:
                by_slo[n] = by_slo.get(n, 0) + 1
    return {
        "windows": len(burns),
        "alert_windows": alert_windows,
        "alert_minutes": round(alert_s / 60.0, 6),
        "by_slo": {k: by_slo[k] for k in sorted(by_slo)},
    }


def burn_table(records: Sequence[dict]) -> str:
    """Render burn-rate windows as an aligned text table (CLI ``slo``)."""
    burns = [r for r in records if r.get("event") == "slo_burn"]
    if not burns:
        return "no slo_burn events (observability detail must be 'full')"
    cols = ["t"]
    for name in SLO_NAMES:
        for spd in ("fast", "slow"):
            key = f"{name}_{spd}"
            if any(key in r for r in burns):
                cols.append(key)
    cols.append("alerting")
    rows = [cols]
    for r in burns:
        row = [f"{float(r['t']):.0f}"]
        for key in cols[1:-1]:
            v = r.get(key)
            row.append("-" if v is None else f"{v:.3f}")
        row.append(",".join(r.get("alerting") or []) or "-")
        rows.append(row)
    widths = [max(len(row[i]) for row in rows) for i in range(len(cols))]
    lines = [
        "  ".join(c.rjust(w) for c, w in zip(row, widths)) for row in rows
    ]
    summ = burn_summary(records) or {}
    lines.append(
        f"windows={summ.get('windows', 0)} "
        f"alert_windows={summ.get('alert_windows', 0)} "
        f"alert_minutes={summ.get('alert_minutes', 0.0)}"
    )
    return "\n".join(lines)
