"""The scenario engine's phase-B input: the sub-step grid, one cell's
schedule, and the request tape as arrays.

Own copies of ``SubStepGrid``, ``build_grid``, ``CellSchedule`` and
``ScheduleRecorder`` from ``repro.serving.jaxengine.schedule``.  A
``CellSchedule`` is what the control plane (phase A: cluster simulator,
policy, autoscaler) leaves for the data plane: the request tape, the
serving knobs, the ready roster of every control window, each replica
slot's RTT row and the kill events.  ``ScheduleRecorder`` collects them
while the port's phase A runs (``engine.TorchServingEngine``); a schedule
the reference recorded comes over through
``repro_torch.convert.schedule_from_arrays``.  The reference's
``base: SimResult`` becomes ``BaseMetrics``, the few control-plane numbers
a serving result carries.

The control plane never observes the data plane (the autoscaler sees only
arrival batches, a function of the tape and the grid), which is what lets
phase A run once on the host and record everything phase B needs:

* per control window, the roster of ready replica slots;
* per slot, its RTT row (client-region code -> seconds);
* kill events as ``(window, slot)`` in order: a preemption at tick ``k``
  lands before the tick hook (window ``k``), a policy termination after it
  (window ``k + 1``), so phase B re-pends work at the oracle's instant.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.serving.latency import LatencyModel
from repro_torch.workloads.arrivals import Request

__all__ = ["BaseMetrics", "CellSchedule", "ScheduleRecorder", "SubStepGrid",
           "build_grid", "tape_arrays"]


@dataclasses.dataclass(frozen=True)
class SubStepGrid:
    """The exact sub-step grid of a (duration, dt, sub_step) family."""

    ts: np.ndarray         # [G] float64 grid points
    win_of: np.ndarray     # [G] int64: control window of each point
    win_first: np.ndarray  # [W] int64: first grid index of each window
    ticks: int             # W
    dt: float
    sub_step_s: float

    @property
    def n_points(self) -> int:
        return int(self.ts.shape[0])

    @property
    def signature(self) -> Tuple[float, float, int]:
        """Two grids with equal signatures hold identical floats."""
        return (self.dt, self.sub_step_s, self.ticks)


def build_grid(duration_s: float, dt: float, sub_step_s: float) -> SubStepGrid:
    """The engines' per-window float accumulation, replicated exactly:
    ``t = now; while t < now + dt: ...; t += sub_step_s`` inside each
    control tick (not ``arange``), so timeout instants match the reference
    bit for bit."""
    ticks = int(float(duration_s) / dt)
    ts: List[float] = []
    win_of: List[int] = []
    win_first = np.empty(ticks, dtype=np.int64)
    for k in range(ticks):
        now = k * dt
        win_first[k] = len(ts)
        t = now
        end = now + dt
        while t < end:
            ts.append(t)
            win_of.append(k)
            t += sub_step_s
    return SubStepGrid(
        ts=np.asarray(ts, dtype=np.float64),
        win_of=np.asarray(win_of, dtype=np.int64),
        win_first=win_first,
        ticks=ticks,
        dt=float(dt),
        sub_step_s=float(sub_step_s),
    )


@dataclasses.dataclass(frozen=True)
class BaseMetrics:
    """The control plane's share of a cell's result: what it cost, how
    available it was and how often it lost replicas."""

    total_cost: float
    spot_cost: float
    od_cost: float
    cost_vs_ondemand: float
    availability: float
    n_preemptions: int
    n_launch_failures: int


@dataclasses.dataclass
class CellSchedule:
    """One cell's complete phase-B input: tape + control-plane replay."""

    # identity / labels
    policy_name: str
    trace_name: str
    workload_name: str
    # request tape
    arr: np.ndarray              # [n] float64 arrivals, sorted
    svc: np.ndarray              # [n] float64 roofline service times
    rcode: np.ndarray            # [n] int64 client-region codes
    n_regions: int
    # serving knobs
    timeout_s: float
    concurrency: int
    lb_kind: str                 # "rr" | "ll"
    # control-plane replay
    grid: SubStepGrid
    ready_mask: np.ndarray       # [W, R] bool: slot ready in window
    rtt: np.ndarray              # [R, NREG] float64
    kill_slot: np.ndarray        # [E] int64, chronological
    kill_g: np.ndarray           # [E] int64 grid index; G => post-horizon
    post_slots: np.ndarray       # slots of post-horizon kill events
    base: BaseMetrics
    n_slots: int
    trace_on: bool = False       # carry span timelines through the kernel

    @property
    def n(self) -> int:
        return int(self.arr.shape[0])

    @property
    def n_events(self) -> int:
        return int(self.kill_slot.shape[0])


class ScheduleRecorder:
    """Recording state driven by ``TorchServingEngine``'s tick/kill hooks."""

    def __init__(self, grid: SubStepGrid, arr: np.ndarray) -> None:
        self.grid = grid
        # arrival observations per window: the oracle appends one
        # ``(t, n_new)`` per sub-step that consumed new arrivals
        ends = np.searchsorted(arr, grid.ts, side="right")
        counts = np.diff(ends, prepend=0)
        self._obs_by_win: List[List[Tuple[float, int]]] = [
            [] for _ in range(grid.ticks)
        ]
        for j in np.flatnonzero(counts):
            self._obs_by_win[int(grid.win_of[j])].append(
                (float(grid.ts[j]), int(counts[j]))
            )
        self.ready_rows: List[List[int]] = []
        self.kills: List[Tuple[int, int]] = []   # (window, slot), in order
        self.win = 0          # next window index
        self.kill_win = 0     # window a kill occurring *now* belongs to

    def obs_for(self, k: int) -> Sequence[Tuple[float, int]]:
        return self._obs_by_win[k]

    def record_tick(self, ready_slots: Sequence[int]) -> int:
        """Called from the tick hook *after* sync; returns this window."""
        k = self.win
        self.win = k + 1
        self.ready_rows.append(list(ready_slots))
        # anything dying between this hook and the next (policy
        # terminations of this tick, preemptions of the next) is
        # processed by the data plane at the start of window k+1
        self.kill_win = k + 1
        return k

    def record_kill(self, slot: int) -> None:
        self.kills.append((self.kill_win, slot))

    def control_arrays(
        self, n_slots: int, rtt_rows: Sequence[Sequence[float]],
        n_regions: int,
    ):
        """Densify the recording into phase-B arrays: ``(ready_mask, rtt,
        kill_slot, kill_g, post_slots)``."""
        g = self.grid
        ready = np.zeros((max(g.ticks, 1), max(n_slots, 1)), dtype=bool)
        for k, row in enumerate(self.ready_rows):
            for s in row:
                ready[k, s] = True
        rtt = np.zeros((max(n_slots, 1), max(n_regions, 1)))
        for s, row in enumerate(rtt_rows):
            rtt[s, : len(row)] = row
        kill_slot = np.asarray([s for _, s in self.kills], dtype=np.int64)
        kill_g = np.asarray(
            [
                int(g.win_first[w]) if w < g.ticks else g.n_points
                for w, _ in self.kills
            ],
            dtype=np.int64,
        )
        post = np.asarray(
            [s for w, s in self.kills if w >= g.ticks], dtype=np.int64
        )
        return ready, rtt, kill_slot, kill_g, post


def tape_arrays(
    requests: Sequence[Request], latency_model: LatencyModel
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[str]]:
    """The request tape as the reference's serving engine compiles it
    (``VectorizedServingEngine.__init__``): requests stable-sorted by
    arrival; ``arr`` their arrivals, ``svc`` their roofline service times in
    the reference's operation order (so every value is its float to the
    bit) and ``rcode`` their client regions as codes in order of first
    appearance, whose names are the fourth value."""
    reqs = sorted(requests, key=lambda r: r.arrival_s)
    n = len(reqs)
    arr = np.fromiter((r.arrival_s for r in reqs), dtype=np.float64, count=n)
    p_tok = np.fromiter((r.prompt_tokens for r in reqs), dtype=np.float64,
                        count=n)
    o_tok = np.fromiter((r.output_tokens for r in reqs), dtype=np.float64,
                        count=n)
    lm = latency_model
    prefill = (2.0 * lm._active_params) * p_tok / lm.flops_per_s
    svc = (lm.overhead_s + prefill) + o_tok * lm.decode_s_per_token()
    regions: List[str] = []
    code: Dict[str, int] = {}
    rcode = np.empty(n, dtype=np.int64)
    for i, r in enumerate(reqs):
        c = code.get(r.client_region)
        if c is None:
            c = code[r.client_region] = len(regions)
            regions.append(r.client_region)
        rcode[i] = c
    return arr, svc, rcode, regions
