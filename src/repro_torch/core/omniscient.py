"""The Omniscient oracle (§3.3, Eq. 1-5), an offline MILP over the trace:
the port's own copy of ``repro.core.omniscient``.

Requires the complete spot obtainability trace (infeasible online; the paper
uses it as a cost lower bound).  We bucket time to keep the MILP tractable
and solve with scipy's HiGHS backend, over the reference's sparse matrix
built in its variable layout and row order, so the same scipy gives the
same plan.

Decision variables per time bucket ``t``:

    S[z,t]  launched spot replicas in zone z          (int >= 0, <= C(z,t))
    R[z,t]  ready spot replicas in zone z             (int >= 0)
    O[t]    launched on-demand replicas               (int >= 0)
    Or[t]   ready on-demand replicas                  (int >= 0)
    M[t]    availability indicator                    (binary)

    minimize   sum_t [ sum_z S[z,t] + k * O[t] ]                    (Eq. 1)
    s.t.       sum_t M[t] >= T * Avail_Tar                          (Eq. 2)
               S[z,t] <= C(z,t)                                     (Eq. 3)
               R[z,t] <= S[z,t']  for t' in (t-d, t]   (cold start) (Eq. 4)
               Or[t]  <= O[t']   for t' in (t-d, t]                 (Eq. 4)
               M[t]*Nmax  >= sum_z R[z,t] + Or[t] - N_Tar(t)        (Eq. 5)
               (1-M[t])*Nmax >= N_Tar(t) - sum_z R[z,t] - Or[t]     (Eq. 5)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
from scipy import optimize, sparse

from repro_torch.cluster.traces import SpotTrace
from repro_torch.core.policy import (
    Action,
    LaunchOnDemand,
    LaunchSpot,
    Observation,
    Policy,
    Terminate,
    register_policy,
)


@dataclasses.dataclass
class OmniscientSchedule:
    """The solved plan, replayable against the simulator."""

    zones: List[str]
    bucket_s: float
    spot_plan: np.ndarray        # int [T, Z] — S[z,t]
    od_plan: np.ndarray          # int [T]    — O[t]
    availability_ind: np.ndarray  # int [T]   — M[t]
    objective: float             # normalized cost units (spot-replica-buckets)
    status: str

    def spot_at(self, t: float) -> Dict[str, int]:
        i = min(int(t / self.bucket_s), len(self.od_plan) - 1)
        return {z: int(c) for z, c in zip(self.zones, self.spot_plan[i])}

    def od_at(self, t: float) -> int:
        i = min(int(t / self.bucket_s), len(self.od_plan) - 1)
        return int(self.od_plan[i])


def solve_omniscient(
    trace: SpotTrace,
    *,
    n_target: int,
    cold_start_s: float,
    k_ratio: float,
    avail_target: float = 0.99,
    bucket_s: Optional[float] = None,
    max_buckets: int = 400,
    time_limit_s: float = 120.0,
) -> OmniscientSchedule:
    """Solve Eq. 1-5 over ``trace`` and return the optimal schedule."""
    if bucket_s is None:
        # choose the coarsest bucket that still resolves the cold start and
        # keeps the MILP under ``max_buckets`` buckets.
        bucket_s = max(trace.dt, cold_start_s,
                       trace.duration_s / max_buckets)
    stride = max(1, int(round(bucket_s / trace.dt)))
    # bucket capacity = min over the bucket (conservative: a launch must
    # survive the whole bucket)
    T_raw = trace.cap.shape[0]
    T = T_raw // stride
    if T < 2:
        raise ValueError("trace too short for the requested bucketing")
    capb = trace.cap[: T * stride].reshape(T, stride, -1).min(axis=1)
    Z = capb.shape[1]
    db = max(1, int(math.ceil(cold_start_s / bucket_s)))
    # nothing can be ready during the first db buckets (cold start), so the
    # availability target is capped at the achievable maximum
    avail_target = min(avail_target, (T - db) / T)
    n_max = int(max(n_target * 2, int(capb.max()) + n_target, 4))

    # variable layout: [S (T*Z) | R (T*Z) | O (T) | Or (T) | M (T)]
    nS = T * Z
    iS = lambda t, z: t * Z + z                  # noqa: E731
    iR = lambda t, z: nS + t * Z + z             # noqa: E731
    iO = lambda t: 2 * nS + t                    # noqa: E731
    iOr = lambda t: 2 * nS + T + t               # noqa: E731
    iM = lambda t: 2 * nS + 2 * T + t            # noqa: E731
    nvar = 2 * nS + 3 * T

    c = np.zeros(nvar)
    for t in range(T):
        for z in range(Z):
            c[iS(t, z)] = 1.0
        c[iO(t)] = k_ratio

    rows: List[int] = []
    cols: List[int] = []
    vals: List[float] = []
    lbs: List[float] = []
    ubs: List[float] = []
    r = 0

    def add(coefs: List, lo: float, hi: float) -> None:
        nonlocal r
        for col, v in coefs:
            rows.append(r)
            cols.append(col)
            vals.append(v)
        lbs.append(lo)
        ubs.append(hi)
        r += 1

    inf = np.inf
    # Eq. 2: sum_t M[t] >= T * avail_target
    add([(iM(t), 1.0) for t in range(T)], math.ceil(T * avail_target), inf)

    for t in range(T):
        # Eq. 4 spot: R[z,t] <= S[z,t'] for the trailing cold-start window
        for z in range(Z):
            if t < db:
                add([(iR(t, z), 1.0)], 0.0, 0.0)   # nothing ready yet
            else:
                for tp in range(t - db, t + 1):
                    add([(iR(t, z), 1.0), (iS(tp, z), -1.0)], -inf, 0.0)
        # Eq. 4 on-demand
        if t < db:
            add([(iOr(t), 1.0)], 0.0, 0.0)
        else:
            for tp in range(t - db, t + 1):
                add([(iOr(t), 1.0), (iO(tp), -1.0)], -inf, 0.0)
        # Eq. 5a: M*Nmax - sum_z R - Or >= -N_Tar  (forces M=1 if ready>=NTar)
        add(
            [(iM(t), float(n_max))]
            + [(iR(t, z), -1.0) for z in range(Z)]
            + [(iOr(t), -1.0)],
            -float(n_target),
            inf,
        )
        # Eq. 5b: (1-M)*Nmax >= N_Tar - sum R - Or
        #   ->  -M*Nmax + sum R + Or >= N_Tar - Nmax
        add(
            [(iM(t), -float(n_max))]
            + [(iR(t, z), 1.0) for z in range(Z)]
            + [(iOr(t), 1.0)],
            float(n_target) - float(n_max),
            inf,
        )

    A = sparse.csr_matrix(
        (vals, (rows, cols)), shape=(r, nvar)
    )
    constraints = optimize.LinearConstraint(A, np.array(lbs), np.array(ubs))

    lb = np.zeros(nvar)
    ub = np.full(nvar, float(n_max))
    for t in range(T):
        for z in range(Z):
            ub[iS(t, z)] = float(capb[t, z])          # Eq. 3
            ub[iR(t, z)] = float(capb[t, z])
        ub[iO(t)] = float(n_target)
        ub[iOr(t)] = float(n_target)
        ub[iM(t)] = 1.0
    bounds = optimize.Bounds(lb, ub)
    integrality = np.ones(nvar)  # all integer (M binary via bounds)

    res = optimize.milp(
        c,
        constraints=constraints,
        bounds=bounds,
        integrality=integrality,
        options={"time_limit": time_limit_s, "presolve": True},
    )
    if res.x is None:
        # Availability target infeasible under the trace — retry with the
        # best achievable availability (all-OD satisfies any target, so this
        # only triggers for avail_target pathologies, e.g. > 1).
        raise RuntimeError(f"omniscient MILP failed: {res.message}")

    x = np.round(res.x).astype(int)
    spot_plan = np.array(
        [[x[iS(t, z)] for z in range(Z)] for t in range(T)], dtype=int
    )
    od_plan = np.array([x[iO(t)] for t in range(T)], dtype=int)
    m = np.array([x[iM(t)] for t in range(T)], dtype=int)
    return OmniscientSchedule(
        zones=list(trace.zones),
        bucket_s=float(stride * trace.dt),
        spot_plan=spot_plan,
        od_plan=od_plan,
        availability_ind=m,
        objective=float(res.fun),
        status=str(res.message),
    )


@register_policy
class OmniscientPolicy(Policy):
    """Replays a pre-solved :class:`OmniscientSchedule` in the simulator."""

    name = "omniscient"

    def __init__(self, schedule: Optional[OmniscientSchedule] = None) -> None:
        super().__init__()
        self.schedule = schedule

    def attach_schedule(self, schedule: OmniscientSchedule) -> None:
        self.schedule = schedule

    def decide(self, obs: Observation) -> List[Action]:
        if self.schedule is None:
            raise RuntimeError(
                "OmniscientPolicy needs a schedule "
                "(call attach_schedule or use solve_omniscient)"
            )
        plan = self.schedule.spot_at(obs.now)
        od_plan = self.schedule.od_at(obs.now)
        actions: List[Action] = []

        counts = obs.spot_count_by_zone()
        # launch up to plan per zone; terminate down to plan per zone
        for zone in self.schedule.zones:
            want = plan.get(zone, 0)
            have = counts.get(zone, 0)
            if want > have:
                actions.extend(LaunchSpot(zone) for _ in range(want - have))
            elif want < have:
                pool = [
                    i
                    for i in obs.spot_provisioning + obs.spot_ready
                    if i.zone == zone
                ]
                pool.sort(key=lambda i: -i.launched_at)
                actions.extend(
                    Terminate(i.id) for i in pool[: have - want]
                )

        gap = od_plan - obs.o_launched
        if gap > 0:
            zone = self._cheapest_od_zone()
            actions.extend(LaunchOnDemand(zone) for _ in range(gap))
        elif gap < 0:
            actions.extend(self._scale_down_od(obs, od_plan))
        return actions
