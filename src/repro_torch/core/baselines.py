"""Baseline policies the paper compares against (§2.4, §5): the port's own
copy of ``repro.core.baselines``.

* ``EvenSpreadPolicy``   — static even spread over zones (AWS ASG / MArk's
                           placement; §3.1 "Static Spread").
* ``RoundRobinPolicy``   — relaunch in the next zone, round-robin (Ray Serve,
                           GKE; §3.1).
* ``StaticMixturePolicy``— ASG-style fixed node pools: a fixed fraction of
                           on-demand replicas plus a fixed spot pool (§2.4).
* ``AWSSpotPolicy``      — pure spot node pool with even spread in a single
                           region (the paper's "AWSSpot" baseline).
* ``MArkLikePolicy``     — greedy spot-first with over-requesting behaviour
                           under unavailability (§5.1: MArk/AWSSpot keep
                           re-requesting; we cap retries per tick the way the
                           paper observed up to 14 in-flight requests).
* ``OnDemandOnlyPolicy`` — the cost reference (availability ~1, cost 1.0).
* ``SpotOnlyPolicy``     — pure spot with SpotHedge placement but *no*
                           on-demand fallback (ablation).
"""

from __future__ import annotations

from typing import List

from repro_torch.core.policy import (
    Action,
    LaunchOnDemand,
    LaunchSpot,
    Observation,
    Policy,
    Terminate,
    register_policy,
)
from repro_torch.core.spothedge import SpotHedgePolicy


def _terminate_surplus_spot(obs: Observation, goal: int) -> List[Action]:
    surplus = obs.s_launched - goal
    if surplus <= 0:
        return []
    pool = sorted(obs.spot_provisioning, key=lambda i: -i.launched_at) + sorted(
        obs.spot_ready, key=lambda i: -i.launched_at
    )
    return [Terminate(i.id) for i in pool[:surplus]]


@register_policy
class EvenSpreadPolicy(Policy):
    """Keep N_Tar spot replicas spread evenly over all enabled zones."""

    name = "even_spread"

    def decide(self, obs: Observation) -> List[Action]:
        zones = self._zone_names()
        counts = obs.spot_count_by_zone()
        actions: List[Action] = []
        to_launch = obs.n_target - obs.s_launched
        for _ in range(max(0, to_launch)):
            # fill the least-loaded zone, fixed zone order — static spread
            zone = min(zones, key=lambda z: (counts.get(z, 0), zones.index(z)))
            actions.append(LaunchSpot(zone))
            counts[zone] = counts.get(zone, 0) + 1
        actions.extend(_terminate_surplus_spot(obs, obs.n_target))
        return actions


@register_policy
class RoundRobinPolicy(Policy):
    """Relaunch preempted replicas in the next zone, round-robin."""

    name = "round_robin"

    def __init__(self) -> None:
        super().__init__()
        self._cursor = 0

    def decide(self, obs: Observation) -> List[Action]:
        zones = self._zone_names()
        actions: List[Action] = []
        to_launch = obs.n_target - obs.s_launched
        for _ in range(max(0, to_launch)):
            zone = zones[self._cursor % len(zones)]
            self._cursor += 1
            actions.append(LaunchSpot(zone))
        actions.extend(_terminate_surplus_spot(obs, obs.n_target))
        return actions


@register_policy
class StaticMixturePolicy(Policy):
    """ASG-style static node pools (§2.4).

    ``od_fraction`` of N_Tar is always on-demand (ASG default example: 10%);
    the rest is a *fixed-size* spot pool spread evenly in one region.  The
    pools never trade capacity: lost spot capacity is retried as spot, never
    covered by extra on-demand — the paper's core criticism.
    """

    name = "static_mixture"

    def __init__(self, od_fraction: float = 0.1) -> None:
        super().__init__()
        self.od_fraction = float(od_fraction)

    def decide(self, obs: Observation) -> List[Action]:
        import math

        n_od = max(1, math.ceil(obs.n_target * self.od_fraction)) \
            if self.od_fraction > 0 else 0
        n_spot = obs.n_target - n_od
        actions: List[Action] = []

        # on-demand pool, fixed size
        gap_od = n_od - obs.o_launched
        if gap_od > 0:
            zone = self._cheapest_od_zone()
            actions.extend(LaunchOnDemand(zone) for _ in range(gap_od))
        elif gap_od < 0:
            actions.extend(self._scale_down_od(obs, n_od))

        # spot pool, fixed size, even spread
        zones = self._zone_names()
        counts = obs.spot_count_by_zone()
        gap_spot = n_spot - obs.s_launched
        for _ in range(max(0, gap_spot)):
            zone = min(zones, key=lambda z: (counts.get(z, 0), zones.index(z)))
            actions.append(LaunchSpot(zone))
            counts[zone] = counts.get(zone, 0) + 1
        actions.extend(_terminate_surplus_spot(obs, n_spot))
        return actions


@register_policy
class AWSSpotPolicy(EvenSpreadPolicy):
    """Pure spot node pool with even spread — the paper's AWSSpot baseline.

    Same placement as EvenSpread; the distinction in our benchmarks is that
    AWSSpot is configured with the zones of a *single region* (the paper runs
    it in us-west-2), whereas EvenSpread may be given multi-region zones.
    """

    name = "aws_spot"


@register_policy
class MArkLikePolicy(Policy):
    """Greedy spot-first policy in the spirit of MArk (§5.1 baseline).

    MArk targets spot CPU instances and assumes replacements become ready
    quickly after a preemption warning.  Ported to spot GPUs it (a) keeps
    re-requesting spot in the cheapest zone, and (b) over-requests under
    unavailability because provisioning instances don't count toward its
    target.  The paper observed up to 14 in-flight provisioning requests
    (Fig. 12b); we reproduce that failure mode with ``overrequest_factor``.
    """

    name = "mark_like"

    def __init__(self, overrequest_factor: float = 2.0,
                 max_inflight: int = 14) -> None:
        super().__init__()
        self.overrequest_factor = float(overrequest_factor)
        self.max_inflight = int(max_inflight)

    def decide(self, obs: Observation) -> List[Action]:
        actions: List[Action] = []
        # counts only READY replicas toward the target (the ported bug)
        deficit = obs.n_target - obs.s_r
        if deficit > 0:
            want = min(
                int(deficit * self.overrequest_factor),
                self.max_inflight - len(obs.spot_provisioning),
            )
            # cheapest zone first — MArk is cost-greedy
            zones = sorted(
                self._zone_names(), key=lambda z: (self._spot_price(z), z)
            )
            for i in range(max(0, want)):
                actions.append(LaunchSpot(zones[i % len(zones)]))
        else:
            actions.extend(_terminate_surplus_spot(obs, obs.n_target))
        return actions


@register_policy
class OnDemandOnlyPolicy(Policy):
    """N_Tar on-demand replicas, nothing else (the cost denominator)."""

    name = "ondemand_only"

    def decide(self, obs: Observation) -> List[Action]:
        actions: List[Action] = []
        gap = obs.n_target - obs.o_launched
        if gap > 0:
            zone = self._cheapest_od_zone()
            actions.extend(LaunchOnDemand(zone) for _ in range(gap))
        elif gap < 0:
            actions.extend(self._scale_down_od(obs, obs.n_target))
        return actions


@register_policy
class SpotOnlyPolicy(SpotHedgePolicy):
    """SpotHedge placement without the on-demand fallback (ablation)."""

    name = "spot_only"

    def __init__(self, num_overprovision: int = 2) -> None:
        super().__init__(
            num_overprovision=num_overprovision,
            dynamic_ondemand_fallback=False,
        )
