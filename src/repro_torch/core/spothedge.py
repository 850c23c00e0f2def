"""SpotHedge, the paper's policy (§3): the port's own copy of
``repro.core.spothedge``.

Three mechanisms, composed:

1. **Dynamic Placement (Alg. 1).**  Maintain ``Z_A`` (available zones) and
   ``Z_P`` (highly-preempting zones).  A preemption or failed launch in ``z``
   moves ``z → Z_P``; a successful ready launch moves ``z → Z_A``.  New spot
   replicas are drawn from ``Z_A``, excluding zones that already host spot
   replicas (the set ``C``) when possible, breaking ties by spot price.
   When ``|Z_A| < 2`` the lists are rebalanced (``Z_A ← Z_A + Z_P``), which
   prevents collapsing all placements onto one zone.

2. **Overprovisioning (§3.2).**  Target ``N_Tar(t) + N_Extra`` *spot*
   replicas.  The extra spot replicas are the cheap buffer that absorbs
   preemptions while replacements (spot or on-demand) cold-start.

3. **Dynamic Fallback (§3.2).**  Maintain
   ``O(t) = min(N_Tar, N_Tar + N_Extra − S_r(t))`` launched on-demand
   replicas.  On-demand replicas are scaled down as soon as enough spot
   replicas are *ready* — on-demand is the fallback, never the steady state.
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.core.policy import (
    Action,
    LaunchOnDemand,
    LaunchSpot,
    Observation,
    Policy,
    Terminate,
    register_policy,
)


@register_policy
class SpotHedgePolicy(Policy):
    """The full SpotHedge policy."""

    name = "spothedge"

    def __init__(
        self,
        num_overprovision: int = 2,
        dynamic_ondemand_fallback: bool = True,
        # optional static floor of on-demand capacity (custom policy, §4)
        min_ondemand: int = 0,
        # launch at most this many spot replicas per zone per tick, so a
        # single tick cannot pile every replacement onto one zone
        max_launch_per_zone_per_tick: int = 2,
        # best-effort preemption warnings (§4 "Preemption handling"): treat
        # ready replicas in recently-warned zones as at-risk when sizing the
        # on-demand fallback.  0 disables.
        warning_ttl_s: float = 240.0,
    ) -> None:
        super().__init__()
        self.n_extra = int(num_overprovision)
        self.dynamic_fallback = bool(dynamic_ondemand_fallback)
        self.min_ondemand = int(min_ondemand)
        self.max_launch_per_zone_per_tick = int(max_launch_per_zone_per_tick)
        self.warning_ttl_s = float(warning_ttl_s)
        self._za: List[str] = []
        self._zp: List[str] = []
        self._warned: Dict[str, float] = {}   # zone -> warning time

    # ------------------------------------------------------------------
    def reset(self, zones, catalog, itype) -> None:
        super().reset(zones, catalog, itype)
        self._za = [z.name for z in zones]    # line 1: Z_A <- Z
        self._zp = []
        self._warned = {}

    # -- Alg. 1 event handlers -------------------------------------------
    def _move_to_zp(self, zone: str) -> None:
        if zone in self._za:
            self._za.remove(zone)
            self._zp.append(zone)
        # line 7-9: rebalance when Z_A thins out
        if len(self._za) < 2:
            self._za = self._za + self._zp
            self._zp = []

    def on_preemption(self, zone: str, now: float) -> None:
        # HANDLE-PREEMPTION(z)
        self._move_to_zp(zone)

    def on_launch_failure(self, zone: str, now: float) -> None:
        # A failed launch is evidence the zone is out of capacity — the
        # paper's Fig. 7 narrative moves zone 2 to Z_P on launch failure.
        super().on_launch_failure(zone, now)
        self._move_to_zp(zone)

    def on_ready(self, zone: str, now: float) -> None:
        # HANDLE-LAUNCH(z)
        if zone in self._zp:
            self._zp.remove(zone)
            self._za.append(zone)

    def on_warning(self, zone: str, now: float) -> None:
        if self.warning_ttl_s > 0:
            self._warned[zone] = now

    # -- SELECT-NEXT-ZONE (Alg. 1, line 17-23) -----------------------------
    def _zone_rank_key(self, zone: str, now: float) -> tuple:
        """Tie-break order among equally-loaded candidate zones.  Vanilla
        SpotHedge ranks by spot price; RiskAwareSpotHedgePolicy overrides
        this to rank by forecast preemption risk first."""
        return (self._spot_price(zone), zone)

    def _select_next_zone(
        self, current_counts: Dict[str, int], now: float
    ) -> str:
        enabled = set(self._zone_names())
        active = [z for z in self._za if z in enabled]
        if not active:
            # All enabled zones in Z_P — rebalance defensively.
            self._za = list(self._zone_names())
            self._zp = []
            active = list(self._za)
        # honor launch-failure cooldowns unless that empties the pool
        cooled = [z for z in active if self._cooled(z, now)]
        if cooled:
            active = cooled
        occupied = {z for z, c in current_counts.items() if c > 0}
        unoccupied = [z for z in active if z not in occupied]  # Z'_A = Z_A \ C
        pool = unoccupied if unoccupied else active
        # prioritize zones with fewer current spot placements, then price
        return min(
            pool,
            key=lambda z: (
                current_counts.get(z, 0),
                *self._zone_rank_key(z, now),
            ),
        )

    # -- the decision ----------------------------------------------------
    def _spot_goal(self, obs: Observation) -> int:
        """Launched-spot target S(t) + buffer.  Vanilla SpotHedge keeps a
        constant ``N_Tar + N_Extra``; RiskAwareSpotHedgePolicy modulates
        the buffer with the forecast (lean when calm, full when risky)."""
        return obs.n_target + self.n_extra

    def decide(self, obs: Observation) -> List[Action]:
        actions: List[Action] = []
        n_tar = obs.n_target
        spot_goal = self._spot_goal(obs)

        # 1) keep trying to reach N_Tar + N_Extra *launched* spot replicas
        counts = obs.spot_count_by_zone()
        to_launch = spot_goal - obs.s_launched
        # when every enabled zone recently failed, drop to a single probe
        # launch per tick ("the policy can additionally probe different
        # zones to maintain Z_P and Z_A" — §3.1)
        if to_launch > 1 and not any(
            self._cooled(z, obs.now) for z in self._zone_names()
        ):
            to_launch = 1
        launched_this_tick: Dict[str, int] = {}
        for _ in range(max(0, to_launch)):
            zone = self._select_next_zone(counts, obs.now)
            if (
                launched_this_tick.get(zone, 0)
                >= self.max_launch_per_zone_per_tick
                and len(self._za) > 1
            ):
                # spread replacements across remaining zones within a tick
                alt = dict(counts)
                alt[zone] = alt.get(zone, 0) + 10_000  # de-prioritize
                zone = self._select_next_zone(alt, obs.now)
            self._note(
                why="fill_spot_buffer",
                spot_goal=spot_goal,
                s_launched=obs.s_launched,
                zone_spot_count=counts.get(zone, 0),
                zone_rank=self._zone_rank_key(zone, obs.now),
            )
            actions.append(LaunchSpot(zone))
            counts[zone] = counts.get(zone, 0) + 1
            launched_this_tick[zone] = launched_this_tick.get(zone, 0) + 1

        # 2) scale down surplus spot (target shrank): newest-first,
        #    provisioning-first
        if to_launch < 0:
            surplus = -to_launch
            pool = sorted(
                obs.spot_provisioning, key=lambda i: -i.launched_at
            ) + sorted(obs.spot_ready, key=lambda i: -i.launched_at)
            for inst in pool[:surplus]:
                self._note(
                    why="shrink_spot_buffer",
                    spot_goal=spot_goal,
                    s_launched=obs.s_launched,
                    surplus=surplus,
                )
                actions.append(Terminate(inst.id))

        # 3) Dynamic Fallback: O(t) = min(N_Tar, N_Tar + N_Extra - S_r)
        #    Ready replicas in recently-warned zones are discounted from S_r
        #    (the §4 warning extension) so the fallback launches *before*
        #    the preemption lands, shaving one cold start from the outage.
        s_r_eff = obs.s_r - self._at_risk_ready(obs)
        if self.dynamic_fallback:
            # spot_goal == n_tar + n_extra for vanilla SpotHedge.  The
            # risk-aware subclass may have trimmed the buffer — the
            # fallback must chase the trimmed goal or it would backfill
            # every trimmed spot replica with on-demand — but a *surged*
            # goal is spot-only insurance and must not leak into O(t),
            # hence the cap at the vanilla goal.
            od_goal = min(spot_goal, n_tar + self.n_extra)
            od_needed = min(n_tar, od_goal - s_r_eff)
            od_needed = max(od_needed, self.min_ondemand, 0)
        else:
            od_needed = self.min_ondemand
        gap = od_needed - obs.o_launched
        if gap > 0:
            zone = self._cheapest_od_zone()
            for _ in range(gap):
                self._note(
                    why="od_fallback",
                    od_needed=od_needed,
                    s_r=obs.s_r,
                    at_risk_ready=obs.s_r - s_r_eff,
                    n_target=n_tar,
                )
                actions.append(LaunchOnDemand(zone))
        elif gap < 0:
            od_terms = self._scale_down_od(obs, od_needed)
            for _ in od_terms:
                self._note(
                    why="shrink_od_fallback",
                    od_needed=od_needed,
                    o_launched=obs.o_launched,
                    s_r=obs.s_r,
                )
            actions.extend(od_terms)
        return actions

    # -- at-risk accounting (overridden by the risk-aware subclass) --------
    def _at_risk_ready(self, obs: Observation) -> int:
        """Ready spot replicas to discount from S_r when sizing the
        on-demand fallback.  Vanilla SpotHedge counts replicas in
        recently-warned zones; RiskAwareSpotHedgePolicy adds replicas in
        zones whose *forecast* preemption risk crosses its threshold."""
        self._warned = {
            z: t0
            for z, t0 in self._warned.items()
            if obs.now - t0 <= self.warning_ttl_s
        }
        return sum(
            1 for inst in obs.spot_ready if inst.zone in self._warned
        )

    # -- introspection (used by tests + dashboards) ------------------------
    @property
    def available_zones(self) -> List[str]:
        return list(self._za)

    @property
    def preempting_zones(self) -> List[str]:
        return list(self._zp)
