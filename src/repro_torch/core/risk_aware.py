"""Risk-aware SpotHedge, forecast-ranked placement and pre-emptive
hedging: the port's own copy of ``repro.core.risk_aware``.

``RiskAwareSpotHedgePolicy`` keeps SpotHedge whole (``Z_A`` / ``Z_P``,
overprovisioning, dynamic fallback) and consults a
``repro_torch.forecast.Forecaster`` built from the same observation stream:

* placement: ``SELECT-NEXT-ZONE`` ranks candidate zones by forecast
  preemption risk (bucketed, so spot price still breaks near-ties);
* the spot buffer is trimmed when every occupied zone is forecast calm and
  surged when one is forecast risky;
* ready spot replicas in zones whose forecast risk crosses
  ``risk_threshold`` are discounted from ``S_r`` when sizing the on-demand
  fallback, so the hedge cold-starts ahead of a predicted collapse.

The forecaster sees what the policy sees: controller events, plus a row of
"these zones host ready replicas" every ``obs_interval_s``.  No trace
future is consulted.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

from repro_torch.core.policy import (
    Action,
    ControllerEvent,
    Observation,
    register_policy,
)
from repro_torch.core.spothedge import SpotHedgePolicy
from repro_torch.forecast.base import Forecaster, ZoneForecast, make_forecaster

__all__ = ["RiskAwareSpotHedgePolicy"]


@register_policy
class RiskAwareSpotHedgePolicy(SpotHedgePolicy):
    """SpotHedge with a forecaster in the placement and hedging loop."""

    name = "risk_spothedge"
    #: the builder routes a spec's ``forecast:`` section into policies
    #: that declare this flag (others ignore the section)
    uses_forecast = True

    def __init__(
        self,
        forecaster: "str | Forecaster" = "markov",
        horizon_s: float = 450.0,
        risk_threshold: float = 0.6,
        # below this forecast risk in every occupied zone, the spot
        # overprovision buffer is trimmed (the cost the hedge spends
        # during predicted crunches is recouped during predicted calm)
        calm_threshold: float = 0.06,
        min_overprovision: Optional[int] = None,
        # extra *spot* replicas (cheap insurance, placed in forecast-safe
        # zones by the rank hook) added on top of N_Extra while any
        # occupied zone's risk crosses risk_threshold
        surge_overprovision: int = 1,
        forecaster_args: Optional[Mapping[str, object]] = None,
        # observation cadence fed to the forecaster: estimators express
        # their transition statistics per observation step, so throttling
        # keeps their per-step hazards calibrated even though the policy
        # ticks every few seconds
        obs_interval_s: float = 60.0,
        **spothedge_kwargs,
    ) -> None:
        super().__init__(**spothedge_kwargs)
        if horizon_s <= 0:
            raise ValueError(f"horizon_s must be positive, got {horizon_s}")
        for nm, v in (("risk_threshold", risk_threshold),
                      ("calm_threshold", calm_threshold)):
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{nm} must be a probability, got {v}")
        if obs_interval_s <= 0:
            raise ValueError(
                f"obs_interval_s must be positive, got {obs_interval_s}"
            )
        if min_overprovision is None:
            # trim floor defaults to 1 but must never exceed the buffer
            # itself (overprovision: 0 is a legal vanilla knob)
            min_overprovision = min(1, self.n_extra)
        if not 0 <= min_overprovision <= self.n_extra:
            raise ValueError(
                f"min_overprovision must lie in [0, num_overprovision="
                f"{self.n_extra}], got {min_overprovision}"
            )
        if surge_overprovision < 0:
            raise ValueError(
                f"surge_overprovision must be >= 0, "
                f"got {surge_overprovision}"
            )
        if isinstance(forecaster, str):
            forecaster = make_forecaster(
                forecaster, **dict(forecaster_args or {})
            )
        elif forecaster_args:
            raise ValueError(
                "forecaster_args only applies when forecaster is a name"
            )
        self.forecaster = forecaster
        self.horizon_s = float(horizon_s)
        self.risk_threshold = float(risk_threshold)
        self.calm_threshold = float(calm_threshold)
        self.min_overprovision = int(min_overprovision)
        self.surge_overprovision = int(surge_overprovision)
        self.obs_interval_s = float(obs_interval_s)
        self._forecast: Dict[str, ZoneForecast] = {}
        self._last_obs_at = -1e18

    # -- lifecycle -------------------------------------------------------
    def reset(self, zones, catalog, itype) -> None:
        super().reset(zones, catalog, itype)
        self.forecaster.reset(
            [z.name for z in zones],
            {z.name: z.region for z in zones},
            dt=self.obs_interval_s,
        )
        self._forecast = {}
        self._last_obs_at = -1e18

    # -- observation plumbing --------------------------------------------
    def on_event(self, event: ControllerEvent) -> None:
        super().on_event(event)
        self.forecaster.observe_event(event)

    def _feed_forecaster(self, obs: Observation) -> None:
        """Periodic up-evidence: zones hosting ready spot replicas are
        demonstrably obtainable right now.  Zones with no presence stay
        unobserved — the estimators decay them toward their base rates."""
        if obs.now - self._last_obs_at < self.obs_interval_s:
            return
        up = {inst.zone for inst in obs.spot_ready}
        if up:
            self.forecaster.observe(obs.now, {z: True for z in up})
        self._last_obs_at = obs.now

    # -- SpotHedge hooks --------------------------------------------------
    def _select_next_zone(self, current_counts, now: float) -> str:
        # SELECT-NEXT-ZONE orders by current placement count before the
        # rank key, so risk alone cannot keep a launch out of a zone the
        # forecast says is about to collapse.  When a safe alternative
        # exists, push predicted-collapse zones to the back of the pool
        # (the same count-inflation trick the per-tick spread cap uses).
        if self._forecast:
            names = self._zone_names()
            risky = {
                z
                for z in names
                if (f := self._forecast.get(z)) is not None
                and f.p_preempt >= self.risk_threshold
            }
            if risky and any(z not in risky for z in names):
                alt = dict(current_counts)
                for z in risky:
                    alt[z] = alt.get(z, 0) + 10_000
                return super()._select_next_zone(alt, now)
        return super()._select_next_zone(current_counts, now)

    def _zone_rank_key(self, zone: str, now: float) -> tuple:
        f = self._forecast.get(zone)
        if f is None:
            return super()._zone_rank_key(zone, now)
        # bucket the risk so near-equal zones still compete on price
        return (
            round(f.p_preempt, 1),
            self._spot_price(zone),
            zone,
        )

    def _spot_goal(self, obs: Observation) -> int:
        """Forecast-modulated spot buffer.

        The buffer exists to absorb preemptions while replacements cold
        start.  Three regimes, judged by the forecast risk of the zones
        the fleet actually occupies:

        * **calm**  (every occupied zone below ``calm_threshold``) —
          most of that insurance is dead weight; trim the buffer to
          ``min_overprovision`` and bank the spot cost.
        * **risky** (any occupied zone at or above ``risk_threshold``) —
          add ``surge_overprovision`` *spot* replicas on top of
          ``N_Extra``.  The rank hook steers them into forecast-safe
          zones (typically another region), so the predicted crunch is
          absorbed by cheap spot launched *before* it lands, not by
          on-demand after.
        * otherwise — the vanilla ``N_Tar + N_Extra``.
        """
        base = obs.n_target + self.n_extra
        if not self._forecast:
            return base
        # risk of the fleet as placed: the zones hosting live replicas
        risks = [
            self._forecast[inst.zone].p_preempt
            for inst in obs.spot_ready + obs.spot_provisioning
            if inst.zone in self._forecast
        ]
        if not risks:
            return base
        if max(risks) >= self.risk_threshold:
            return base + self.surge_overprovision
        if (
            max(risks) < self.calm_threshold
            and self.n_extra > self.min_overprovision
        ):
            return obs.n_target + self.min_overprovision
        return base

    def _at_risk_ready(self, obs: Observation) -> int:
        warned = super()._at_risk_ready(obs)
        forecast_risk = sum(
            1
            for inst in obs.spot_ready
            if (f := self._forecast.get(inst.zone)) is not None
            and f.p_preempt >= self.risk_threshold
        )
        # only hedge when the predicted survivors cannot hold N_Tar —
        # losses the spot buffer can absorb are its job to absorb, and
        # hedging them anyway burns on-demand on false positives.  A
        # region-wide crunch (first preemption flips siblings into the
        # crunch bucket, their risk jumps) blows through the buffer and
        # opens the gate *before* the follow-on preemptions land.
        if obs.s_r - forecast_risk >= obs.n_target:
            forecast_risk = 0
        return max(warned, forecast_risk)

    # -- the decision ------------------------------------------------------
    def decide(self, obs: Observation) -> List[Action]:
        self._feed_forecaster(obs)
        self._forecast = self.forecaster.predict(obs.now, self.horizon_s)
        return super().decide(obs)

    # -- introspection -----------------------------------------------------
    @property
    def current_forecast(self) -> Dict[str, ZoneForecast]:
        """Latest per-zone forecast (empty before the first decide)."""
        return dict(self._forecast)
