"""SpotHedge, the paper's policy, with its risk-aware variant, its
baselines, the Omniscient ILP oracle and the autoscalers: the port's own
copy of ``repro.core``.

``policy``      Observation / Action / Policy interfaces shared by the
                cluster simulator and the controller.
``spothedge``   SpotHedge = Dynamic Placement (Alg. 1) + overprovisioning +
                Dynamic Fallback (§3.2).
``baselines``   EvenSpread, RoundRobin, StaticMixture (ASG), AWSSpot,
                MArk-like, OnDemandOnly, SpotOnly.
``risk_aware``  SpotHedge with a spot-availability forecaster in the
                placement and hedging loop (``repro_torch.forecast``).
``omniscient``  The Omniscient ILP oracle (§3.3, Eq. 1-5) via HiGHS.
``autoscaler``  The load-based autoscaler with hysteresis (§4).
"""

from repro_torch.core.autoscaler import Autoscaler, ConstantTarget, LoadAutoscaler
from repro_torch.core.baselines import (
    AWSSpotPolicy,
    EvenSpreadPolicy,
    MArkLikePolicy,
    OnDemandOnlyPolicy,
    RoundRobinPolicy,
    SpotOnlyPolicy,
    StaticMixturePolicy,
)
from repro_torch.core.policy import (
    Action,
    LaunchOnDemand,
    LaunchSpot,
    Observation,
    Policy,
    Terminate,
    make_policy,
)
from repro_torch.core.omniscient import OmniscientPolicy, solve_omniscient
from repro_torch.core.risk_aware import RiskAwareSpotHedgePolicy
from repro_torch.core.spothedge import SpotHedgePolicy

__all__ = [
    "Action",
    "LaunchOnDemand",
    "LaunchSpot",
    "Observation",
    "Policy",
    "Terminate",
    "make_policy",
    "SpotHedgePolicy",
    "RiskAwareSpotHedgePolicy",
    "EvenSpreadPolicy",
    "RoundRobinPolicy",
    "StaticMixturePolicy",
    "AWSSpotPolicy",
    "MArkLikePolicy",
    "OnDemandOnlyPolicy",
    "SpotOnlyPolicy",
    "OmniscientPolicy",
    "solve_omniscient",
    "Autoscaler",
    "ConstantTarget",
    "LoadAutoscaler",
]
