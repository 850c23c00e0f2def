"""SpotHedge, the paper's policy, with its baselines and the autoscalers:
the port's own copy of ``repro.core`` (the Omniscient ILP oracle and the
risk-aware SpotHedge are not ported yet).

``policy``      Observation / Action / Policy interfaces shared by the
                cluster simulator and the controller.
``spothedge``   SpotHedge = Dynamic Placement (Alg. 1) + overprovisioning +
                Dynamic Fallback (§3.2).
``baselines``   EvenSpread, RoundRobin, StaticMixture (ASG), AWSSpot,
                MArk-like, OnDemandOnly, SpotOnly.
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
    "EvenSpreadPolicy",
    "RoundRobinPolicy",
    "StaticMixturePolicy",
    "AWSSpotPolicy",
    "MArkLikePolicy",
    "OnDemandOnlyPolicy",
    "SpotOnlyPolicy",
    "Autoscaler",
    "ConstantTarget",
    "LoadAutoscaler",
]
