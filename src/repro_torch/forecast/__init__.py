"""Spot-availability forecasting: the port's own copy of ``repro.forecast``.

A ``Forecaster`` (persistence baseline, per-zone EWMA hazard,
sibling-correlated regional Markov) turns the observation history a
placement policy already receives into per-zone availability scores and
preemption-risk estimates.  ``repro_torch.core.risk_aware`` consumes them
to rank zones and pre-hedge on-demand, and ``repro_torch.forecast.backtest``
replays a trace through a forecaster and scores it (Brier, hit rate,
calibration) into versioned JSON reports.  The arithmetic is the
reference's, in float64 and in its order, so predictions and reports are
the reference's to the bit.
"""

from repro_torch.forecast.backtest import (
    BacktestReport,
    HorizonScore,
    run_backtest,
)
from repro_torch.forecast.base import (
    Forecaster,
    ZoneForecast,
    infer_region,
    make_forecaster,
    register_forecaster,
    registered_forecasters,
)
from repro_torch.forecast.estimators import (
    EWMAForecaster,
    MarkovRegionalForecaster,
    PersistenceForecaster,
)

__all__ = [
    "BacktestReport",
    "EWMAForecaster",
    "Forecaster",
    "HorizonScore",
    "MarkovRegionalForecaster",
    "PersistenceForecaster",
    "ZoneForecast",
    "infer_region",
    "make_forecaster",
    "register_forecaster",
    "registered_forecasters",
    "run_backtest",
]
