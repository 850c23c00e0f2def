"""Scenario-matrix experiments (the port's own copy of
``repro.experiments``): ``Scenario`` / ``ScenarioSuite`` expand a spec's
grid and run every cell; ``CellResult`` / ``ScenarioReport`` carry the
per-cell metrics and the JSON artifact."""

from repro_torch.experiments.report import CellResult, ScenarioReport
from repro_torch.experiments.suite import Cell, Scenario, ScenarioSuite

__all__ = ["Cell", "CellResult", "Scenario", "ScenarioReport", "ScenarioSuite"]
