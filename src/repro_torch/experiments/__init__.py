"""Scenario matrices from a spec's sweep (the port's own copy of the grid
expansion of ``repro.experiments``)."""

from repro_torch.experiments.suite import Cell, build_cells, expand_sweep

__all__ = ["Cell", "build_cells", "expand_sweep"]
