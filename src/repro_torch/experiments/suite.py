"""Expand a spec's sweep into scenario-engine cells: the port's own copy of
the grid expansion of ``repro.experiments.suite`` (``ScenarioSuite.
from_spec``), the path the reference's benchmark matrix takes.

``expand_sweep`` crosses ``policies x traces x seeds`` (an empty axis falls
back to the base spec's value; a seed overrides ``workload.seed``) in the
reference's order, policy-major.  ``build_cells`` builds every cell's
``TorchServingEngine`` through ``service.builder.build_cell``; cells of one
workload seed share one request tape, as the reference's cells do.  Run
them with ``repro_torch.serving.torchengine.engine.run_cells``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Mapping, Tuple, Union

from repro_torch.serving.torchengine.engine import TorchServingEngine
from repro_torch.service.builder import build_cell, build_requests
from repro_torch.service.spec import ServiceSpec, SweepSpec, spec_from_dict
from repro_torch.workloads.arrivals import Request

__all__ = ["Cell", "build_cells", "expand_sweep"]


@dataclasses.dataclass
class Cell:
    """One cell of a matrix: its labels, single-run spec and engine."""

    labels: Dict[str, Any]
    spec: ServiceSpec
    engine: TorchServingEngine

    @property
    def duration_s(self) -> float:
        return self.spec.sim.duration_s


def _as_spec(spec: Union[ServiceSpec, Mapping[str, Any]]) -> ServiceSpec:
    return spec if isinstance(spec, ServiceSpec) else spec_from_dict(spec)


def expand_sweep(spec: Union[ServiceSpec, Mapping[str, Any]]
                 ) -> List[Tuple[Dict[str, Any], ServiceSpec]]:
    """The grid's cells as ``(labels, single-run spec)``, in the
    reference's order."""
    base = _as_spec(spec)
    sweep = base.sweep or SweepSpec()
    out = []
    for pol in sweep.policies or (base.replica_policy,):
        for tr in sweep.traces or (base.trace,):
            for seed in sweep.seeds or (None,):
                wl = (base.workload if seed is None
                      else dataclasses.replace(base.workload, seed=seed))
                cell = dataclasses.replace(
                    base,
                    name=f"{base.name}-{pol.name}-{tr}-{wl.kind}-s{wl.seed}",
                    replica_policy=pol, trace=tr, workload=wl, sweep=None)
                out.append(({"policy": pol.name, "trace": tr,
                             "workload": wl.kind, "seed": wl.seed}, cell))
    return out


def build_cells(spec: Union[ServiceSpec, Mapping[str, Any]]) -> List[Cell]:
    """Every cell of the spec's grid, built and ready to run."""
    tapes: Dict[Tuple, List[Request]] = {}
    cells = []
    for labels, cell in expand_sweep(spec):
        w = cell.workload
        key = (w.rate_per_s, w.seed, json.dumps(dict(w.args), sort_keys=True),
               cell.sim.duration_s - cell.sim.drain_s)
        if key not in tapes:
            tapes[key] = build_requests(cell)
        cells.append(Cell(labels, cell,
                          build_cell(cell, requests=tapes[key])))
    return cells
