"""The reference benchmark's scenario matrix: its spec, and a recording of
the reference's control planes and oracle results that holds the port's
own to account.

``recorded_matrix.json`` beside this file was recorded from the reference
(``repro``) on the CPU:

* ``spec``: the scenario spec of ``benchmarks/jax_engine.py``
  (``_spec(48, 1.0)``): llama3.2-1b on g5.48xlarge, spot trace ``aws-1``,
  policies ``spothedge`` and ``even_spread``, a constant target of 3
  replicas, Poisson arrivals at 1 request/s over one hour (3,300 s of
  arrivals and 300 s of drain), a 60 s timeout, concurrency 4,
  least-loaded balancing, seeds 0-47: 96 cells;
* ``grid``: the sub-step grid's parameters;
* ``planes``: the control plane of each policy (the ready slots of every
  control window, each slot's RTT row, the kill events, the knobs and the
  ``BaseMetrics``).  The plane does not depend on the seed, which changes
  only the traffic tape, so two planes serve all 96 cells;
* ``cells``: each cell's (policy, seed) and the reference oracle's result
  (``VectorizedServingEngine``): counts, latency percentiles and mean,
  costs and availability.

The main path builds the matrix from the spec alone: ``spec_matrix``
expands the sweep and builds every cell's ``TorchServingEngine`` through
the port's own builder, and ``run_cells`` runs the port's own phase A.
The recording is the witness it is held against: ``recorded_planes`` are
the reference's planes (``plane_of`` puts a port schedule in their form)
and ``recorded_cells`` the reference oracle's results.  ``recorded_matrix``
still rebuilds the cells' ``CellSchedule``s from the recorded planes and
the port's own tapes, for the tests.  The recording is made and checked
against the reference by ``tests/test_torch_scenario.py``
(``build_recording``; ``python tests/test_torch_scenario.py --write``
writes it anew).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.cluster.catalog import instance_type
from repro_torch.configs import get_config
from repro_torch.experiments.suite import Cell, ScenarioSuite
from repro_torch.serving.latency import LatencyModel
from repro_torch.serving.torchengine.schedule import (
    BaseMetrics,
    CellSchedule,
    SubStepGrid,
    build_grid,
    tape_arrays,
)
from repro_torch.workloads.arrivals import make_workload

__all__ = ["RECORDING", "load_recording", "plane_of", "recorded_cells",
           "recorded_matrix", "recorded_planes", "spec_matrix"]

RECORDING = Path(__file__).resolve().with_name("recorded_matrix.json")


def load_recording() -> Dict:
    with open(RECORDING) as f:
        return json.load(f)


def recorded_cells(n_seeds: int = 48) -> List[Dict]:
    """The cells' records (``policy``, ``seed``, ``result``) of the first
    ``n_seeds`` seeds, policy by policy, in the order of
    ``recorded_matrix``."""
    rec = load_recording()
    seeds = rec["spec"]["sweep"]["seeds"][:n_seeds]
    by_key = {(c["policy"], c["seed"]): c for c in rec["cells"]}
    return [by_key[(p, s)] for p in rec["spec"]["sweep"]["policies"]
            for s in seeds]


def _plane_schedule(plane: Dict, grid: SubStepGrid,
                    tape: Tuple[np.ndarray, np.ndarray, np.ndarray, List[str]],
                    ) -> CellSchedule:
    arr, svc, rcode, regions = tape
    R = plane["n_slots"]
    ready = np.zeros((grid.ticks, R), dtype=bool)
    for k, row in enumerate(plane["ready_rows"]):
        ready[k, row] = True
    if max(len(regions), 1) != plane["n_regions"]:
        raise ValueError(f"the tape has regions {regions}; the recorded "
                         f"plane has {plane['n_regions']}")
    return CellSchedule(
        policy_name=plane["policy_name"],
        trace_name=plane["trace_name"],
        workload_name=plane["workload_name"],
        arr=arr,
        svc=svc,
        rcode=rcode,
        n_regions=plane["n_regions"],
        timeout_s=plane["timeout_s"],
        concurrency=plane["concurrency"],
        lb_kind=plane["lb_kind"],
        grid=grid,
        ready_mask=ready,
        rtt=np.asarray(plane["rtt"], dtype=np.float64).reshape(R, -1),
        kill_slot=np.asarray(plane["kill_slot"], dtype=np.int64),
        kill_g=np.asarray(plane["kill_g"], dtype=np.int64),
        post_slots=np.asarray(plane["post_slots"], dtype=np.int64),
        base=BaseMetrics(**plane["base"]),
        n_slots=R,
        trace_on=plane["trace_on"],
    )


def recorded_matrix(n_seeds: int = 48) -> List[CellSchedule]:
    """The matrix's ``CellSchedule``s for its first ``n_seeds`` seeds (96
    cells at 48, the quick matrix's 8 at 4), policy by policy."""
    rec = load_recording()
    spec, g = rec["spec"], rec["grid"]
    seeds = spec["sweep"]["seeds"][:n_seeds]
    lm = LatencyModel.for_model(get_config(spec["model"]),
                                instance_type(spec["resources"]["instance_type"]))
    grid = build_grid(g["duration_s"], g["control_interval_s"], g["sub_step_s"])
    w = spec["workload"]
    horizon = g["duration_s"] - spec["sim"]["drain_s"]
    tapes = {
        s: tape_arrays(
            make_workload(w["kind"], rate_per_s=w["rate_per_s"], seed=s)
            .generate(horizon), lm)
        for s in seeds
    }
    return [_plane_schedule(rec["planes"][p], grid, tapes[s])
            for p in spec["sweep"]["policies"] for s in seeds]


def recorded_planes() -> Dict[str, Dict]:
    """The reference's control plane of each policy, by policy name."""
    return load_recording()["planes"]


def plane_of(s: CellSchedule) -> Dict:
    """A schedule's control plane in the recording's form (JSON types)."""
    return {
        "policy_name": s.policy_name,
        "trace_name": s.trace_name,
        "workload_name": s.workload_name,
        "timeout_s": float(s.timeout_s),
        "concurrency": int(s.concurrency),
        "lb_kind": s.lb_kind,
        "trace_on": bool(s.trace_on),
        "n_slots": int(s.n_slots),
        "n_regions": int(s.n_regions),
        "ready_rows": [np.flatnonzero(row).tolist() for row in s.ready_mask],
        "rtt": s.rtt.tolist(),
        "kill_slot": s.kill_slot.tolist(),
        "kill_g": s.kill_g.tolist(),
        "post_slots": s.post_slots.tolist(),
        "base": {f.name: (int if f.type == "int" else float)(
            getattr(s.base, f.name)) for f in dataclasses.fields(BaseMetrics)},
    }


def spec_matrix(n_seeds: int = 48) -> List[Cell]:
    """The matrix's cells for the first ``n_seeds`` seeds of the recorded
    spec (96 at 48, the quick matrix's 8 at 4), policy by policy, built by
    the port's own builder from the spec alone; ``run_cells`` runs them."""
    spec = load_recording()["spec"]
    sweep = dict(spec["sweep"], seeds=spec["sweep"]["seeds"][:n_seeds])
    return ScenarioSuite.from_spec(dict(spec, sweep=sweep)).cells()
