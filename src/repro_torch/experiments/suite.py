"""ScenarioSuite, expand a spec's grid and run every cell: the port's own
copy of ``repro.experiments.suite``.

``ScenarioSuite.from_spec`` crosses the sweep's ``policies x traces x
workloads x seeds x forecasters x replica_models x migration`` in the
reference's order, with its labels, cell names and shared-tape keys: cells
with equal workload, seed and arrival horizon replay one request tape.  A
forecasters axis collapses to one unlabelled cell for a policy that
ignores the forecast, and a migration axis to one for a request-model
cell, which has no KV to migrate.  ``run`` takes the serve CLI's engine
rule: by default (``engine="jax"``) the cells run as one matrix, every
cell built and its control plane replayed on the host (phase A), then
every request-model data plane through ``run_cells``, one
``scenario_scan`` launch per shape group on the card, an overflowed lane
rerun on the oracle, and every token-model cell on the host engine beside
them; ``engine="vector"`` or ``"legacy"`` runs them on that host engine,
one by one or, with ``workers``, fanned out over worker processes forked
from a clean server (``"forkserver"``) that run the host engine only;
results are identical for any worker count.  The report carries every
cell's registry snapshot merged (``metrics``).
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import itertools
import multiprocessing
import multiprocessing.context
import os
from multiprocessing import forkserver
import time
from typing import (
    Any, Dict, Hashable, List, Mapping, Optional, Sequence, Tuple, Union,
)

import torch

from repro_torch import resolve_device
from repro_torch.cluster.traces import SpotTrace
from repro_torch.core.policy import policy_class
from repro_torch.experiments.report import CellResult, ScenarioReport
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.serving.torchengine.engine import TorchServingEngine, run_cells
from repro_torch.service.builder import (
    ENTRY_ENGINE,
    build_requests,
    build_service,
    with_engine,
)
from repro_torch.service.loader import load_spec
from repro_torch.service.spec import (
    ForecastSpec,
    MigrationSpec,
    ServiceSpec,
    SpecError,
    SweepSpec,
)
from repro_torch.workloads.arrivals import Request

__all__ = ["Cell", "Scenario", "ScenarioSuite"]

# label axes may not shadow metric fields: CellResult.to_dict flattens
# labels and metrics into one record
_RESERVED_LABELS = frozenset(
    f.name for f in dataclasses.fields(CellResult) if f.name != "labels")


@dataclasses.dataclass
class Scenario:
    """One cell of a matrix: labels and a single-run spec.  ``trace``
    optionally overrides the spec's named trace; scenarios sharing a
    ``tape_key`` replay one request tape."""

    labels: Dict[str, Any]
    spec: ServiceSpec
    trace: Optional[SpotTrace] = None
    tape_key: Optional[Hashable] = None

    def __post_init__(self) -> None:
        if self.spec.sweep is not None:
            raise SpecError("a Scenario wraps a single-run spec; expand the "
                            "sweep with ScenarioSuite.from_spec first")
        clash = set(self.labels) & _RESERVED_LABELS
        if clash:
            raise SpecError(f"scenario label axes {sorted(clash)} collide "
                            "with CellResult metric fields; pick different "
                            "axis names")

    @property
    def cell_id(self) -> str:
        return "/".join(str(v) for v in self.labels.values())


@dataclasses.dataclass
class Cell:
    """A scenario built on the two-phase engine, ready for ``run_cells``."""

    labels: Dict[str, Any]
    spec: ServiceSpec
    engine: TorchServingEngine
    build_s: float = 0.0

    @property
    def duration_s(self) -> float:
        return self.spec.sim.duration_s


def _canonical_args(value: Any, path: str = "workload.args") -> Hashable:
    """A hashable, order-insensitive form of a workload-args value for the
    tape key; only JSON-like values are accepted, so the key is stable."""
    if value is None or isinstance(value, str):
        return value
    if isinstance(value, bool):
        # True == 1 under equality, but they must not share a tape
        return ("__bool__", value)
    if isinstance(value, (int, float)):
        return value
    if isinstance(value, (list, tuple)):
        return tuple(_canonical_args(v, f"{path}[{k}]")
                     for k, v in enumerate(value))
    if isinstance(value, Mapping):
        items = []
        for k in sorted(value, key=str):
            if not isinstance(k, str):
                raise SpecError(f"{path}: mapping key {k!r} is not a string; "
                                "tape keys require string-keyed mappings")
            items.append((k, _canonical_args(value[k], f"{path}.{k}")))
        return tuple(items)
    raise SpecError(f"{path}: cannot canonicalize {type(value).__name__} "
                    f"value {value!r} for the shared-tape key; workload args "
                    "must be JSON-like")


def _workload_tape_key(spec: ServiceSpec) -> Tuple:
    """Tapes are equal iff workload spec and arrival horizon are equal."""
    w = spec.workload
    return (w.kind, w.rate_per_s, w.seed, _canonical_args(dict(w.args)),
            spec.sim.duration_s - spec.sim.drain_s)


def _disambiguate(names: List[str],
                  knobs: List[List[Tuple[str, Any]]]) -> List[str]:
    """Axis labels: the bare name when unique, name[knob=...] or name#k
    when several grid entries share it."""
    counts: Dict[str, int] = {}
    for n in names:
        counts[n] = counts.get(n, 0) + 1
    seen: Dict[str, int] = {}
    out: List[str] = []
    for n, kv in zip(names, knobs):
        if counts[n] == 1:
            out.append(n)
            continue
        k = seen[n] = seen.get(n, 0) + 1
        detail = ",".join(f"{key}={v}" for key, v in kv)
        out.append(f"{n}[{detail}]" if detail else f"{n}#{k}")
    if len(set(out)) != len(out):       # identical knob sets: index them
        out = [lab if out.count(lab) == 1 else f"{lab}#{i}"
               for i, lab in enumerate(out)]
    return out


class ScenarioSuite:
    """A batch of scenarios sharing one execution path."""

    def __init__(self, scenarios: Sequence[Scenario],
                 name: str = "suite") -> None:
        self.scenarios: List[Scenario] = list(scenarios)
        self.name = name
        if not self.scenarios:
            raise SpecError("ScenarioSuite needs at least one scenario")
        # shared tapes by (tape_key, workload fingerprint)
        self._tapes: Dict[Hashable, List[Request]] = {}

    def __len__(self) -> int:
        return len(self.scenarios)

    @classmethod
    def from_spec(cls, spec: Union[ServiceSpec, Mapping[str, Any], str],
                  name: Optional[str] = None) -> "ScenarioSuite":
        """Expand a spec's ``sweep`` grid (missing axes fall back to the
        base spec's single value)."""
        base = load_spec(spec)
        sweep = base.sweep or SweepSpec()
        policies = sweep.policies or (base.replica_policy,)
        traces = sweep.traces or (base.trace,)
        workloads = sweep.workloads or (base.workload,)
        # no seeds axis: every workload keeps its own seed
        seeds: Tuple[Optional[int], ...] = sweep.seeds or (None,)
        # no forecasters / replica_models / migration axis: every cell keeps
        # the base spec's value and no label column is emitted
        forecasters: Tuple[Optional[str], ...] = sweep.forecasters or (None,)
        replica_models: Tuple[Optional[str], ...] = (sweep.replica_models
                                                     or (None,))
        migrations: Tuple[Union[bool, MigrationSpec, None], ...] = (
            sweep.migration or (None,))
        policy_labels = _disambiguate(
            [p.name for p in policies],
            [sorted(p.policy_kwargs().items()) for p in policies])
        workload_labels = _disambiguate(
            [w.kind for w in workloads],
            [[("rate_per_s", w.rate_per_s), ("seed", w.seed),
              *sorted(w.args.items())] for w in workloads])
        scenarios: List[Scenario] = []
        for (pol, plabel), tr, (wl, wlabel), seed, fc, rm, mg in (
                itertools.product(zip(policies, policy_labels), traces,
                                  zip(workloads, workload_labels), seeds,
                                  forecasters, replica_models, migrations)):
            if fc is not None and not getattr(policy_class(pol.name),
                                              "uses_forecast", False):
                # a policy that ignores the forecast would rerun one cell
                # per forecaster: one unlabelled cell stands for the axis
                if fc != forecasters[0]:
                    continue
                fc = None
            cell_rm = rm if rm is not None else base.sim.replica_model
            if mg is not None and cell_rm != "token":
                # a request-model cell has no KV to migrate: one
                # unlabelled cell stands for the whole migration axis
                if mg != migrations[0]:
                    continue
                mg = None
            wl_seeded = wl if seed is None else dataclasses.replace(wl,
                                                                    seed=seed)
            forecast = base.forecast
            if fc is not None:
                forecast = dataclasses.replace(base.forecast or ForecastSpec(),
                                               name=fc)
            sim = base.sim
            if rm is not None and sim.replica_model != rm:
                sim = dataclasses.replace(sim, replica_model=rm)
            migration = base.migration
            mig_label: Optional[str] = None
            if mg is not None:
                migration = (dataclasses.replace(base.migration
                                                 or MigrationSpec(), enabled=mg)
                             if isinstance(mg, bool) else mg)
                mig_label = "on" if migration.enabled else "off"
            if (migration is not None and migration.enabled
                    and cell_rm != "token"):
                # the base section enabled on a request-model cell of a
                # mixed sweep: the token cells keep it, this one drops it
                migration = None
            cell_spec = dataclasses.replace(
                base,
                name=(f"{base.name}-{plabel}-{tr}-{wlabel}-s{wl_seeded.seed}"
                      + (f"-{fc}" if fc is not None else "")
                      + (f"-{rm}" if rm is not None else "")
                      + (f"-mig_{mig_label}" if mig_label is not None
                         else "")),
                replica_policy=pol, trace=tr, workload=wl_seeded,
                forecast=forecast, migration=migration, sim=sim, sweep=None)
            labels = {"policy": plabel, "trace": tr, "workload": wlabel,
                      "seed": wl_seeded.seed}
            if fc is not None:
                labels["forecaster"] = fc
            if rm is not None:
                labels["replica_model"] = rm
            if mig_label is not None:
                labels["migration"] = mig_label
            scenarios.append(Scenario(
                labels=labels, spec=cell_spec,
                tape_key=_workload_tape_key(cell_spec)))
        return cls(scenarios, name=name or base.name)

    # ------------------------------------------------------------------
    def _tape(self, sc: Scenario) -> Optional[List[Request]]:
        """The scenario's shared tape (``None``: it makes its own)."""
        if sc.tape_key is None:
            return None
        # the workload fingerprint keeps two scenarios that reuse a key
        # with different workloads from sharing a tape
        key = (sc.tape_key, _workload_tape_key(sc.spec))
        if key not in self._tapes:
            self._tapes[key] = build_requests(sc.spec)
        return self._tapes[key]

    def cells(self) -> List[Cell]:
        """Every scenario built on the two-phase engine (``sim.engine:
        jax``), shared tapes shared; run them with ``run_cells``."""
        out = []
        for sc in self.scenarios:
            spec = with_engine(sc.spec, "jax")
            requests = self._tape(sc)
            t0 = time.perf_counter()
            resolved = build_service(spec, trace=sc.trace, requests=requests)
            out.append(Cell(sc.labels, spec, resolved.simulator,
                            time.perf_counter() - t0))
        return out

    def run(
        self,
        *,
        engine: Optional[str] = ENTRY_ENGINE,
        workers: Optional[Union[int, str]] = None,
        save_to: Optional[str] = None,
        progress: bool = False,
        device: Union[str, torch.device, None] = None,
    ) -> ScenarioReport:
        """Run every scenario; returns the report.

        ``engine`` overrides every cell's ``sim.engine``, as the serve
        CLI's ``--engine`` does: ``jax`` by default, ``vector`` or
        ``legacy`` for a host engine (which refuses a ``device`` other than
        the CPU), ``None`` for each cell's own.  Under ``jax`` (given, or
        every cell's) the suite runs as one matrix through ``run_cells``;
        ``device`` is phase B's (default CUDA), and the report counts the
        shape groups (one launch each) and names the lanes rerun on the
        oracle and the token cells run on the host engine; ``workers`` is
        ignored there (the batch is the parallelism) and the report says 1.
        Otherwise cells run on the host engine, one by one or fanned out
        over ``workers`` processes (an int >= 1, or ``"auto"``: one per
        CPU).  ``save_to`` writes the JSON artifact into that directory."""
        n_workers = _resolve_workers(workers)
        t0 = time.perf_counter()
        use_jax = engine == "jax" or (engine is None and all(
            sc.spec.sim.engine == "jax" for sc in self.scenarios))
        groups: Optional[int] = None
        reruns: List[str] = []
        on_host: List[str] = []
        if use_jax:
            n_workers = 1
            cells, groups, reruns, on_host = self._run_matrix(progress,
                                                              device)
        elif n_workers <= 1 or len(self.scenarios) <= 1:
            n_workers = 1
            cells = []
            for sc in self.scenarios:
                cells.append(_run_scenario(sc, engine, self._tape(sc),
                                           device))
                if progress:
                    print(f"[suite {self.name}] {cells[-1].cell_id} done "
                          f"({len(cells)}/{len(self.scenarios)})", flush=True)
        else:
            cells = self._run_parallel(n_workers, engine, progress, device)
        snaps = [c.metrics for c in cells if c.metrics]
        report = ScenarioReport(
            suite=self.name, engine=engine or self._engine_label(),
            workers=n_workers,
            cells=cells, wall_s=time.perf_counter() - t0,
            shape_groups=groups, oracle_reruns=reruns,
            host_token_cells=on_host,
            metrics=MetricsRegistry.merge_snapshots(snaps) or None)
        if progress:
            # the cells a paging SLO would flag, worst burn first
            for c in report.burn_ranking():
                b = c.slo_burn
                if b["alert_windows"]:
                    print(f"[suite {self.name}] SLO burn alert: "
                          f"{c.cell_id} {b['alert_minutes']:.1f}min "
                          f"over {b['alert_windows']} windows", flush=True)
        if save_to is not None:
            report.save(save_to)
        return report

    def _run_matrix(self, progress: bool, device
                    ) -> Tuple[List[CellResult], int, List[str], List[str]]:
        """The matrix path: build every cell, replay every control plane,
        then every data plane in one ``run_cells`` call (a token cell on
        the host engine)."""
        dev = resolve_device(device)        # before phase A, not after
        cells = self.cells()
        t0 = time.perf_counter()
        groups: List[List[int]] = []
        results = run_cells([c.engine for c in cells],
                            [c.duration_s for c in cells], groups=groups,
                            device=dev)
        # the batch is one program: its wall clock is shared evenly
        share = (time.perf_counter() - t0) / len(cells)
        out: List[CellResult] = []
        for cell, result in zip(cells, results):
            out.append(CellResult.from_result(cell.labels, result,
                                              cell.build_s + share))
            if progress:
                rerun = " (lane overflowed: rerun on the oracle)" \
                    if cell.engine.fell_back else ""
                print(f"[suite {self.name}] {out[-1].cell_id} done "
                      f"({len(out)}/{len(cells)}){rerun}", flush=True)
        reruns = [r.cell_id for r, c in zip(out, cells) if c.engine.fell_back]
        on_host = [r.cell_id for r, c in zip(out, cells)
                   if c.engine.ran_on_host]
        return out, len(groups), reruns, on_host

    def _run_parallel(self, n_workers: int, engine: Optional[str],
                      progress: bool, device) -> List[CellResult]:
        """Every cell on the host engine in a pool of ``n_workers``
        processes.  Each payload carries the cell's shared tape, built
        once here: a worker never makes a tape of its own."""
        payloads = [(sc, engine, self._tape(sc), device)
                    for sc in self.scenarios]
        cells: List[Optional[CellResult]] = [None] * len(payloads)
        with cf.ProcessPoolExecutor(max_workers=min(n_workers, len(payloads)),
                                    mp_context=_forkserver()) as pool:
            futures = {pool.submit(_run_scenario, *p): i
                       for i, p in enumerate(payloads)}
            n_done = 0
            for fut in cf.as_completed(futures):
                i = futures[fut]
                cells[i] = fut.result()
                n_done += 1
                if progress:
                    print(f"[suite {self.name}] {cells[i].cell_id} done "
                          f"({n_done}/{len(payloads)})", flush=True)
        # a lost future is a loud failure, never a shorter report
        missing = [self.scenarios[i].cell_id
                   for i, c in enumerate(cells) if c is None]
        if missing:
            raise RuntimeError(
                f"scenario suite {self.name!r}: {len(missing)} of "
                f"{len(cells)} cells never returned a result (lost futures): "
                f"{missing}")
        return [c for c in cells if c is not None]

    def _engine_label(self) -> str:
        engines = {sc.spec.sim.engine for sc in self.scenarios}
        return engines.pop() if len(engines) == 1 else "mixed"


def _forkserver() -> multiprocessing.context.BaseContext:
    """The workers' start method, ``forkserver``: a worker forks from a
    server process that holds no thread of this one (a forked copy of a
    process that has run a HiGHS solve or holds a CUDA context can hang)
    and that has imported this package once, so a worker does not spend
    seconds importing torch.  Python 3.12.3's server finds the modules it
    preloads through ``PYTHONPATH`` only (later versions also copy
    ``sys.path``), so the server is started with this package's root on
    it; the variable is restored at once.  A worker runs the host engine
    only and never touches the card."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(p for p in (root, old) if p)
    try:
        forkserver.ensure_running()
    finally:
        if old is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = old
    return ctx


def _resolve_workers(workers: Union[int, str, None]) -> int:
    if workers is None:
        return 1
    if workers == "auto":
        return os.cpu_count() or 1
    try:
        n = int(workers)
    except (TypeError, ValueError):
        raise SpecError(f"workers must be an int >= 1 or 'auto', got "
                        f"{workers!r}") from None
    if n < 1:
        raise SpecError(f"workers must be an int >= 1 or 'auto', got {n}")
    return n


def _run_scenario(sc: Scenario, engine: Optional[str],
                  requests: Optional[List[Request]],
                  device) -> CellResult:
    """Build and run one cell on a host engine (a worker's task too)."""
    spec = with_engine(sc.spec, engine)
    t0 = time.perf_counter()
    resolved = build_service(spec, trace=sc.trace, requests=requests)
    result = resolved.run(device=device)
    return CellResult.from_result(sc.labels, result, time.perf_counter() - t0)
