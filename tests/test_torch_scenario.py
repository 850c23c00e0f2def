"""The port's scenario-engine data plane against the reference, on the CPU.

Each regime runs one scenario through the reference's NumPy oracle
(``VectorizedServingEngine.run``) and through the port: the reference's
control plane records the cell's schedule (``JaxServingEngine.
record_schedule``, phase A), ``repro_torch.convert.schedule_from_arrays``
carries it over, and the port's ``run_schedules(device="cpu")`` replays the
data plane through the plain version of the ``scenario_scan`` kernel.  A
regime whose lane overflows the default queue pool runs through the port's
own ``run_cells`` instead, which reruns the lane on the port's oracle.  The
assertions are those of ``tests/test_jax_engine.py``: exact counts, cost to
1e-9, availability to 1e-12, sorted latencies to 1e-6.

The file also holds the port's copies (the Poisson tapes, the latency
model, the g5.48xlarge entry, the grid) equal to the reference's, and the
committed recording of the reference benchmark's 96-cell matrix
(``repro_torch/serving/torchengine/recorded_matrix.json``) equal to what the
reference records; ``build_recording`` makes it, and

    PYTHONPATH=src python tests/test_torch_scenario.py --write

writes it anew.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks.jax_engine import _spec as bench_spec  # noqa: E402
from repro.cluster.catalog import DEFAULT_INSTANCE_TYPES  # noqa: E402
from repro.cluster.traces import synth_correlated_trace  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.core.autoscaler import ConstantTarget, LoadAutoscaler  # noqa: E402
from repro.core.policy import make_policy  # noqa: E402
from repro.experiments.suite import ScenarioSuite  # noqa: E402
from repro.service.builder import build_service  # noqa: E402
from repro.serving.engine import VectorizedServingEngine  # noqa: E402
from repro.serving.jaxengine import JaxServingEngine  # noqa: E402
from repro.serving.jaxengine.schedule import build_grid as j_build_grid  # noqa: E402
from repro.serving.latency import LatencyModel as JLatencyModel  # noqa: E402
from repro.serving.load_balancer import RoundRobinBalancer  # noqa: E402
from repro.workloads import make_workload as j_make_workload  # noqa: E402
from repro_torch.cluster.catalog import G5_48XLARGE  # noqa: E402
from repro_torch.cluster.traces import synth_correlated_trace as t_synth_trace  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.convert import schedule_from_arrays  # noqa: E402
from repro_torch.core import autoscaler as tauto  # noqa: E402
from repro_torch.core.policy import make_policy as t_make_policy  # noqa: E402
from repro_torch.serving.latency import LatencyModel as TLatencyModel  # noqa: E402
from repro_torch.serving.torchengine import engine as teng  # noqa: E402
from repro_torch.serving.torchengine import recorded  # noqa: E402
from repro_torch.serving.torchengine.schedule import (  # noqa: E402
    BaseMetrics,
    build_grid,
    tape_arrays,
)
from repro_torch.workloads import make_workload as t_make_workload  # noqa: E402
from repro_torch.workloads.arrivals import Request as TRequest  # noqa: E402

CFG = j_config("llama3.2-1b")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _mini_trace(steps, seed, synth=synth_correlated_trace):
    zones = ["us-west-2a", "us-west-2b", "us-east-2a"]
    zmap = {z: z[:-1] for z in zones}
    return synth(zones, zmap, steps=steps, dt=60.0, seed=seed,
                 max_capacity=4, name="mini")


def _port_schedule(sched):
    """The reference ``CellSchedule`` carried over as numpy arrays."""
    return schedule_from_arrays({**vars(sched), "grid": vars(sched.grid),
                                 "base": vars(sched.base)})


def _cell(policy, workload, *, hours=1.0, seed=3, rate=0.8, autoscaler=None,
          lb_cls=None, timeout_s=60.0, concurrency=2, client_regions=None):
    """(oracle result, the port's schedule) of one scenario, as
    ``test_jax_engine._run_both`` builds it."""
    trace = _mini_trace(steps=int(hours * 60) + 60, seed=seed)
    rate_key = "rate_per_s" if workload == "poisson" else "base_rate_per_s"
    wargs = {rate_key: rate, "seed": seed}
    if client_regions is not None:
        wargs["client_regions"] = client_regions
    reqs = j_make_workload(workload, **wargs).generate(hours * 3600.0)
    engines = []
    for cls in (VectorizedServingEngine, JaxServingEngine):
        kwargs = dict(
            itype="g5.48xlarge",
            autoscaler=autoscaler() if autoscaler else ConstantTarget(3),
            timeout_s=timeout_s,
            concurrency=concurrency,
            workload_name=workload,
        )
        if lb_cls is not None:
            kwargs["lb"] = lb_cls()
        engines.append(cls(trace, make_policy(policy), reqs, CFG, **kwargs))
    duration = hours * 3600.0 + 600.0
    oracle = engines[0].run(duration)
    return oracle, _port_schedule(engines[1].record_schedule(duration))


def _port_cell(policy, workload, *, hours=1.0, seed=3, rate=0.8,
               autoscaler=None, lb_cls=None, timeout_s=60.0, concurrency=2,
               client_regions=None):
    """(oracle result, the port's own engine, duration) of one scenario:
    the port builds the same trace, policy and autoscaler itself, and the
    reference's requests are carried over as the port's."""
    rate_key = "rate_per_s" if workload == "poisson" else "base_rate_per_s"
    wargs = {rate_key: rate, "seed": seed}
    if client_regions is not None:
        wargs["client_regions"] = client_regions
    reqs = j_make_workload(workload, **wargs).generate(hours * 3600.0)
    steps = int(hours * 60) + 60
    kwargs = dict(itype="g5.48xlarge", timeout_s=timeout_s,
                  concurrency=concurrency, workload_name=workload)
    oracle = VectorizedServingEngine(
        _mini_trace(steps, seed), make_policy(policy), reqs, CFG,
        autoscaler=autoscaler() if autoscaler else ConstantTarget(3),
        **({"lb": lb_cls()} if lb_cls is not None else {}), **kwargs)
    port = teng.TorchServingEngine(
        _mini_trace(steps, seed, t_synth_trace), t_make_policy(policy),
        [TRequest(r.arrival_s, r.prompt_tokens, r.output_tokens, r.id,
                  r.client_region) for r in reqs],
        t_config("llama3.2-1b"),
        autoscaler=(_load_autoscaler(tauto) if autoscaler
                    else tauto.ConstantTarget(3)),
        lb="rr" if lb_cls is RoundRobinBalancer else "ll", **kwargs)
    duration = hours * 3600.0 + 600.0
    return oracle.run(duration), port, duration


def _assert_equivalent(vector, port):
    assert port.n_requests == vector.n_requests
    assert port.n_completed == vector.n_completed
    assert port.n_failed == vector.n_failed
    assert port.n_preemptions == vector.n_preemptions
    assert port.n_launch_failures == vector.n_launch_failures
    assert port.n_retried_requests == vector.n_retried_requests
    assert port.total_cost == pytest.approx(vector.total_cost, abs=1e-9)
    assert port.availability == pytest.approx(vector.availability, abs=1e-12)
    lat_v = np.sort(vector.latencies_s)
    lat_p = np.sort(port.latencies_s)
    assert len(lat_v) == len(lat_p)
    if len(lat_v):
        np.testing.assert_allclose(lat_p, lat_v, atol=1e-6, rtol=0)


def _load_autoscaler(mod=None):
    cls = LoadAutoscaler if mod is None else mod.LoadAutoscaler
    return cls(0.8, min_replicas=1, max_replicas=6, initial_target=2,
               upscale_delay_s=60.0, downscale_delay_s=300.0)


# ---------------------------------------------------------------------------
# the data plane against the oracle, regime by regime
# ---------------------------------------------------------------------------

# (id, _cell arguments, queue capacity (None: the default pool, through
# run_cells), what must show)
REGIMES = [
    # spot churn + preemption re-pends through the least-loaded balancer
    ("spothedge_poisson_ll", dict(policy="spothedge", workload="poisson"),
     256, "completed"),
    # bursty arrivals through the round-robin cursor (the Arena schedule is
    # the reference's: only the data plane is under test)
    ("even_spread_arena_rr", dict(policy="even_spread", workload="arena",
                                  lb_cls=RoundRobinBalancer), 256, "completed"),
    # autoscaler launches and terminations: kill events on both window
    # edges.  The diurnal spike queues more than 256 requests on one slot,
    # so the lane overflows the default pool and run_cells reruns it on the
    # port's oracle
    ("aws_spot_maf_load_autoscaler",
     dict(policy="aws_spot", workload="maf", autoscaler=_load_autoscaler),
     None, "completed"),
    # overload: deep queues, RTT-inclusive expiry, re-pended stragglers
    ("saturated_queues_and_expiry",
     dict(policy="spothedge", workload="poisson", rate=6.0, concurrency=1,
          timeout_s=30.0, hours=0.5), 256, "failed"),
    # the RTT term moves requests across a 2.5 s deadline
    ("cross_region_rtt_timeout_boundary",
     dict(policy="spothedge", workload="poisson", rate=2.0, timeout_s=2.5,
          client_regions={"us-west-2": 0.5, "us-east-2": 0.3,
                          "eu-west-1": 0.2}), 256, "failed"),
]


@pytest.mark.parametrize("args,capacity,shows",
                         [r[1:] for r in REGIMES], ids=[r[0] for r in REGIMES])
def test_data_plane_matches_oracle(args, capacity, shows):
    if capacity is None:
        oracle, eng, duration = _port_cell(**args)
        got = teng.run_cells([eng], [duration], device="cpu")
        assert eng.fell_back                       # the lane overflowed
    else:
        oracle, sched = _cell(**args)
        got = teng.run_schedules([sched], queue_capacity=capacity,
                                 device="cpu")
    assert getattr(oracle, f"n_{shows}") > 0      # the regime must bite
    _assert_equivalent(oracle, got[0])


def test_queue_overflow_returns_none():
    """A pool too small for the queue: ``run_schedules`` gives the lane back
    as ``None`` (``run_cells`` reruns it on the oracle)."""
    _, sched = _cell("spothedge", "poisson", rate=6.0, concurrency=1,
                     timeout_s=30.0, hours=0.25)
    outs = []
    assert teng.run_schedules([sched], queue_capacity=2, device="cpu",
                              outputs=outs) == [None]
    assert outs == [None]


def test_padded_group_matches_each_oracle():
    """Cells of one shape group with different N, R and E run as one padded
    group; each lane still gives its own oracle's result."""
    cells = [
        _cell("spothedge", "poisson", seed=3, hours=0.5),
        _cell("even_spread", "poisson", seed=5, rate=1.2, hours=0.5),
        _cell("spothedge", "poisson", seed=11, rate=0.5, hours=0.5),
    ]
    scheds = [s for _, s in cells]
    assert len({s.n for s in scheds}) == 3
    assert len({s.n_slots for s in scheds}) > 1
    assert len({s.n_events for s in scheds}) > 1
    assert len({(s.grid.signature, s.concurrency, s.lb_kind, s.trace_on)
                for s in scheds}) == 1
    outs = []
    got = teng.run_schedules(scheds, device="cpu", outputs=outs)
    for (oracle, _), res, out in zip(cells, got, outs):
        _assert_equivalent(oracle, res)
        assert set(out) >= {"status", "e2e", "a_ptr", "run_n", "q_cnt",
                            "n_retried", "overflow"}


def test_span_timelines_with_trace_on():
    """With ``trace_on`` every completed request's timeline closes: its
    finish minus arrival plus the RTT of its replica is its latency, and
    dispatch <= start <= finish.  Tracing changes no result."""
    oracle, sched = _cell("spothedge", "poisson", rate=2.0, hours=0.5,
                          client_regions={"us-west-2": 0.6, "eu-west-1": 0.4})
    traced = dataclasses.replace(sched, trace_on=True)
    outs = []
    res = teng.run_schedules([traced], device="cpu", outputs=outs)[0]
    _assert_equivalent(oracle, res)
    out = outs[0]
    done = out["status"] == 1
    assert done.sum() == oracle.n_completed
    rep = out["rep"][done]
    arr, rc = sched.arr[done], sched.rcode[done]
    e2e = (out["fin_t"][done] - arr) + sched.rtt[rep, rc]
    np.testing.assert_array_equal(e2e, out["e2e"][done])
    assert np.all(out["disp_t"][done] <= out["start_t"][done])
    assert np.all(out["start_t"][done] <= out["fin_t"][done])
    assert np.all(out["disp_t"][done] >= arr)
    assert np.all(out["rep"][out["status"] == 0] == -1)


# ---------------------------------------------------------------------------
# the port's copies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 31, 47])
@pytest.mark.parametrize("regions", [None, {"us-west-2": 0.6, "us-east-2": 0.3,
                                            "eu-west-1": 0.1}])
def test_poisson_tapes_are_the_references(seed, regions):
    kw = dict(rate_per_s=1.0, seed=seed, client_regions=regions)
    want = j_make_workload("poisson", **kw).generate(3300.0)
    got = t_make_workload("poisson", **kw).generate(3300.0)
    assert [(r.arrival_s, r.prompt_tokens, r.output_tokens, r.client_region)
            for r in got] == [(r.arrival_s, r.prompt_tokens, r.output_tokens,
                               r.client_region) for r in want]
    # the tape as the engine compiles it, to the bit
    eng = VectorizedServingEngine(_mini_trace(60, seed), make_policy("spothedge"),
                                  want, CFG, itype="g5.48xlarge")
    lm = TLatencyModel.for_model(t_config("llama3.2-1b"), G5_48XLARGE)
    arr, svc, rcode, regions_seen = tape_arrays(got, lm)
    np.testing.assert_array_equal(arr, eng._arr)
    np.testing.assert_array_equal(svc, eng._svc)
    np.testing.assert_array_equal(rcode, eng._rcode)
    assert regions_seen == eng._client_regions


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-moe-30b"])
def test_latency_model_is_the_references(arch):
    itype = next(t for t in DEFAULT_INSTANCE_TYPES if t.name == "g5.48xlarge")
    want = JLatencyModel.for_model(j_config(arch), itype)
    got = TLatencyModel.for_model(t_config(arch), G5_48XLARGE)
    for name in ("n_params", "mfu_prefill", "mbu_decode", "overhead_s",
                 "_active_params", "flops_per_s", "hbm_bytes_per_s"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.decode_s_per_token() == want.decode_s_per_token()
    for p, o in ((1, 1), (200, 150), (2048, 7)):
        assert got.prefill_s(p) == want.prefill_s(p)
        assert got.service_s(p, o) == want.service_s(p, o)


def test_g5_48xlarge_is_the_references():
    want = next(t for t in DEFAULT_INSTANCE_TYPES if t.name == "g5.48xlarge")
    assert dataclasses.asdict(G5_48XLARGE) == dataclasses.asdict(want)
    assert G5_48XLARGE.spot_price == want.spot_price


@pytest.mark.parametrize("duration,dt,sub", [(3600.0, 15.0, 1.0),
                                             (4200.0, 15.0, 1.0),
                                             (1000.0, 7.0, 0.3)])
def test_grid_is_the_references(duration, dt, sub):
    want, got = j_build_grid(duration, dt, sub), build_grid(duration, dt, sub)
    for f in ("ts", "win_of", "win_first"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype
    assert (got.ticks, got.signature) == (want.ticks, want.signature)


def test_schedule_from_arrays_carries_every_field():
    _, sched = _cell("spothedge", "poisson", hours=0.25)
    assert sched.base == BaseMetrics(**{
        f.name: getattr(sched.base, f.name)
        for f in dataclasses.fields(BaseMetrics)})
    assert sched.rcode.dtype == np.int64 and sched.ready_mask.dtype == bool
    with pytest.raises(KeyError):
        schedule_from_arrays({"grid": vars(sched.grid)})


# ---------------------------------------------------------------------------
# the recorded matrix
# ---------------------------------------------------------------------------


def _result_record(r) -> dict:
    lat = r.latencies_s
    return {
        "n_requests": int(r.n_requests),
        "n_completed": int(r.n_completed),
        "n_failed": int(r.n_failed),
        "n_retried_requests": int(r.n_retried_requests),
        "p50_s": r.pct(50),
        "p90_s": r.pct(90),
        "p99_s": r.pct(99),
        "mean_s": float(lat.mean()),
        "total_cost": float(r.total_cost),
        "spot_cost": float(r.spot_cost),
        "od_cost": float(r.od_cost),
        "cost_vs_ondemand": float(r.cost_vs_ondemand),
        "availability": float(r.availability),
        "n_preemptions": int(r.n_preemptions),
        "n_launch_failures": int(r.n_launch_failures),
    }


def _matrix_cells(engine, keep=None):
    """(labels, resolved service) of the benchmark matrix's cells, built by
    the reference's own suite expansion (``engine``: "jax" to record
    schedules, "vector" for the oracle)."""
    suite = ScenarioSuite.from_spec(bench_spec(48, 1.0))
    for sc in suite.scenarios:
        if keep is not None and (sc.labels["policy"], sc.labels["seed"]) not in keep:
            continue
        spec = dataclasses.replace(
            sc.spec, sim=dataclasses.replace(sc.spec.sim, engine=engine))
        yield sc.labels, spec, build_service(spec, trace=sc.trace)


def _reference_schedules():
    return [(labels, res.simulator.record_schedule(spec.sim.duration_s))
            for labels, spec, res in _matrix_cells("jax")]


def build_recording(oracle: bool = True) -> dict:
    """The recording of the reference benchmark's matrix: its spec, grid,
    one control plane per policy (each must serve every seed) and, with
    ``oracle``, every cell's oracle result."""
    spec = bench_spec(48, 1.0)
    planes, cells = {}, []
    grid = None
    for labels, sched in _reference_schedules():
        plane = recorded.plane_of(sched)
        pol = labels["policy"]
        if planes.setdefault(pol, plane) != plane:
            raise AssertionError(f"{pol}: seed {labels['seed']} has another "
                                 "control plane")
        grid = sched.grid
        cells.append({"policy": pol, "seed": labels["seed"]})
    if oracle:
        results = {(lb["policy"], lb["seed"]): _result_record(
            res.simulator.run(sp.sim.duration_s))
            for lb, sp, res in _matrix_cells("vector")}
        for c in cells:
            c["result"] = results[(c["policy"], c["seed"])]
    return {
        "source": "benchmarks/jax_engine.py _spec(48, 1.0); planes recorded "
                  "by JaxServingEngine.record_schedule, results by "
                  "VectorizedServingEngine.run",
        "spec": spec,
        "grid": {"duration_s": spec["sim"]["duration_hours"] * 3600.0,
                 "control_interval_s": grid.dt, "sub_step_s": grid.sub_step_s},
        "planes": planes,
        "cells": cells,
    }


def _dumps(rec: dict) -> str:
    """One top-level key a line, one cell a line."""
    items = list(rec.items())
    lines = ["{"]
    for k, (key, val) in enumerate(items):
        if key == "cells":
            body = "[\n" + ",\n".join("  " + json.dumps(c) for c in val) + "\n ]"
        else:
            body = json.dumps(val)
        lines.append(f" {json.dumps(key)}: {body}" + ("," if k + 1 < len(items) else ""))
    return "\n".join(lines + ["}"]) + "\n"


@pytest.fixture(scope="module")
def reference_matrix():
    return _reference_schedules()


def test_recording_is_what_the_reference_records(reference_matrix):
    """Spec, grid and the two control planes equal a fresh recording of the
    reference benchmark's matrix, and every cell the port rebuilds equals
    the reference's schedule: tapes to the bit, planes exactly."""
    rec = recorded.load_recording()
    assert rec["spec"] == bench_spec(48, 1.0)
    fresh = json.loads(json.dumps(build_recording(oracle=False)))
    for key in ("spec", "grid", "planes"):
        assert rec[key] == fresh[key], key
    assert [(c["policy"], c["seed"]) for c in rec["cells"]] == [
        (c["policy"], c["seed"]) for c in fresh["cells"]]
    got = recorded.recorded_matrix()
    assert len(got) == len(reference_matrix) == 96
    for (labels, want), have in zip(reference_matrix, got):
        assert have.policy_name == labels["policy"] == want.policy_name
        for f in ("arr", "svc", "rcode", "ready_mask", "rtt", "kill_slot",
                  "kill_g", "post_slots"):
            np.testing.assert_array_equal(getattr(have, f), getattr(want, f))
        for f in ("n_regions", "timeout_s", "concurrency", "lb_kind",
                  "n_slots", "trace_on", "trace_name", "workload_name"):
            assert getattr(have, f) == getattr(want, f), f
        np.testing.assert_array_equal(have.grid.ts, want.grid.ts)
        np.testing.assert_array_equal(have.grid.win_of, want.grid.win_of)
        assert have.base == _port_schedule(want).base
    assert {s.n_slots for s in got} == {10, 4}
    assert 3088 <= min(s.n for s in got) and max(s.n for s in got) <= 3406


def test_recorded_results_are_the_oracles():
    """The recorded oracle results of the first and last seed of each
    policy equal a fresh oracle run."""
    keep = {(p, s) for p in ("spothedge", "even_spread") for s in (0, 47)}
    cells = {(c["policy"], c["seed"]): c["result"]
             for c in recorded.load_recording()["cells"]}
    seen = 0
    for labels, spec, res in _matrix_cells("vector", keep):
        want = _result_record(res.simulator.run(spec.sim.duration_s))
        assert cells[(labels["policy"], labels["seed"])] == want
        seen += 1
    assert seen == 4


def _assert_matches_record(res, want):
    for k in ("n_requests", "n_completed", "n_failed", "n_retried_requests",
              "n_preemptions", "n_launch_failures"):
        assert getattr(res, k) == want[k], k
    for k in ("total_cost", "spot_cost", "od_cost", "cost_vs_ondemand"):
        assert getattr(res, k) == pytest.approx(want[k], abs=1e-9), k
    assert res.availability == pytest.approx(want["availability"], abs=1e-12)
    for q in (50, 90, 99):
        assert res.pct(q) == pytest.approx(want[f"p{q}_s"], abs=1e-6)
    assert float(res.latencies_s.mean()) == pytest.approx(want["mean_s"], abs=1e-6)


def test_quick_matrix_through_the_plain_version():
    """The 8-cell quick matrix (seeds 0-3 of both policies) end to end on
    the CPU: one shape group, every cell equal to its recorded result."""
    scheds = recorded.recorded_matrix(n_seeds=4)
    cells = recorded.recorded_cells(n_seeds=4)
    assert len(scheds) == len(cells) == 8
    got = teng.run_schedules(scheds, device="cpu")
    for res, cell in zip(got, cells):
        assert res is not None and res.policy == cell["policy"]
        _assert_matches_record(res, cell["result"])
    # spothedge holds more availability than even_spread at a higher cost
    assert got[0].availability > got[4].availability
    assert got[0].cost_vs_ondemand > got[4].cost_vs_ondemand


def _pool_layout_bytes(R: int, C: int, Q: int, trace_on: bool) -> int:
    """Shared memory of a lane in the kernel's earlier layout, whose queue
    was a pool of Q cells a slot scanned whole on every push and pop (age,
    request, sequence number, valid flag; dispatch time with trace_on) and
    whose tape and pending ring lived in device memory."""
    doubles = R * C + R * Q + R + (2 * R * C + R * Q if trace_on else 0)
    ints = R * C + 2 * R * Q + 2 * R
    return 8 * doubles + 4 * ints + R * Q + 2 * R


@pytest.mark.parametrize("trace_on", [False, True])
def test_scenario_smem_plan_at_the_matrix_shape(trace_on):
    """The reference benchmark's matrix (R=10, C=4, Q=256, NREG=9) keeps the
    whole pending ring share and tape window; ``smem_bytes`` is the sum of
    its arrays, each array's bytes growing with its own dimension."""
    from repro_torch.kernels import scenario_scan as tscn

    nbytes, pend, tape = tscn.smem_plan(10, 4, 256, 9, trace_on)
    assert (pend, tape) == (tscn.PEND_CAP, tscn.TAPE_CAP)
    assert nbytes == tscn.smem_bytes(10, 4, 256, 9, trace_on, pend, tape)
    assert nbytes == (82_752 if trace_on else 61_632)
    base = tscn.smem_bytes(10, 4, 256, 9, trace_on, pend, tape)
    per_cell = 20 if trace_on else 12          # request, age (, dispatch)
    per_run = 44 if trace_on else 28           # finish, arrival, RTT, request
    for dim, step in (("Q", 10 * per_cell), ("C", 10 * per_run),
                      ("NREG", 10 * 12), ("pend", 4), ("tape", 20)):
        grown = dict(R=10, C=4, Q=256, NREG=9, pend=pend, tape=tape)
        grown[dim] += 1
        assert tscn.smem_bytes(grown["R"], grown["C"], grown["Q"], grown["NREG"],
                               trace_on, grown["pend"], grown["tape"]) == base + step
    # a slot: its queue ring, running row, ready-list entry and RTT and rank
    # per region; past the first 32 also its 40 bytes of counters (a
    # thread keeps its first slot's in registers)
    per_slot = 256 * per_cell + 4 * per_run + 4 + 9 * 12
    size = lambda R: tscn.smem_bytes(R, 4, 256, 9, trace_on, pend, tape)  # noqa: E731
    assert size(32) - size(31) == per_slot
    assert size(33) - size(32) == per_slot + 40


def test_scenario_smem_plan_shrinks_the_ring_and_window_then_refuses():
    """A lane state that leaves little room halves the pending ring's share
    and the tape window (powers of two, down to 32 and 128 entries); what
    does not fit even then is over the limit, and the launch refuses it."""
    from repro_torch.kernels import scenario_scan as tscn

    plans = [tscn.smem_plan(10, 4, Q, 9, True) for Q in (256, 900, 1000, 1100, 1200)]
    caps = [(p, t) for _, p, t in plans]
    assert caps[0] == (2048, 1024)
    assert caps == sorted(caps, reverse=True) and len(set(caps)) > 2
    for nbytes, pend, tape in plans[:-1]:
        assert nbytes <= tscn.MAX_SMEM_BYTES
        assert pend & (pend - 1) == 0 and tape & (tape - 1) == 0
        assert pend >= tscn.MIN_PEND_CAP and tape >= tscn.MIN_TAPE_CAP
    nbytes, pend, tape = plans[-1]
    assert nbytes > tscn.MAX_SMEM_BYTES
    assert (pend, tape) == (tscn.MIN_PEND_CAP, tscn.MIN_TAPE_CAP)


def test_scenario_smem_plan_takes_what_the_pool_layout_took():
    """Every slot count, concurrency, queue capacity and region count whose
    lane fit the pool layout fits the ring layout too, wherever the queue
    holds at least 4 C + 2 NREG + 8 cells (the matrix: 256 >= 42): a queue
    cell takes 5 bytes less, which pays for the running rows' arrival and
    RTT, the RTT and rank tables and the tape window.  The tape's length is
    not a dimension of either: it streams."""
    from repro_torch.kernels import scenario_scan as tscn

    n = 0
    for R in range(1, 257, 3):
        for C in (1, 2, 4, 8, 16, 32, 64):
            for Q in (16, 64, 100, 128, 256, 512, 1024, 4096):
                for NREG in (1, 2, 9, 16, 32):
                    if Q < 4 * C + 2 * NREG + 8:
                        continue
                    for trace_on in (False, True):
                        if _pool_layout_bytes(R, C, Q, trace_on) > tscn.MAX_SMEM_BYTES:
                            continue
                        n += 1
                        nbytes = tscn.smem_plan(R, C, Q, NREG, trace_on)[0]
                        assert nbytes <= tscn.MAX_SMEM_BYTES, (R, C, Q, NREG, trace_on)
    assert n > 5000


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: PYTHONPATH=src python tests/test_torch_scenario.py --write")
    with open(recorded.RECORDING, "w") as f:
        f.write(_dumps(build_recording()))
    print(f"wrote {recorded.RECORDING}")
