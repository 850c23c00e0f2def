"""The port's control plane and request-model oracle against the reference,
on the CPU.

The port keeps its own copies of SkyServe's control plane (catalog, spot
traces, instance FSM, cluster simulator, SpotHedge and the baselines, the
autoscalers), of the serving engine's request model (the NumPy oracle), of
the scenario engine's phase A (``TorchServingEngine.record_schedule``) and
of the spec -> cells builder.  Each is held here against the reference on
the same inputs: the catalog and the traces to the bit, each policy's
``SimResult`` exactly (costs and availability to 1e-12), phase A field for
field, the oracle at the tolerances of ``tests/test_jax_engine.py`` (counts
exact, cost 1e-9, availability 1e-12, latencies 1e-6), and the matrix the
port builds from the reference benchmark's spec against the committed
recording (``repro_torch/serving/torchengine/recorded_matrix.json``).
"""

import dataclasses
import importlib
import json
import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import repro.cluster.catalog as jcat  # noqa: E402
import repro.cluster.traces as jtr  # noqa: E402
import repro_torch.cluster.catalog as tcat  # noqa: E402
import repro_torch.cluster.traces as ttr  # noqa: E402
from benchmarks.jax_engine import _spec as bench_spec  # noqa: E402
from repro.cluster.simulator import ClusterSimulator as JClusterSimulator  # noqa: E402
from repro.cluster.simulator import SimConfig as JSimConfig  # noqa: E402
from repro.cluster.simulator import run_policy_on_trace as j_run_policy  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.core import autoscaler as jauto  # noqa: E402
from repro.core.policy import make_policy as j_make_policy  # noqa: E402
from repro.core.policy import registered_policies as j_registered  # noqa: E402
from repro.serving.engine import VectorizedServingEngine as JVector  # noqa: E402
from repro.serving.jaxengine import JaxServingEngine  # noqa: E402
from repro.serving.load_balancer import RoundRobinBalancer  # noqa: E402
from repro.service import spec as jspec  # noqa: E402
from repro.workloads import make_workload as j_make_workload  # noqa: E402
from repro_torch.cluster.simulator import ClusterSimulator as TClusterSimulator  # noqa: E402
from repro_torch.cluster.simulator import SimConfig as TSimConfig  # noqa: E402
from repro_torch.cluster.simulator import run_policy_on_trace as t_run_policy  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.core import autoscaler as tauto  # noqa: E402
from repro_torch.core.policy import make_policy as t_make_policy  # noqa: E402
from repro_torch.core.policy import registered_policies as t_registered  # noqa: E402
from repro_torch.experiments import ScenarioSuite  # noqa: E402
from repro_torch.obs import ObsRecorder, dumps_jsonl  # noqa: E402
from repro_torch.serving.engine import VectorizedServingEngine as TVector  # noqa: E402
from repro_torch.serving.torchengine import engine as teng  # noqa: E402
from repro_torch.serving.torchengine import recorded  # noqa: E402
from repro_torch.serving.torchengine.schedule import BaseMetrics  # noqa: E402
from repro_torch.service import spec as tspec  # noqa: E402
from repro_torch.service.builder import build_service  # noqa: E402
from repro_torch.workloads.arrivals import Request  # noqa: E402

POLICIES = ["spothedge", "even_spread", "round_robin", "static_mixture",
            "aws_spot", "mark_like", "ondemand_only", "spot_only",
            "omniscient", "risk_spothedge"]
TRACES = ["aws-1", "aws-2", "aws-3", "gcp-1", "cpu-ref"]


# ---------------------------------------------------------------------------
# catalog
# ---------------------------------------------------------------------------


def test_zones_clouds_and_tables_are_the_references():
    assert [dataclasses.asdict(z) for z in tcat.DEFAULT_ZONES] == [
        dataclasses.asdict(z) for z in jcat.DEFAULT_ZONES]
    assert [dataclasses.asdict(c) for c in tcat.DEFAULT_CLOUDS] == [
        dataclasses.asdict(c) for c in jcat.DEFAULT_CLOUDS]
    assert dict(tcat._REGION_GEO) == dict(jcat._REGION_GEO)
    assert dict(tcat._GEO_RTT_MS) == dict(jcat._GEO_RTT_MS)
    assert dict(tcat._TABLE1) == dict(jcat._TABLE1)
    zones = list(jcat.DEFAULT_ZONES)
    regions = sorted({z.region for z in zones}) + ["asia-east1", "sa-east1"]
    for a in regions:
        assert tcat._geo_of(a) == jcat._geo_of(a)
        for b in regions:
            assert tcat.region_rtt_ms(a, b) == jcat.region_rtt_ms(a, b)
    tc, jc = tcat.default_catalog(), jcat.default_catalog()
    for a in zones:
        for b in zones:
            assert tc.bandwidth_gbps(a.name, b.name) == jc.bandwidth_gbps(
                a.name, b.name)
            assert tc.bandwidth_bytes_per_s(a.name, b.name) == \
                jc.bandwidth_bytes_per_s(a.name, b.name)
    assert tc.regions() == jc.regions()
    for cloud in ("aws", "gcp", "azure"):
        assert [z.name for z in tc.zones_in_cloud(cloud)] == [
            z.name for z in jc.zones_in_cloud(cloud)]
        assert tc.cloud(cloud) == tcat.CloudSpec(**dataclasses.asdict(
            jc.cloud(cloud)))
    got = tc.filter_zones(clouds=["aws"], regions=["us-west-2", "us-east-1"],
                          exclude_zones=["us-east-1c"])
    want = jc.filter_zones(clouds=["aws"], regions=["us-west-2", "us-east-1"],
                           exclude_zones=["us-east-1c"])
    assert [z.name for z in got] == [z.name for z in want]


@pytest.mark.parametrize("name", [t.name for t in jcat.DEFAULT_INSTANCE_TYPES])
def test_instance_type_is_the_references(name):
    """Every field the reference declares, the HBM rate included: the port
    gives it explicitly where the reference looks it up by accelerator."""
    want = next(t for t in jcat.DEFAULT_INSTANCE_TYPES if t.name == name)
    got = tcat.instance_type(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.spot_price == want.spot_price
    tc, jc = tcat.default_catalog(), jcat.default_catalog()
    for z in jcat.DEFAULT_ZONES:
        assert tc.spot_price(name, z.name) == jc.spot_price(name, z.name)
        assert tc.od_price(name, z.name) == jc.od_price(name, z.name)
    names = [z.name for z in jcat.DEFAULT_ZONES]
    for spot in (True, False):
        assert tc.cheapest_zone(name, names, spot=spot) == jc.cheapest_zone(
            name, names, spot=spot)


def test_port_instance_types_state_their_hbm_rate():
    assert [t.name for t in tcat.DEFAULT_INSTANCE_TYPES] == [
        t.name for t in jcat.DEFAULT_INSTANCE_TYPES]
    assert set(tcat.INSTANCE_TYPES) == {
        t.name for t in jcat.DEFAULT_INSTANCE_TYPES} | {"h100"}
    with pytest.raises(ValueError, match="hbm_bytes_per_s"):
        tcat.InstanceType("x", "aws", "A10G", 1, 1.0, 0.3)


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------


def _assert_same_trace(got, want):
    assert got.zones == want.zones
    assert got.cap.dtype == want.cap.dtype
    np.testing.assert_array_equal(got.cap, want.cap)
    assert (got.dt, got.name, got.preemption_warning_s) == (
        want.dt, want.name, want.preemption_warning_s)


@pytest.mark.parametrize("name", TRACES)
def test_named_trace_is_the_references(name):
    got, want = ttr.load_trace(name), jtr.load_trace(name)
    _assert_same_trace(got, want)
    assert ttr.trace_stats(got) == jtr.trace_stats(want)
    assert ttr.TraceLibrary().names() == jtr.TraceLibrary().names()
    np.testing.assert_array_equal(got.preemption_indicator(),
                                  want.preemption_indicator())
    np.testing.assert_array_equal(got.dense_ticks(30.0, 500, offset_s=120.0),
                                  want.dense_ticks(30.0, 500, offset_s=120.0))
    zones = list(want.zones[1:])
    _assert_same_trace(got.slice_zones(zones), want.slice_zones(zones))
    for z in want.zones:
        assert ttr.infer_region(z) == jtr.infer_region(z)


@pytest.mark.parametrize("seed", [0, 17, 2024])
def test_synthetic_trace_is_the_references(seed, tmp_path):
    zones = ["us-west-2a", "us-west-2b", "us-east-2a", "us-central1-a"]
    zmap = {z: jtr.infer_region(z) for z in zones}
    kw = dict(steps=3000, dt=60.0, max_capacity=5, seed=seed, name="syn",
              region_availability={"us-west-2": 0.7})
    got = ttr.synth_correlated_trace(zones, zmap, **kw)
    want = jtr.synth_correlated_trace(zones, zmap, **kw)
    _assert_same_trace(got, want)
    assert ttr.trace_stats(got) == jtr.trace_stats(want)
    np.testing.assert_array_equal(got.zone_correlation(),
                                  want.zone_correlation())
    # the interchange formats: the reference writes, the port reads
    want = dataclasses.replace(want, preemption_warning_s=45.0)
    want.save(str(tmp_path / "t.npz"))
    _assert_same_trace(ttr.SpotTrace.load(str(tmp_path / "t.npz")), want)
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"dt": want.dt, "zones": list(want.zones),
                                "cap": want.cap.tolist(), "name": "syn",
                                "preemption_warning_s": 45.0}))
    _assert_same_trace(ttr.load_trace(str(path)), jtr.load_trace(str(path)))


# ---------------------------------------------------------------------------
# policies on the cluster simulator
# ---------------------------------------------------------------------------


def test_policy_registry():
    assert t_registered() == sorted(POLICIES) == j_registered()
    for name in ("omniscient", "risk_spothedge"):
        assert type(t_make_policy(name)).__name__ == type(
            j_make_policy(name)).__name__
    with pytest.raises(KeyError) as got:
        t_make_policy("nope")
    with pytest.raises(KeyError) as want:
        j_make_policy("nope")
    assert str(got.value) == str(want.value)


def _assert_same_sim_result(got, want):
    for f in ("policy", "trace", "duration_s", "n_preemptions",
              "n_launch_failures", "n_spot_launches", "n_od_launches"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("availability", "total_cost", "spot_cost", "od_cost",
              "cost_vs_ondemand"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), abs=1e-12), f
    for f in ("t", "ready_spot", "ready_od", "n_target_series"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def _load_feed(now, sim):
    """Arrivals a tick, a pure function of time: the load swings between
    about 5 and 115 requests a minute every two hours."""
    sim.autoscaler.observe(now, int(30 + 28 * math.sin(now / 1146.0)))


def _load_sim(mod_sim, mod_auto, make_policy, trace, policy, sim_config):
    auto = mod_auto.LoadAutoscaler(0.5, min_replicas=1, max_replicas=6,
                                   initial_target=2, upscale_delay_s=120.0,
                                   downscale_delay_s=600.0)
    pol = make_policy(policy)
    if policy == "omniscient":
        # the oracle plans for the initial target, as run_policy_on_trace
        # plans for its constant one
        solve = importlib.import_module(
            make_policy.__module__.replace("policy", "omniscient")
        ).solve_omniscient
        cat = (tcat if make_policy is t_make_policy else jcat).default_catalog()
        k = (cat.od_price("p3.2xlarge", trace.zones[0])
             / cat.spot_price("p3.2xlarge", trace.zones[0]))
        pol.attach_schedule(solve(trace, n_target=2, cold_start_s=183.0,
                                  k_ratio=k))
    return mod_sim(trace, pol, autoscaler=auto,
                   config=sim_config(itype="p3.2xlarge", seed=5),
                   tick_hook=_load_feed)


@pytest.mark.parametrize("autoscaler", ["constant", "load"])
@pytest.mark.parametrize("trace", ["aws-1", "gcp-1"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_on_trace_is_the_references(policy, trace, autoscaler):
    """One day of the trace: counts and series exact, costs and
    availability to 1e-12."""
    dur = 24 * 3600.0
    if autoscaler == "constant":
        got = t_run_policy(policy, ttr.load_trace(trace), duration_s=dur,
                           seed=3)
        want = j_run_policy(policy, jtr.load_trace(trace), duration_s=dur,
                            seed=3)
    else:
        got = _load_sim(TClusterSimulator, tauto, t_make_policy,
                        ttr.load_trace(trace), policy, TSimConfig).run(dur)
        want = _load_sim(JClusterSimulator, jauto, j_make_policy,
                         jtr.load_trace(trace), policy, JSimConfig).run(dur)
        assert len(set(want.n_target_series.tolist())) > 2
    _assert_same_sim_result(got, want)
    assert want.n_spot_launches + want.n_od_launches > 0


# ---------------------------------------------------------------------------
# phase A and the oracle, regime by regime
# ---------------------------------------------------------------------------

CFG = j_config("llama3.2-1b")


def _mini_trace(mod, steps, seed):
    zones = ["us-west-2a", "us-west-2b", "us-east-2a"]
    zmap = {z: z[:-1] for z in zones}
    return mod.synth_correlated_trace(zones, zmap, steps=steps, dt=60.0,
                                      seed=seed, max_capacity=4, name="mini")


def _load_autoscaler(mod):
    return mod.LoadAutoscaler(0.8, min_replicas=1, max_replicas=6,
                              initial_target=2, upscale_delay_s=60.0,
                              downscale_delay_s=300.0)


# the regimes of tests/test_torch_scenario.py:REGIMES
REGIMES = [
    ("spothedge_poisson_ll", dict(policy="spothedge", workload="poisson")),
    ("even_spread_arena_rr", dict(policy="even_spread", workload="arena",
                                  rr=True)),
    ("aws_spot_maf_load_autoscaler",
     dict(policy="aws_spot", workload="maf", load=True)),
    ("saturated_queues_and_expiry",
     dict(policy="spothedge", workload="poisson", rate=6.0, concurrency=1,
          timeout_s=30.0, hours=0.5)),
    ("cross_region_rtt_timeout_boundary",
     dict(policy="spothedge", workload="poisson", rate=2.0, timeout_s=2.5,
          client_regions={"us-west-2": 0.5, "us-east-2": 0.3,
                          "eu-west-1": 0.2})),
]


def _engines(policy, workload, *, hours=1.0, seed=3, rate=0.8, load=False,
             rr=False, timeout_s=60.0, concurrency=2, client_regions=None,
             ref_cls=JaxServingEngine, port_cls=teng.TorchServingEngine):
    """(reference engine, port engine, duration) of one regime: the same
    trace, policy, autoscaler, balancer and tape (the reference's requests
    carried over as the port's)."""
    rate_key = "rate_per_s" if workload == "poisson" else "base_rate_per_s"
    wargs = {rate_key: rate, "seed": seed}
    if client_regions is not None:
        wargs["client_regions"] = client_regions
    reqs = j_make_workload(workload, **wargs).generate(hours * 3600.0)
    port_reqs = [Request(arrival_s=r.arrival_s, prompt_tokens=r.prompt_tokens,
                         output_tokens=r.output_tokens, id=r.id,
                         client_region=r.client_region) for r in reqs]
    steps = int(hours * 60) + 60
    common = dict(itype="g5.48xlarge", timeout_s=timeout_s,
                  concurrency=concurrency, workload_name=workload)
    ref = ref_cls(
        _mini_trace(jtr, steps, seed), j_make_policy(policy), reqs, CFG,
        autoscaler=_load_autoscaler(jauto) if load else jauto.ConstantTarget(3),
        **({"lb": RoundRobinBalancer()} if rr else {}), **common)
    # the reference's engine carries span timelines when its recorder
    # samples spans (its default recorder does); so does the port's
    port_kw = ({"obs": ObsRecorder(trace_sample=1.0)}
               if port_cls is teng.TorchServingEngine else {})
    port = port_cls(
        _mini_trace(ttr, steps, seed), t_make_policy(policy), port_reqs,
        t_config("llama3.2-1b"),
        autoscaler=_load_autoscaler(tauto) if load else tauto.ConstantTarget(3),
        lb="rr" if rr else "ll", **port_kw, **common)
    return ref, port, hours * 3600.0 + 600.0


def _assert_same_schedule(got, want):
    for f in ("arr", "svc", "rcode", "ready_mask", "rtt", "kill_slot",
              "kill_g", "post_slots"):
        a, b = getattr(got, f), getattr(want, f)
        np.testing.assert_array_equal(a, b, err_msg=f)
        assert a.shape == b.shape and a.dtype == b.dtype, f
    for f in ("policy_name", "trace_name", "workload_name", "n_regions",
              "timeout_s", "concurrency", "lb_kind", "n_slots", "trace_on"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("ts", "win_of", "win_first"):
        np.testing.assert_array_equal(getattr(got.grid, f),
                                      getattr(want.grid, f))
    assert got.grid.signature == want.grid.signature
    assert got.base == BaseMetrics(**{
        f.name: getattr(want.base, f.name)
        for f in dataclasses.fields(BaseMetrics)})


@pytest.mark.parametrize("args", [r[1] for r in REGIMES],
                         ids=[r[0] for r in REGIMES])
def test_phase_a_is_the_references(args):
    ref, port, dur = _engines(**args)
    want = ref.record_schedule(dur)
    got = port.record_schedule(dur)
    _assert_same_schedule(got, want)
    assert want.n_events > 0 and want.n_slots >= 3
    with pytest.raises(RuntimeError, match="once"):
        port.record_schedule(dur)


def _assert_equivalent(vector, port):
    """``tests/test_jax_engine.py``'s tolerances."""
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


@pytest.mark.parametrize("args", [r[1] for r in REGIMES],
                         ids=[r[0] for r in REGIMES])
def test_oracle_is_the_references(args):
    ref, port, dur = _engines(**args, ref_cls=JVector, port_cls=TVector)
    want = ref.run(dur)
    got = port.run(dur)
    _assert_equivalent(want, got)
    assert (got.policy, got.trace, got.workload) == (
        want.policy, want.trace, want.workload)
    assert want.n_completed > 0 and want.n_failed > 0


def test_oracle_refuses_what_it_does_not_model():
    """An unknown replica model or balancer name, migration without the
    token model, and a balancer subclass (the reference's TypeError: only
    the legacy simulator runs a custom ``pick()``)."""
    from repro_torch.migration import MigrationSpec
    from repro_torch.serving.load_balancer import LeastLoadedBalancer

    class Custom(LeastLoadedBalancer):
        pass

    trace = _mini_trace(ttr, 60, 0)
    cfg = t_config("llama3.2-1b")
    for kw, exc, msg in (
            ({"replica_model": "block"}, ValueError, "replica_model"),
            ({"migration": MigrationSpec(enabled=True)}, ValueError,
             "replica_model='token'"),
            ({"lb": "power_of_two"}, ValueError, "lb"),
            ({"lb": Custom()}, TypeError, "legacy ServingSimulator")):
        with pytest.raises(exc, match=msg):
            TVector(trace, t_make_policy("spothedge"), [], cfg,
                    itype="g5.48xlarge", **kw)


def test_overflowed_lane_reruns_on_the_oracle():
    """The MAF regime queues more than 256 requests on one slot: its lane
    overflows the default pool, and ``run_cells`` reruns it on the oracle
    from pristine state, so the result is the oracle's to the bit."""
    args = dict(REGIMES)["aws_spot_maf_load_autoscaler"]
    _, port, dur = _engines(**args)
    _, oracle, _ = _engines(**args, port_cls=TVector)
    outs = []
    got = teng.run_cells([port], [dur], device="cpu", outputs=outs)[0]
    assert port.fell_back and outs == [None]
    assert teng.run_schedules([port.schedule], device="cpu") == [None]
    want = oracle.run(dur)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        elif f.name == "obs":
            # the rerun's own recorder rides on its result: phase A's
            # events are not recorded twice
            assert a is not port.obs
            assert a.trace_sample == port.obs.trace_sample
            assert dumps_jsonl(a.records()) == dumps_jsonl(b.records())
        else:
            assert a == b, f.name


# ---------------------------------------------------------------------------
# the spec -> cells path
# ---------------------------------------------------------------------------


def test_spec_matrix_planes_are_the_recording():
    """The port's own phase A over all 96 cells of the reference benchmark's
    spec gives the recorded planes, field for field."""
    cells = recorded.spec_matrix()
    assert len(cells) == 96
    planes = recorded.recorded_planes()
    seen = set()
    for c in cells:
        sched = c.engine.record_schedule(c.duration_s)
        assert recorded.plane_of(sched) == planes[c.labels["policy"]]
        seen.add(c.labels["policy"])
    assert seen == set(planes) == {"spothedge", "even_spread"}


def test_quick_matrix_from_the_spec():
    """The 8-cell quick matrix, built from the spec and run through
    ``run_cells`` on the CPU: every cell equal to its recorded result."""
    cells = recorded.spec_matrix(4)
    want = recorded.recorded_cells(4)
    assert [(c.labels["policy"], c.labels["seed"]) for c in cells] == [
        (w["policy"], w["seed"]) for w in want]
    got = teng.run_cells([c.engine for c in cells],
                         [c.duration_s for c in cells], device="cpu")
    for res, cell, w in zip(got, cells, want):
        assert not cell.engine.fell_back
        r = w["result"]
        for k in ("n_requests", "n_completed", "n_failed",
                  "n_retried_requests", "n_preemptions", "n_launch_failures"):
            assert getattr(res, k) == r[k], k
        for k in ("total_cost", "spot_cost", "od_cost", "cost_vs_ondemand"):
            assert getattr(res, k) == pytest.approx(r[k], abs=1e-9), k
        assert res.availability == pytest.approx(r["availability"], abs=1e-12)
        for q in (50, 90, 99):
            assert res.pct(q) == pytest.approx(r[f"p{q}_s"], abs=1e-6)


def test_expand_sweep_is_the_references():
    """The grid's order, labels, cell names and tape keys are the
    reference ``ScenarioSuite``'s."""
    from repro.experiments.suite import ScenarioSuite as JScenarioSuite

    spec = bench_spec(3, 1.0)
    spec["sweep"]["traces"] = ["aws-1", "gcp-1"]
    want = JScenarioSuite.from_spec(spec).scenarios
    got = ScenarioSuite.from_spec(spec).scenarios
    assert [sc.labels for sc in got] == [sc.labels for sc in want]
    assert [sc.spec.name for sc in got] == [sc.spec.name for sc in want]
    assert [sc.spec.workload.seed for sc in got] == [sc.spec.workload.seed
                                                     for sc in want]
    assert [sc.tape_key for sc in got] == [sc.tape_key for sc in want]


def test_build_cell_slices_the_zones_the_catalog_knows():
    trace = ttr.SpotTrace(zones=("us-west-2a", "mars-1a", "us-west-2b"),
                          cap=np.full((120, 3), 2), dt=60.0, name="odd")
    # built directly: the loader checks the trace name against the library
    spec = tspec.ServiceSpec(trace="odd", sim=tspec.SimSpec(duration_hours=1.0,
                                                            engine="jax"))
    eng = build_service(spec, trace=trace).simulator
    assert isinstance(eng, teng.TorchServingEngine)
    assert eng.cluster.zone_names == ["us-west-2a", "us-west-2b"]
    assert eng.cluster.trace.zones == ("us-west-2a", "us-west-2b")


BAD_SPECS = [
    ("unknown top-level key", {"telemetry": {"source": "profile"}},
     "telemetry"),
    ("unknown sim key", {"sim": {"engines": "jax"}}, "engines"),
    ("arena workload", {"workload": {"kind": "arena",
                                     "args": {"diurnal_depth": 0.5}}},
     "diurnal_depth"),
    ("workload arg", {"workload": {"args": {"burst": 2}}}, "burst"),
    ("autoscaler kind", {"autoscaler": {"kind": "predictive"}}, "predictive"),
    ("balancer", {"load_balancer": "power_of_two"}, "power_of_two"),
    ("sweep forecaster", {"sweep": {"forecasters": ["oracle"]}},
     "unknown sweep forecaster 'oracle'"),
    ("oracle knob", {"replica_policy": {"name": "omniscient",
                                        "overprovision": 2}}, "knobs"),
    ("unknown policy", {"sweep": {"policies": ["nope"]}}, "nope"),
    ("policy knob", {"replica_policy": {"name": "even_spread",
                                        "overprovision": 2}}, "knobs"),
    ("resources filter", {"resources": {"any_of": [{"cloud": "gcp"}]}},
     "any_of"),
    ("negative timeout", {"sim": {"timeout_s": -1.0}}, "timeout_s"),
    ("unknown model", {"model": "gpt-9"}, "gpt-9"),
]


@pytest.mark.parametrize("extra,match", [b[1:] for b in BAD_SPECS],
                         ids=[b[0] for b in BAD_SPECS])
def test_unsupported_spec_raises(extra, match):
    spec = {**bench_spec(2, 1.0), **extra}
    if "sweep" not in extra:
        spec.pop("sweep")
    with pytest.raises(ValueError, match=match):
        for sc in ScenarioSuite.from_spec(spec).scenarios:
            build_service(sc.spec)


SECTIONS = [
    (tspec.SimSpec, jspec.SimSpec),
    (tspec.ObservabilitySpec, jspec.ObservabilitySpec),
    (tspec.AutoscalerSpec, jspec.AutoscalerSpec),
    (tspec.WorkloadSpec, jspec.WorkloadSpec),
    (tspec.ReplicaPolicySpec, jspec.ReplicaPolicySpec),
    (tspec.ResourceSpec, jspec.ResourceSpec),
    (tspec.ServiceSpec, jspec.ServiceSpec),
]


@pytest.mark.parametrize("port,ref", SECTIONS, ids=[s[0].__name__ for s in SECTIONS])
def test_builder_defaults_are_the_references(port, ref):
    """Every field the port reads defaults to the reference's value."""
    got, want = port(), ref()
    for f in dataclasses.fields(port):
        a = getattr(got, f.name)
        if dataclasses.is_dataclass(a):
            a = dataclasses.asdict(a)
            b = {k: v for k, v in dataclasses.asdict(getattr(want, f.name)).items()
                 if k in a}
        else:
            b = getattr(want, f.name)
        assert a == b, f.name
