"""The port's risk-aware SpotHedge, its Omniscient ILP oracle and the
suite's worker fan-out against the reference, on the CPU.

``repro_torch.core.risk_aware`` and ``repro_torch.core.omniscient`` are the
port's own copies of the reference's.  Each is held here against it on the
same inputs: the oracle's MILP (objective, sparse constraint matrix, row
bounds, variable bounds, integrality) array for array, and its solved
plans, availability indicator and objective, on two named traces and a
seeded mini trace; risk-aware SpotHedge's surge, trim and hedge decisions;
phase A planes of risk-aware and omniscient cells field for field, and
their data plane through ``run_cells(device="cpu")`` against both vector
engines (counts exact, cost 1e-9, availability 1e-12, latencies 1e-6);
the paper's Listing 1 (``examples/service.yaml``) through both packages'
``Service`` with its three observability artifacts byte for byte; the
suite's process fan-out, whose results must not depend on the worker
count; and the reference's forecast-risk suite at a cut horizon.
"""

import dataclasses
import json
import os
import pickle
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
scipy_optimize = pytest.importorskip("scipy.optimize")

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(TESTS, "..")
if TESTS not in sys.path:
    sys.path.insert(0, TESTS)

import repro.cluster.catalog as jcat  # noqa: E402
import repro.cluster.traces as jtr  # noqa: E402
import repro.core.omniscient as jomni  # noqa: E402
import repro.core.policy as jpol  # noqa: E402
import repro.forecast as jfc  # noqa: E402
from repro.experiments import Scenario as JScenario  # noqa: E402
from repro.experiments import ScenarioSuite as JSuite  # noqa: E402
from repro.service import Service as JService  # noqa: E402
from repro.service import SpecError as JSpecError  # noqa: E402
from repro.service import build_service as j_build_service  # noqa: E402
from repro.service import spec_from_dict as j_spec_from_dict  # noqa: E402
from test_torch_control import _assert_equivalent  # noqa: E402
from test_torch_control import _assert_same_schedule  # noqa: E402
from test_torch_control import _mini_trace  # noqa: E402

import repro_torch.cluster.catalog as tcat  # noqa: E402
import repro_torch.cluster.traces as ttr  # noqa: E402
import repro_torch.core.omniscient as tomni  # noqa: E402
import repro_torch.core.policy as tpol  # noqa: E402
import repro_torch.forecast as tfc  # noqa: E402
from repro_torch.experiments import Scenario as TScenario  # noqa: E402
from repro_torch.experiments import ScenarioSuite as TSuite  # noqa: E402
from repro_torch.experiments.report import CellResult  # noqa: E402
from repro_torch.serving.torchengine import engine as teng  # noqa: E402
from repro_torch.service import Service as TService  # noqa: E402
from repro_torch.service import SpecError  # noqa: E402
from repro_torch.service import build_service as t_build_service  # noqa: E402
from repro_torch.service import spec_from_dict as t_spec_from_dict  # noqa: E402

# the cell fields a suite report compares (labels and wall clock aside)
CELL_FIELDS = [f.name for f in dataclasses.fields(CellResult)
               if f.name not in ("labels", "wall_s")]


def _assert_same_cells(got, want, skip=()):
    """Two lists of CellResults: labels and every field but ``skip`` equal
    (counts exact; floats within 1e-9; NaNs equal)."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.labels == b.labels
        for k in CELL_FIELDS:
            if k in skip:
                continue
            x, y = getattr(a, k, None), getattr(b, k, None)
            if isinstance(y, float):
                assert x == pytest.approx(y, abs=1e-9, nan_ok=True), (
                    a.cell_id, k)
            else:
                assert x == y, (a.cell_id, k)


# ---------------------------------------------------------------------------
# the Omniscient oracle's MILP
# ---------------------------------------------------------------------------


def _capture_milp(monkeypatch):
    """Record every ``scipy.optimize.milp`` call (both packages call it
    through the module attribute) and pass it on."""
    calls = []
    real = scipy_optimize.milp

    def spy(c, **kw):
        calls.append((np.array(c, copy=True), kw))
        return real(c, **kw)

    monkeypatch.setattr(scipy_optimize, "milp", spy)
    return calls


def _trace(pkg_tr, name):
    if name == "mini":
        return _mini_trace(pkg_tr, 720, 5)
    return pkg_tr.load_trace(name)


@pytest.mark.parametrize("itype,n_target", [("p3.2xlarge", 4),
                                            ("g5.48xlarge", 3)])
@pytest.mark.parametrize("trace", ["aws-1", "gcp-1", "mini"])
def test_omniscient_milp_and_plan_are_the_references(trace, itype, n_target,
                                                     monkeypatch):
    calls = _capture_milp(monkeypatch)
    got_tr, want_tr = _trace(ttr, trace), _trace(jtr, trace)
    k = []
    for cat, tr in ((tcat.default_catalog(), got_tr),
                    (jcat.default_catalog(), want_tr)):
        k.append(cat.od_price(itype, tr.zones[0])
                 / cat.spot_price(itype, tr.zones[0]))
    assert k[0] == k[1]
    got = tomni.solve_omniscient(got_tr, n_target=n_target,
                                 cold_start_s=183.0, k_ratio=k[0])
    want = jomni.solve_omniscient(want_tr, n_target=n_target,
                                  cold_start_s=183.0, k_ratio=k[1])
    (c_t, kw_t), (c_j, kw_j) = calls
    np.testing.assert_array_equal(c_t, c_j)
    a_t, a_j = kw_t["constraints"], kw_j["constraints"]
    assert a_t.A.shape == a_j.A.shape
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a_t.A, f), getattr(a_j.A, f))
    np.testing.assert_array_equal(a_t.lb, a_j.lb)
    np.testing.assert_array_equal(a_t.ub, a_j.ub)
    np.testing.assert_array_equal(kw_t["bounds"].lb, kw_j["bounds"].lb)
    np.testing.assert_array_equal(kw_t["bounds"].ub, kw_j["bounds"].ub)
    np.testing.assert_array_equal(kw_t["integrality"], kw_j["integrality"])
    assert kw_t["options"] == kw_j["options"]
    # the same matrix on the same scipy: the same optimum
    assert got.status == want.status and "Optimal" in got.status
    assert got.objective == want.objective
    assert (got.zones, got.bucket_s) == (want.zones, want.bucket_s)
    for f in ("spot_plan", "od_plan", "availability_ind"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype
    assert got.availability_ind.mean() >= 0.9
    for t in np.linspace(0.0, got_tr.duration_s * 1.1, 37):
        assert got.spot_at(t) == want.spot_at(t)
        assert got.od_at(t) == want.od_at(t)


def test_omniscient_refusals_are_the_references():
    short_t = ttr.SpotTrace(zones=("us-west-2a",), cap=np.ones((3, 1), int),
                            dt=60.0, name="s")
    short_j = jtr.SpotTrace(zones=("us-west-2a",), cap=np.ones((3, 1), int),
                            dt=60.0, name="s")
    kw = dict(n_target=2, cold_start_s=183.0, k_ratio=3.0)
    for call in (lambda m, tr: m.solve_omniscient(tr, **kw),
                 lambda m, tr: m.OmniscientPolicy().decide(None)):
        with pytest.raises(Exception) as got:
            call(tomni, short_t)
        with pytest.raises(Exception) as want:
            call(jomni, short_j)
        assert (type(got.value).__name__, str(got.value)) == (
            type(want.value).__name__, str(want.value))


# ---------------------------------------------------------------------------
# risk-aware SpotHedge's decisions (the reference's cases, both packages)
# ---------------------------------------------------------------------------

ZONES = ["us-west-2a", "us-west-2b", "us-west-2c"]


class _Inst:
    def __init__(self, zone, iid=1):
        self.zone, self.id, self.launched_at = zone, iid, 0.0


def _risk_policy(pkg, **kw):
    pol = pkg["policy"].make_policy("risk_spothedge", **kw)
    cat = pkg["catalog"].default_catalog()
    pol.reset([cat.zone(z) for z in ZONES], cat, "p3.2xlarge")
    return pol


def _forecast(pkg, risks):
    zf = pkg["forecast"].ZoneForecast
    return {z: zf(zone=z, p_available=1.0 - r, p_preempt=r)
            for z, r in zip(ZONES, risks)}


def _obs(pkg, ready, n_target=4):
    return pkg["policy"].Observation(now=0.0, n_target=n_target,
                                     spot_ready=ready, spot_provisioning=[],
                                     od_ready=[], od_provisioning=[])


def _surge_trim_base(pkg):
    pol = _risk_policy(pkg, num_overprovision=2, surge_overprovision=2,
                       min_overprovision=1)
    obs = _obs(pkg, [_Inst(ZONES[0])])
    out = []
    for risks in ((0.9,) * 3, (0.01,) * 3, (0.3,) * 3):
        pol._forecast = _forecast(pkg, risks)
        out.append(pol._spot_goal(obs))
    return out


def _surge_is_spot_only(pkg):
    pol = _risk_policy(pkg, num_overprovision=2, surge_overprovision=1)
    obs = _obs(pkg, [_Inst(ZONES[k % 3], k) for k in range(6)])
    pol._feed_forecaster(obs)
    pol._forecast = _forecast(pkg, (0.9, 0.01, 0.01))
    actions = super(type(pol), pol).decide(obs)
    return [(type(a).__name__, getattr(a, "zone", None)) for a in actions]


def _surge_avoids_collapse(pkg):
    pol = _risk_policy(pkg)
    counts = {ZONES[0]: 1, ZONES[1]: 2, ZONES[2]: 3}
    pol._forecast = _forecast(pkg, (0.9, 0.01, 0.01))
    safe = pol._select_next_zone(counts, 0.0)
    pol._forecast = _forecast(pkg, (0.9,) * 3)
    return [safe, pol._select_next_zone(counts, 0.0)]


def _hedges_on_collapse(pkg):
    pol = _risk_policy(pkg, num_overprovision=2)
    pol._forecast = _forecast(pkg, (0.95, 0.95, 0.01))
    wide = [_Inst(ZONES[0], 1), _Inst(ZONES[1], 2)] + [
        _Inst(ZONES[2], 3 + k) for k in range(4)]
    thin = [_Inst(ZONES[0], 1), _Inst(ZONES[1], 2), _Inst(ZONES[2], 3),
            _Inst(ZONES[2], 4)]
    return [pol._at_risk_ready(_obs(pkg, wide)),
            pol._at_risk_ready(_obs(pkg, thin))]


def _zero_overprovision(pkg):
    return [_risk_policy(pkg, num_overprovision=0).min_overprovision]


def _bad_knobs(pkg):
    out = []
    for kw in ({"horizon_s": 0}, {"risk_threshold": 2.0},
               {"calm_threshold": -1.0}, {"min_overprovision": 5},
               {"surge_overprovision": -1}, {"obs_interval_s": 0.0},
               {"forecaster": pkg["forecast"].PersistenceForecaster(),
                "forecaster_args": {"prior": 0.4}}):
        try:
            pkg["policy"].make_policy("risk_spothedge", **kw)
        except ValueError as e:
            out.append(str(e))
    return out


def _full_decide(pkg):
    """Ten ticks of ``decide`` with events between them: actions, the live
    forecast and the Z_A / Z_P lists after each."""
    pol = _risk_policy(pkg, forecaster="ewma")
    ev = pkg["policy"]
    out = []
    for tick in range(10):
        now = 30.0 * tick
        ready = [_Inst(ZONES[(tick + k) % 3], k) for k in range(tick % 5)]
        if tick in (3, 4):
            pol.on_event(ev.ControllerEvent(ev.EventKind.PREEMPTION,
                                            ZONES[0], now, 1))
        if tick == 6:
            pol.on_event(ev.ControllerEvent(ev.EventKind.READY, ZONES[0],
                                            now, 2))
        acts = pol.decide(pkg["policy"].Observation(
            now=now, n_target=4, spot_ready=ready, spot_provisioning=[],
            od_ready=[], od_provisioning=[]))
        out.append(([repr(a) for a in acts],
                    {z: (f.p_available, f.p_preempt)
                     for z, f in pol.current_forecast.items()},
                    pol.available_zones, pol.preempting_zones,
                    pol.take_reasons()))
    return out


PORT = {"policy": tpol, "catalog": tcat, "forecast": tfc}
REF = {"policy": jpol, "catalog": jcat, "forecast": jfc}
RISK_CASES = [
    ("surge trim base", _surge_trim_base, [4 + 2 + 2, 4 + 1, 4 + 2]),
    ("surge is spot only", _surge_is_spot_only, None),
    ("surge avoids collapse", _surge_avoids_collapse, ZONES[1:2] + ZONES[:1]),
    ("hedges on collapse", _hedges_on_collapse, [0, 2]),
    ("zero overprovision", _zero_overprovision, [0]),
    ("bad knobs", _bad_knobs, None),
    ("full decide", _full_decide, None),
]


@pytest.mark.parametrize("case,expected", [c[1:] for c in RISK_CASES],
                         ids=[c[0] for c in RISK_CASES])
def test_risk_spothedge_decides_as_the_reference(case, expected):
    got, want = case(PORT), case(REF)
    assert got == want
    if expected is not None:
        assert got == expected
    if case is _surge_is_spot_only:
        # one surge replica, in a forecast-safe zone, and no on-demand
        assert len(got) == 1 and got[0][0] == "LaunchSpot"
        assert got[0][1] != ZONES[0]
    if case is _bad_knobs:
        assert len(got) == 7


# ---------------------------------------------------------------------------
# risk-aware and omniscient cells: phase A, run_cells and both oracles
# ---------------------------------------------------------------------------


def _request_cell(policy, forecaster=None, hours=1.0):
    d = {
        "name": f"cell-{policy}", "model": "command-r-35b", "trace": "aws-3",
        "resources": {"instance_type": "g5.48xlarge",
                      "any_of": [{"region": "us-east-1"},
                                 {"region": "us-east-2"},
                                 {"region": "us-west-2"}]},
        "replica_policy": {"name": policy},
        "autoscaler": {"kind": "load", "target": 4, "qps_per_replica": 0.8,
                       "min_replicas": 2, "max_replicas": 12,
                       "upscale_delay_s": 60, "downscale_delay_s": 600},
        "workload": {"kind": "arena", "rate_per_s": 2.0, "seed": 11},
        "sim": {"duration_hours": hours, "control_interval_s": 15,
                "timeout_s": 100, "concurrency": 4},
    }
    if forecaster is not None:
        d["forecast"] = {"name": forecaster, "horizon_s": 450,
                         "risk_threshold": 0.6, "calm_threshold": 0.06}
    return d


CELLS = [("risk_spothedge", "markov"), ("risk_spothedge", "ewma"),
         ("risk_spothedge", "persistence"), ("omniscient", None)]


@pytest.mark.parametrize("policy,forecaster", CELLS,
                         ids=[f"{p}-{f}" for p, f in CELLS])
def test_cell_phase_a_and_data_plane_are_the_references(policy, forecaster):
    d = _request_cell(policy, forecaster)
    jax_d = dict(d, sim=dict(d["sim"], engine="jax"))
    want_eng = j_build_service(j_spec_from_dict(jax_d)).simulator
    got_eng = t_build_service(t_spec_from_dict(jax_d)).simulator
    dur = 3600.0
    want = want_eng.record_schedule(dur)
    got = got_eng.record_schedule(dur)
    _assert_same_schedule(got, want)
    assert want.n_slots >= 4
    card = teng.run_cells([got_eng], [dur], device="cpu")[0]
    assert not got_eng.fell_back
    vec = dict(d, sim=dict(d["sim"], engine="vector"))
    ref_vec = j_build_service(j_spec_from_dict(vec)).simulator.run(dur)
    port_vec = t_build_service(t_spec_from_dict(vec)).simulator.run(dur)
    _assert_equivalent(ref_vec, card)
    _assert_equivalent(port_vec, card)
    assert card.n_completed > 0


# ---------------------------------------------------------------------------
# Listing 1, whole
# ---------------------------------------------------------------------------


def _listing1():
    """``examples/service.yaml`` as a dict: read with PyYAML where it is
    present, else a JSON copy of it (the file's own values)."""
    try:
        import yaml
    except ImportError:
        return LISTING1_JSON
    with open(os.path.join(ROOT, "examples", "service.yaml")) as f:
        d = yaml.safe_load(f)["service"]
    assert d == LISTING1_JSON
    return d


LISTING1_JSON = json.loads("""{
 "name": "chatbot", "model": "command-r-35b", "trace": "aws-3",
 "resources": {"instance_type": "g5.48xlarge",
               "any_of": [{"region": "us-east-1"}, {"region": "us-east-2"},
                          {"region": "us-west-2"}]},
 "replica_policy": {"name": "risk_spothedge", "overprovision": 2,
                    "dynamic_fallback": true},
 "forecast": {"name": "markov", "horizon_s": 450, "risk_threshold": 0.6,
              "calm_threshold": 0.06},
 "autoscaler": {"kind": "load", "target": 4, "qps_per_replica": 0.8,
                "min_replicas": 2, "max_replicas": 12,
                "upscale_delay_s": 60, "downscale_delay_s": 600},
 "workload": {"kind": "arena", "rate_per_s": 2.0, "seed": 11,
              "args": {"client_regions": {"us-west-2": 0.5,
                                          "us-east-1": 0.3,
                                          "eu-central-1": 0.2}}},
 "latency": {"source": "roofline"},
 "serving": {"replica_model": "token",
             "slo": {"ttft_s": 10.0, "tpot_s": 0.2},
             "prefill_chunk_tokens": 512},
 "migration": {"enabled": true, "compression": "int8",
               "drain_threshold_s": 2.0},
 "observability": {"detail": "full", "out_dir": "artifacts/obs",
                   "trace_sample": 0.01,
                   "slo_burn": {"target": 0.99, "fast_window_s": 300.0,
                                "slow_window_s": 3600.0,
                                "fast_threshold": 14.4,
                                "slow_threshold": 6.0}},
 "sim": {"duration_hours": 2.0, "control_interval_s": 15, "timeout_s": 100,
         "concurrency": 4}
}""")


def test_listing1_runs_as_the_references_service(tmp_path):
    d = _listing1()
    got_d = dict(d, observability=dict(d["observability"],
                                       out_dir=str(tmp_path / "t")))
    want_d = dict(d, observability=dict(d["observability"],
                                        out_dir=str(tmp_path / "j")))
    svc = TService(got_d, engine="vector")
    ref = JService(want_d)
    assert svc.spec.to_dict() == dict(ref.spec.to_dict(),
                                      observability=svc.spec.to_dict()[
                                          "observability"])
    got, want = svc.run(), ref.run()
    resolved = svc.resolve()
    assert type(resolved.policy).__name__ == "RiskAwareSpotHedgePolicy"
    assert resolved.policy.forecaster.name == "markov"
    assert resolved.policy.horizon_s == 450.0
    _assert_equivalent(want, got)
    for k in ("ttft_s", "tpot_s"):
        np.testing.assert_allclose(getattr(got.token, k),
                                   getattr(want.token, k), atol=1e-6, rtol=0)
    assert got.token.goodput_rps == pytest.approx(want.token.goodput_rps,
                                                  abs=1e-9)
    for k in ("n_drained_seqs", "n_migrated_seqs", "migrated_kv_tokens",
              "saved_prefill_tokens"):
        assert getattr(got.token, k) == getattr(want.token, k), k
    assert got.lost_kv_tokens == want.lost_kv_tokens
    assert got.token.n_drained_seqs + got.n_retried_requests > 0
    assert set(svc.artifacts) == set(ref.artifacts) == {"events", "spans",
                                                        "trace"}
    for kind in svc.artifacts:
        with open(svc.artifacts[kind], "rb") as a, \
                open(ref.artifacts[kind], "rb") as b:
            assert a.read() == b.read(), kind


def test_listing1_request_model_on_the_card_engine(tmp_path):
    """Listing 1 on the request model, no migration, cut to 1 h: phase B
    through the plain ``scenario_scan`` equals the reference's vector
    engine."""
    d = {k: v for k, v in _listing1().items()
         if k not in ("migration", "observability")}
    d["serving"] = dict(d["serving"], replica_model="request")
    d["sim"] = dict(d["sim"], duration_hours=1.0)
    got = TService(d).run(device="cpu")
    want = JService(d).run()
    _assert_equivalent(want, got)


# ---------------------------------------------------------------------------
# the worker fan-out
# ---------------------------------------------------------------------------


def _sweep_dict(hours=1.0):
    d = _request_cell("risk_spothedge", "markov", hours)
    d["trace"] = "gcp-1"
    d.pop("resources")
    d["resources"] = {"instance_type": "g5.48xlarge"}
    d["observability"] = {"detail": "decisions"}
    d["sweep"] = {"policies": ["spothedge", "risk_spothedge", "omniscient"],
                  "forecasters": ["ewma", "markov"]}
    return d


def test_fan_out_results_do_not_depend_on_the_worker_count():
    suite = TSuite.from_spec(_sweep_dict())
    assert len(suite) == 4
    serial = suite.run(engine="vector")
    assert serial.workers == 1
    for workers, n in ((2, 2), ("auto", os.cpu_count() or 1)):
        report = suite.run(engine="vector", workers=workers)
        assert report.workers == n
        _assert_same_cells(report.cells, serial.cells)
        assert report.metrics == serial.metrics
    # the reference's own serial run, cell for cell
    want = JSuite.from_spec(_sweep_dict()).run(engine="vector")
    _assert_same_cells(serial.cells, want.cells)
    # a cell travels between processes whole
    for c in serial.cells:
        assert pickle.loads(pickle.dumps(c)) == c
    # under jax the batch is the parallelism: workers is ignored
    jax = suite.run(engine="jax", workers=2, device="cpu")
    assert jax.workers == 1
    # (a span rebuilt from phase B shows a retried request's last attempt
    # only, so the span counts may differ from the host engine's)
    _assert_same_cells(jax.cells, serial.cells, skip=("n_spans",))


@pytest.mark.parametrize("workers", [0, -3, "many", 2.5j, [2]],
                         ids=["zero", "negative", "word", "complex", "list"])
def test_bad_worker_counts_are_the_references_errors(workers):
    suite = TSuite.from_spec(_sweep_dict())
    ref = JSuite.from_spec(_sweep_dict())
    with pytest.raises(SpecError) as got:
        suite.run(engine="vector", workers=workers)
    with pytest.raises(JSpecError) as want:
        ref.run(engine="vector", workers=workers)
    assert str(got.value) == str(want.value)


def test_lost_future_is_a_loud_failure(monkeypatch):
    """A cell whose future never returns fails the run; the report is
    never shorter than the suite."""
    import concurrent.futures as cf

    suite = TSuite.from_spec(_sweep_dict())
    real = cf.as_completed

    def drop_one(futures, *a, **kw):
        done = list(real(futures, *a, **kw))
        return done[1:]

    monkeypatch.setattr(cf, "as_completed", drop_one)
    with pytest.raises(RuntimeError, match="1 of 4 cells never returned"):
        suite.run(engine="vector", workers=2)


# ---------------------------------------------------------------------------
# the reference's forecast-risk suite, at a cut horizon
# ---------------------------------------------------------------------------


def _forecast_risk_suite(scenario, suite, spec_from_dict, load_trace,
                         hours_cap):
    """``benchmarks/forecast_eval.py``'s ``build_serving_suite``, its
    horizon capped at ``hours_cap``."""
    scenarios = []
    for tname in ("aws-1", "aws-2", "aws-3", "gcp-1"):
        hours = min(load_trace(tname).duration_s / 3600.0, 7 * 24.0,
                    hours_cap)
        for policy in ("spothedge", "risk_spothedge"):
            spec = spec_from_dict({
                "name": f"forecast-risk-{policy}-{tname}",
                "model": "llama3.2-1b", "trace": tname,
                "resources": {"instance_type": "p3.2xlarge"},
                "replica_policy": {"name": policy},
                "autoscaler": {"kind": "constant", "target": 4},
                "workload": {"kind": "none"},
                "forecast": {"name": "markov"},
                "sim": {"duration_hours": hours, "control_interval_s": 30.0,
                        "drain_s": 0.0, "seed": 0},
            })
            scenarios.append(scenario(labels={"policy": policy,
                                              "trace": tname}, spec=spec))
    return suite(scenarios, name="forecast_risk")


def test_forecast_risk_suite_is_the_references():
    got = _forecast_risk_suite(TScenario, TSuite, t_spec_from_dict,
                               ttr.load_trace, 18.0)
    want = _forecast_risk_suite(JScenario, JSuite, j_spec_from_dict,
                                jtr.load_trace, 18.0)
    serial = got.run(engine="vector")
    ref = want.run(engine="vector")
    _assert_same_cells(serial.cells, ref.cells)
    fanned = got.run(engine="vector", workers=2)
    _assert_same_cells(fanned.cells, serial.cells)
    # risk-aware placement is in the loop: it moves at least one metric
    by = {tuple(c.labels.values()): c for c in serial.cells}
    assert any(
        (by[("spothedge", t)].total_cost, by[("spothedge", t)].n_preemptions)
        != (by[("risk_spothedge", t)].total_cost,
            by[("risk_spothedge", t)].n_preemptions)
        for t in ("aws-1", "aws-2", "aws-3", "gcp-1"))
