"""The port's front door against the reference's: the Arena and MAF
workloads, the profiled latency model, the service spec and its loaders,
``resolve_zones``, ``Service``, ``ScenarioSuite`` and the serve CLI.

Each test gives ``repro`` and ``repro_torch`` the same inputs (seeds, spec
dicts, profile tables written here) and compares what comes out.  The
two-phase engine (``sim.engine: jax``) runs on the CPU through the plain
version of ``scenario_scan``.

PyYAML is optional, as it is to both loaders: the tests that read or
write YAML (``examples/sweep.yaml``'s grid among them) skip without it.

Tolerance: counts exact; costs, availability and latencies to 1e-9; the
golden constants of ``tests/test_golden.py`` to that file's own 1e-6.
"""

import dataclasses
import json
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.cluster.traces as jtr  # noqa: E402
from repro.cluster.catalog import InstanceType as JInstanceType  # noqa: E402
from repro.cluster.catalog import default_catalog as j_catalog  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.experiments import ScenarioSuite as JSuite  # noqa: E402
from repro.serving import latency as jlat  # noqa: E402
from repro.service import Service as JService  # noqa: E402
from repro.service import resolve_zones as j_resolve_zones  # noqa: E402
from repro.service import spec as jspec  # noqa: E402
from repro.service import spec_from_dict as j_spec_from_dict  # noqa: E402
from repro.workloads import arrivals as jarr  # noqa: E402
from test_golden import GOLDEN  # noqa: E402

import repro_torch.cluster.traces as ttr  # noqa: E402
from repro_torch.cluster.catalog import H100, default_catalog as t_catalog  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.experiments import ScenarioSuite as TSuite  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.profiles.schema import ProfileEntry, ProfileTable  # noqa: E402
from repro_torch.serving import latency as tlat  # noqa: E402
from repro_torch.service import Service as TService  # noqa: E402
from repro_torch.service import (  # noqa: E402
    SpecError,
    load_spec,
    resolve_zones,
    spec_from_dict,
    spec_from_json,
    spec_from_yaml,
)
from repro_torch.workloads import arrivals as tarr  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
COUNTS = ("n_requests", "n_completed", "n_failed", "n_retried_requests",
          "n_preemptions", "n_launch_failures")
FLOATS = ("total_cost", "spot_cost", "od_cost", "cost_vs_ondemand",
          "availability")
TOL = 1e-9


def _assert_same_result(got, want):
    for k in COUNTS:
        assert getattr(got, k) == getattr(want, k), k
    for k in FLOATS:
        assert getattr(got, k) == pytest.approx(getattr(want, k), abs=TOL), k
    assert (got.policy, got.trace, got.workload) == (want.policy, want.trace,
                                                      want.workload)
    a, b = np.sort(got.latencies_s), np.sort(want.latencies_s)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# workloads
# ---------------------------------------------------------------------------

REGIONS = {"us-west-2": 0.5, "us-east-1": 0.3, "eu-central-1": 0.2}
TAPES = [
    ("arena", dict(base_rate_per_s=0.3, seed=0), 4 * 3600.0),
    ("arena", dict(base_rate_per_s=2.0, seed=11, client_regions=REGIONS),
     4 * 3600.0),
    ("arena", dict(base_rate_per_s=0.6, seed=5, spike_prob=0.05,
                   spike_mult=6.0), 3600.0),
    ("maf", dict(base_rate_per_s=0.25, seed=0), 6 * 3600.0),
    ("maf", dict(base_rate_per_s=1.5, seed=7,
                 client_regions=["us-west-2", "us-east-2"]), 2 * 3600.0),
    ("maf", dict(base_rate_per_s=0.6, seed=3, diurnal_depth=0.3,
                 spike_prob_per_min=0.05), 26 * 3600.0),
    ("poisson", dict(rate_per_s=0.8, seed=2, client_regions=REGIONS), 3600.0),
]


@pytest.mark.parametrize("kind,kw,dur", TAPES,
                         ids=[f"{t[0]}-{i}" for i, t in enumerate(TAPES)])
def test_tape_is_the_references(kind, kw, dur):
    want = jarr.make_workload(kind, **kw).generate(dur)
    got = tarr.make_workload(kind, **kw).generate(dur)
    assert len(want) > 10
    for f in ("arrival_s", "prompt_tokens", "output_tokens", "client_region"):
        assert [getattr(r, f) for r in got] == [getattr(r, f) for r in want], f
    assert tarr.interarrival_stats(got) == jarr.interarrival_stats(want)


def test_interarrival_stats_short_tapes():
    for n in (0, 1):
        reqs = tarr.make_workload("poisson", rate_per_s=1.0).generate(3600.0)[:n]
        assert tarr.interarrival_stats(reqs) == {"n": n}
    with pytest.raises(KeyError, match="trace_replay"):
        tarr.make_workload("trace_replay")


# ---------------------------------------------------------------------------
# latency models
# ---------------------------------------------------------------------------

LATENCY_FIELDS = ("n_params", "mfu_prefill", "mbu_decode", "overhead_s")
SHAPES = [(1, 1), (200, 150), (2048, 2048), (37, 900)]


def _assert_same_latency(got, want):
    assert type(got).__name__ == type(want).__name__
    for f in LATENCY_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    for p, o in SHAPES:
        assert got.service_s(p, o) == want.service_s(p, o)
    assert got.max_concurrency() == want.max_concurrency()


def _itypes(name):
    """The reference's and the port's instance type called ``name`` (the
    H100 is the port's; the reference gets it from the port's figures)."""
    if name == "h100":
        return JInstanceType(**dataclasses.asdict(H100)), H100
    return j_catalog().instance_type(name), t_catalog().instance_type(name)


@pytest.mark.parametrize("model,itype", [
    ("llama3.2-1b", "h100"), ("command-r-35b", "g5.48xlarge"),
    ("qwen3-moe-30b", "h100"), ("falcon-mamba-7b", "g5.48xlarge")])
def test_roofline_model_is_the_references(model, itype):
    ji, ti = _itypes(itype)
    want = jlat.make_latency_model(j_config(model), ji, model_id=model)
    got = tlat.make_latency_model(t_config(model), ti, model_id=model)
    _assert_same_latency(got, want)
    assert tlat.LATENCY_SOURCES == jlat.LATENCY_SOURCES


def _write_table(path, model="llama3.2-1b", accel="H100"):
    table = ProfileTable(backend="cuda", mode="compiled")
    table.add(ProfileEntry(
        model=model, accelerator=accel, backend="cuda", mode="compiled",
        prefill_tokens=256, prefill_flops=2.684e8, prefill_wall_s=5.53e-5,
        decode_cache_tokens=512, decode_steps=8, decode_bytes=1.049e6,
        decode_wall_s=5.05e-5, mfu_prefill=0.00491135,
        mbu_decode=0.00619866))
    table.save(str(path))
    return str(path)


def test_profiled_model_is_the_references(tmp_path):
    path = _write_table(tmp_path / "t.json")
    ji, ti = _itypes("h100")
    want = jlat.make_latency_model(j_config("llama3.2-1b"), ji,
                                   model_id="llama3.2-1b", source="profile",
                                   profile=path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = tlat.make_latency_model(t_config("llama3.2-1b"), ti,
                                      model_id="llama3.2-1b",
                                      source="profile", profile=path)
    assert isinstance(got, tlat.ProfiledLatencyModel)
    _assert_same_latency(got, want)
    for f in ("profile_path", "profile_backend", "profile_mode"):
        assert getattr(got, f) == getattr(want, f), f
    assert (got.profile_path, got.profile_backend, got.profile_mode) == (
        path, "cuda", "compiled")
    # a directory of tables is searched too
    got_dir = tlat.make_latency_model(t_config("llama3.2-1b"), ti,
                                      model_id="llama3.2-1b",
                                      source="profile", profile=str(tmp_path))
    assert (got_dir.mfu_prefill, got_dir.mbu_decode) == (0.00491135,
                                                         0.00619866)


@pytest.mark.parametrize("where", ["other row", "no file"])
def test_missing_profile_row_warns_and_prices_the_roofline(tmp_path, where):
    path = (_write_table(tmp_path / "t.json", model="qwen2.5-3b")
            if where == "other row" else str(tmp_path / "absent.json"))
    ji, ti = _itypes("h100")
    with pytest.warns(UserWarning, match="falling back"):
        want = jlat.make_latency_model(j_config("llama3.2-1b"), ji,
                                       model_id="llama3.2-1b",
                                       source="profile", profile=path)
    with pytest.warns(UserWarning, match="falling back to the analytic"):
        got = tlat.make_latency_model(t_config("llama3.2-1b"), ti,
                                      model_id="llama3.2-1b",
                                      source="profile", profile=path)
    assert type(got) is tlat.LatencyModel
    _assert_same_latency(got, want)
    with pytest.raises(ValueError, match="latency source"):
        tlat.make_latency_model(t_config("llama3.2-1b"), ti,
                                model_id="llama3.2-1b", source="measured")


# ---------------------------------------------------------------------------
# the spec, to_dict and the loaders
# ---------------------------------------------------------------------------


def golden_dict(policy):
    """``tests/test_golden.py``'s spec: aws-1 at 2 h, Poisson 0.5/s seed 17,
    constant N_Tar=3, g5.48xlarge, concurrency 2, timeout 60 s."""
    return {
        "name": f"golden-{policy}",
        "model": "llama3.2-1b",
        "trace": "aws-1",
        "resources": {"instance_type": "g5.48xlarge"},
        "replica_policy": {"name": policy},
        "autoscaler": {"kind": "constant", "target": 3},
        "workload": {"kind": "poisson", "rate_per_s": 0.5, "seed": 17},
        "sim": {"duration_hours": 2.0, "timeout_s": 60.0,
                "concurrency": 2, "drain_s": 300.0, "seed": 0},
    }


def quickstart_dict(hours=4.0):
    """The README's quickstart service."""
    return {
        "service": {
            "name": "chatbot",
            "model": "command-r-35b",
            "trace": "aws-3",
            "resources": {"instance_type": "g5.48xlarge",
                          "any_of": [{"region": "us-east-1"},
                                     {"region": "us-east-2"},
                                     {"region": "us-west-2"}]},
            "replica_policy": {"name": "spothedge", "overprovision": 2,
                               "dynamic_fallback": True},
            "autoscaler": {"kind": "load", "target": 4,
                           "qps_per_replica": 0.8},
            "workload": {"kind": "arena", "rate_per_s": 2.0},
            "sim": {"duration_hours": hours},
        }
    }


def sweep_dict(workloads=("poisson", "arena", "maf")):
    """``examples/sweep.yaml``'s grid, with a workloads axis."""
    yaml = pytest.importorskip("yaml")

    with open(os.path.join(ROOT, "examples", "sweep.yaml")) as f:
        d = yaml.safe_load(f)
    if workloads:
        d["service"]["sweep"]["workloads"] = list(workloads)
    return d


FULL = {
    "name": "svc", "model": "command-r-35b", "trace": "aws-3",
    "resources": {"instance_type": "g5.48xlarge",
                  "any_of": [{"region": "us-west-2"}, {"cloud": "gcp"},
                             {"cloud": "aws", "zone": "us-east-1a"}],
                  "exclude_zones": ["us-west-2c"]},
    "replica_policy": {"name": "spothedge", "overprovision": 3,
                       "dynamic_fallback": False, "min_ondemand": 1},
    "autoscaler": {"kind": "load", "target": 6, "qps_per_replica": 1.5},
    "workload": {"kind": "maf", "rate_per_s": 2.0, "seed": 9,
                 "args": {"client_regions": {"us-west-2": 1.0,
                                             "eu-west-1": 1.0}}},
    "latency": {"source": "profile", "profile": "artifacts/profiles"},
    "serving": {"concurrency_cap": 8},
    "observability": {"detail": "off", "trace_sample": 0.0},
    "sim": {"duration_hours": 1.5, "cold_start_s": 90.0, "concurrency": None,
            "preemption_warning_s": 45.0, "record_series": False,
            "engine": "jax"},
    "load_balancer": "round_robin",
    "sweep": {"policies": ["spothedge", {"name": "even_spread"}],
              "traces": ["aws-1", "gcp-1"],
              "workloads": ["poisson", {"kind": "arena", "rate_per_s": 1.0}],
              "seeds": [0, 4]},
}

# built in the test: the sweep's reads examples/sweep.yaml
SPECS = {
    "default": dict,
    "golden": lambda: golden_dict("spothedge"),
    "quickstart": quickstart_dict,
    "sweep": sweep_dict,
    "full": lambda: FULL,
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_to_dict_and_loaders_are_the_references(name, tmp_path):
    d = SPECS[name]()
    want = j_spec_from_dict(d)
    got = spec_from_dict(d)
    assert got.to_dict() == want.to_dict()
    assert spec_from_dict(got.to_dict()) == got           # round trip
    assert got.sweep is None or got.sweep.size == want.sweep.size
    text = json.dumps(want.to_dict())
    assert spec_from_json(text) == got
    path = tmp_path / "s.json"
    path.write_text(text)
    assert spec_from_json(str(path)) == got == load_spec(str(path))
    assert load_spec(got) == got
    yaml = pytest.importorskip("yaml")
    ypath = tmp_path / "s.yaml"
    ypath.write_text(yaml.safe_dump({"service": want.to_dict()}))
    assert spec_from_yaml(str(ypath)) == got == load_spec(str(ypath))
    assert spec_from_yaml(ypath.read_text()) == got


@pytest.mark.parametrize("section", ["ResourceSpec", "PlacementFilter",
                                     "WorkloadSpec", "LatencySpec",
                                     "ServingSpec", "SLOSpec",
                                     "ObservabilitySpec", "SLOBurnSpec",
                                     "SimSpec", "ForecastSpec", "SweepSpec",
                                     "ServiceSpec"])
def test_sections_have_the_references_fields_and_defaults(section):
    port, ref = getattr(__import__("repro_torch.service.spec",
                                   fromlist=[section]), section), \
        getattr(jspec, section)
    assert [f.name for f in dataclasses.fields(port)] == [
        f.name for f in dataclasses.fields(ref)]
    got, want = port(), ref()
    assert got.to_dict() == want.to_dict()


BAD = [
    ({"sim": {"engine": "tpu"}}, "sim.engine"),
    ({"sim": {"replica_model": "block"}}, "sim.replica_model"),
    ({"serving": {"replica_model": "token"},
      "sim": {"replica_model": "request"}}, "conflicts with sim.replica_model"),
    ({"serving": {"prefill_chunk_tokens": 0}}, "prefill_chunk_tokens"),
    ({"serving": {"slo": {"ttft_s": 0.0}}}, "serving.slo"),
    ({"forecast": {"horizon_s": -5.0}}, "forecast"),
    ({"migration": {"compression": "zstd"}}, "migration"),
    ({"migration": {"enabled": True}}, "requires the token-level engine"),
    ({"observability": {"detail": "verbose"}}, "observability.detail"),
    ({"observability": {"slo_burn": {"target": 1.5}}}, "slo_burn"),
    ({"sweep": {"forecasters": ["markov", "risk_spothedge"]}},
     "unknown sweep forecaster 'risk_spothedge'"),
    ({"forecast": {"name": "omniscient"}}, "unknown forecast.name"),
    ({"sweep": {"replica_models": ["block"]}}, "sweep.replica_models"),
    ({"sweep": {"migration": ["yes"]}}, "sweep.migration"),
    ({"workload": {"kind": "trace"}}, "workload.kind"),
    ({"latency": {"source": "measured"}}, "latency.source"),
    ({"resources": {"any_of": []}}, "any_of is empty"),
    ({"resources": {"any_of": [{"planet": "mars"}]}}, "planet"),
    ({"resources": {"instance_type": "dgx"}}, "dgx"),
    ({"sim": {"preemption_warning_s": -1}}, "preemption_warning_s"),
    ({"trace": "aws-9"}, "aws-9"),
    ({"sweep": {"traces": "aws-1"}}, "must be a list"),
]


@pytest.mark.parametrize("extra,match", BAD, ids=[b[1] for b in BAD])
def test_loader_refuses_by_name(extra, match):
    with pytest.raises(SpecError, match=match):
        spec_from_dict({**golden_dict("spothedge"), **extra})


# the observability sections the port refused until its obs port: accepted
# now, and run through Service at a short horizon
OBS_NOW_PORTED = [
    ({"observability": {"detail": "full"}}, "detail 'full'"),
    ({"observability": {"slo_burn": {"target": 0.9}}}, "slo_burn"),
]


@pytest.mark.parametrize("extra,name", OBS_NOW_PORTED,
                         ids=[b[1] for b in OBS_NOW_PORTED])
def test_loader_accepts_ported_observability(extra, name, tmp_path):
    d = golden_dict("spothedge")
    d["sim"] = dict(d["sim"], duration_hours=0.25)
    obs = dict(extra["observability"], out_dir=str(tmp_path))
    spec = spec_from_dict({**d, "observability": obs})
    want = j_spec_from_dict({**d, "observability": obs})
    assert spec.to_dict() == want.to_dict()
    svc = TService(spec, engine="vector")
    res = svc.run()
    assert res.obs is not None and res.obs.events
    full = spec.observability.detail == "full"
    assert bool(svc.artifacts) == full
    assert res.obs.slo_burn.target == spec.observability.slo_burn.target


def test_example_service_yaml_loads_as_the_references():
    """Listing 1 loads whole, its forecast section and risk-aware policy
    included, into the reference's spec."""
    pytest.importorskip("yaml")
    from repro.service import spec_from_yaml as j_spec_from_yaml

    path = os.path.join(ROOT, "examples", "service.yaml")
    got, want = spec_from_yaml(path), j_spec_from_yaml(path)
    assert got.to_dict() == want.to_dict()
    assert got.forecast.to_dict() == {"name": "markov", "horizon_s": 450,
                                      "risk_threshold": 0.6,
                                      "calm_threshold": 0.06}
    assert got.replica_policy.name == "risk_spothedge"


def test_malformed_inputs():
    with pytest.raises(SpecError, match="invalid JSON"):
        spec_from_json("{nope")
    with pytest.raises(SpecError, match="cannot read"):
        spec_from_json("/nonexistent/spec.json")
    with pytest.raises(SpecError, match="infer spec format"):
        load_spec("spec.toml")
    pytest.importorskip("yaml")
    with pytest.raises(SpecError, match="empty YAML"):
        spec_from_yaml("\n")
    with pytest.raises(SpecError, match="mapping"):
        spec_from_dict({"sim": [1, 2]})


@pytest.mark.parametrize("trace,resources", [
    ("aws-3", {"any_of": [{"region": "us-east-1"}, {"region": "us-west-2"}]}),
    ("aws-3", {"any_of": [{"cloud": "aws"}], "exclude_zones": ["us-east-1a"]}),
    ("gcp-1", {"any_of": [{"region": "us-central1"}, {"region": "us-west1"}]}),
    ("gcp-1", {"any_of": [{"zone": "us-central1-a"}]}),
    ("aws-1", {"exclude_zones": ["us-west-2a"]}),
])
def test_resolve_zones_is_the_references(trace, resources):
    res = dict(resources, instance_type="g5.48xlarge")
    want = j_resolve_zones(j_spec_from_dict({"resources": res}).resources,
                           jtr.load_trace(trace), j_catalog())
    got = resolve_zones(spec_from_dict({"resources": res}).resources,
                        ttr.load_trace(trace), t_catalog())
    assert got == want and len(got) >= 1


def test_resolve_zones_refuses_an_empty_match():
    res = spec_from_dict({"resources": {"any_of": [{"cloud": "azure"}]}})
    with pytest.raises(SpecError, match="matches no zone"):
        resolve_zones(res.resources, ttr.load_trace("aws-1"), t_catalog())


# ---------------------------------------------------------------------------
# Service
# ---------------------------------------------------------------------------


def _port_run(d, engine):
    svc = TService(d, engine=engine)
    res = svc.run(device="cpu")
    assert svc.status().get("oracle_rerun", False) is False
    assert ("oracle_rerun" in svc.status()) == (engine == "jax")
    return svc, res


@pytest.mark.parametrize("engine", ["vector", "jax"])
@pytest.mark.parametrize("policy", ["spothedge", "even_spread",
                                    "ondemand_only"])
def test_service_reproduces_the_golden_constants(policy, engine):
    want = GOLDEN[policy]
    svc, res = _port_run(golden_dict(policy), engine)
    for k in ("n_requests", "n_completed", "n_failed", "n_preemptions",
              "n_launch_failures"):
        assert getattr(res, k) == getattr(want, k), k
    assert res.total_cost == pytest.approx(want.total_cost, abs=1e-6)
    assert res.pct(50) == pytest.approx(want.p50_s, abs=1e-6)
    assert res.pct(99) == pytest.approx(want.p99_s, abs=1e-6)
    assert res.availability == pytest.approx(want.availability, abs=1e-6)
    _assert_same_result(res, JService(golden_dict(policy)).run())
    st = svc.status()
    assert st["state"] == "finished" and st["n_requests"] == want.n_requests


VARIANTS = {
    "quickstart-1h": quickstart_dict(hours=1.0),
    "warning-override-rr": dict(
        golden_dict("spothedge"), load_balancer="round_robin",
        sim=dict(golden_dict("spothedge")["sim"], duration_hours=1.0,
                 preemption_warning_s=5.0)),
    "maf-regions": dict(
        golden_dict("even_spread"), trace="gcp-1",
        workload={"kind": "maf", "rate_per_s": 0.8, "seed": 4,
                  "args": {"client_regions": REGIONS}},
        sim=dict(golden_dict("even_spread")["sim"], duration_hours=1.0)),
    "no-workload": dict(golden_dict("spothedge"), workload={"kind": "none"}),
    "model-derived-concurrency": dict(
        golden_dict("spothedge"), serving={"concurrency_cap": 3},
        sim=dict(golden_dict("spothedge")["sim"], duration_hours=1.0,
                 concurrency=None)),
}


@pytest.mark.parametrize("engine", ["vector", "jax"])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_service_is_the_references(name, engine):
    d = VARIANTS[name]
    svc, got = _port_run(d.get("service", d), engine)
    ref = JService(d)
    want = ref.run()
    _assert_same_result(got, want)
    st, jst = svc.status(), ref.status()
    for k in ("state", "zones", "n_requests", "n_events", "n_preemptions",
              "n_launch_failures"):
        assert st[k] == jst[k], k


def test_service_engine_rule():
    """The engine is the ``Service``'s, as the CLI's ``--engine`` is: ``jax``
    whatever the spec says, ``vector`` on request (the host, so no device
    but the CPU), ``None`` for the spec's own."""
    d = golden_dict("spothedge")
    d["sim"] = dict(d["sim"], engine="vector", duration_hours=0.5)
    assert TService(d).spec.sim.engine == "jax"
    assert TService(d, engine=None).spec.sim.engine == "vector"
    assert TService(quickstart_dict()).spec.sim.engine == "jax"
    host = TService(d, engine="vector")
    with pytest.raises(ValueError, match="host engine"):
        host.run(device="cuda")
    assert host.result is None
    _assert_same_result(host.run(device=torch.device("cpu")), JService(d).run())
    legacy = TService(d, engine="legacy")
    assert legacy.spec.sim.engine == "legacy"
    with pytest.raises(ValueError, match="host engine"):
        legacy.run(device="cuda")
    _assert_same_result(legacy.run(), JService(d).run())
    suite = TSuite.from_spec(dict(d, sweep={"traces": ["aws-1", "gcp-1"]}))
    with pytest.raises(ValueError, match="host engine"):
        suite.run(engine="vector", device="cuda")


def test_service_prices_with_a_profile_row(tmp_path):
    path = _write_table(tmp_path / "t.json")
    d = {"name": "h100", "model": "llama3.2-1b", "trace": "gcp-1",
         "resources": {"instance_type": "h100",
                       "any_of": [{"region": "us-central1"},
                                  {"region": "us-west1"}]},
         "replica_policy": {"name": "spothedge"},
         "autoscaler": {"kind": "constant", "target": 3},
         "workload": {"kind": "arena", "rate_per_s": 0.1, "seed": 11},
         "latency": {"source": "profile", "profile": path},
         "sim": {"duration_hours": 2.0, "timeout_s": 100.0,
                 "concurrency": 4, "engine": "jax"}}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        svc = TService(d)
        resolved = svc.resolve()
    lm = resolved.simulator.latency_model
    assert isinstance(lm, tlat.ProfiledLatencyModel)
    assert (lm.mfu_prefill, lm.profile_path) == (0.00491135, path)
    got = svc.run(device="cpu")
    assert svc.status()["oracle_rerun"] is False
    oracle = TService(d, engine="vector").run()
    _assert_same_result(got, oracle)
    roof = TService(dict(d, latency={"source": "roofline"})).run(device="cpu")
    assert roof.pct(50) < got.pct(50)       # the profile row prices slower


# ---------------------------------------------------------------------------
# ScenarioSuite
# ---------------------------------------------------------------------------

REPORT_FIELDS = ("n_requests", "n_completed", "n_failed", "failure_rate",
                 "mean_s", "p50_s", "p90_s", "p99_s", "total_cost",
                 "cost_vs_ondemand", "availability", "n_preemptions",
                 "n_launch_failures")


@pytest.mark.parametrize("engine", ["vector", "jax"])
def test_suite_is_the_references_cell_for_cell(engine, tmp_path):
    d = sweep_dict()
    want = JSuite.from_spec(d).run()
    suite = TSuite.from_spec(d)
    assert [sc.labels for sc in suite.scenarios] == [c.labels
                                                     for c in want.cells]
    got = suite.run(engine=engine, device="cpu", save_to=str(tmp_path))
    assert len(got) == len(want) == 12
    for a, b in zip(got.cells, want.cells):
        assert a.labels == b.labels
        for k in REPORT_FIELDS:
            x, y = getattr(a, k), getattr(b, k)
            if isinstance(y, float):
                assert x == pytest.approx(y, abs=TOL, nan_ok=True), k
            else:
                assert x == y, k
    saved = json.loads((tmp_path / "scenario_sweep-demo.json").read_text())
    assert saved["n_cells"] == 12 and saved["engine"] == engine
    if engine == "jax":
        assert (got.shape_groups, got.oracle_reruns) == (1, [])
        assert "1 shape group" in got.summary()
    assert got.select(policy="even_spread", trace="gcp-1")[0].cell_id == \
        "even_spread/gcp-1/poisson/0"


def test_suite_shares_tapes_and_fans_out():
    suite = TSuite.from_spec(sweep_dict(workloads=()))
    assert len(suite) == 4 and len({sc.tape_key for sc in suite.scenarios}) == 1
    tapes = [suite._tape(sc) for sc in suite.scenarios]
    assert all(t is tapes[0] for t in tapes) and len(suite._tapes) == 1
    cells = suite.cells()
    arr = [[r.arrival_s for r in c.engine.requests] for c in cells]
    assert all(a == arr[0] for a in arr)
    # the workers share the suite's tapes: each payload carries its own
    d = sweep_dict(workloads=())
    d["service"]["sim"]["duration_hours"] = 0.5
    d["service"]["forecast"] = {"name": "markov"}
    suite = TSuite.from_spec(d)
    report = suite.run(engine="vector", workers=4)
    want = JSuite.from_spec(d).run(engine="vector", workers=None)
    assert report.workers == 4 and want.workers == 1
    assert len(suite._tapes) == 1
    for a, b in zip(report.cells, want.cells):
        assert a.labels == b.labels
        for k in REPORT_FIELDS:
            x, y = getattr(a, k), getattr(b, k)
            if isinstance(y, float):
                assert x == pytest.approx(y, abs=TOL, nan_ok=True), k
            else:
                assert x == y, k


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _spec_file(tmp_path, d, name="s.json"):
    path = tmp_path / name
    path.write_text(json.dumps(d))
    return str(path)


@pytest.mark.parametrize("engine", ["vector", "jax"])
def test_cli_status_and_sweep(tmp_path, monkeypatch, capsys, engine):
    monkeypatch.chdir(tmp_path)
    d = golden_dict("spothedge")
    d["sim"]["duration_hours"] = 0.5
    args = ["--spec", _spec_file(tmp_path, d), "--engine", engine,
            "--device", "cpu"]
    assert tserve.main(args + ["--status"]) == 0
    out = capsys.readouterr().out
    status = json.loads(out[out.index("{"):])
    want = JService(d).run()
    assert status["state"] == "finished"
    assert status["n_completed"] == want.n_completed
    assert status["total_cost"] == pytest.approx(want.total_cost, abs=TOL)
    sw = sweep_dict(workloads=())
    sw["service"]["sim"]["duration_hours"] = 0.5
    assert tserve.main(["--spec", _spec_file(tmp_path, sw, "w.json"),
                        "--sweep", "--engine", engine, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "4 scenarios" in out
    assert (tmp_path / "artifacts" / "bench" /
            "scenario_sweep-demo.json").exists()


@pytest.mark.parametrize("spec,fragment", [
    ({"sim": {"duration_hours": -1}}, "duration_hours"),
    ({"forecast": {"name": "prophet"}}, "forecast"),
    ({"bogus": 1}, "bogus"),
])
def test_cli_malformed_spec_exits_2(tmp_path, capsys, spec, fragment):
    rc = tserve.main(["--spec", _spec_file(tmp_path, spec), "--engine",
                      "vector"])
    err = capsys.readouterr().err.strip().splitlines()
    assert rc == 2
    assert len(err) == 1 and err[0].startswith("error: ") and fragment in err[0]


def test_cli_workers_needs_sweep(tmp_path, capsys):
    rc = tserve.main(["--spec", _spec_file(tmp_path, golden_dict("spothedge")),
                      "--engine", "vector", "--workers", "2"])
    assert rc == 2 and "--workers requires --sweep" in capsys.readouterr().err


def test_cli_runs_the_token_model_with_a_forecast(tmp_path, capsys):
    """``--replica-model token`` runs, and so does a forecast section with
    the risk-aware policy: the summary line is the reference CLI's."""
    from repro.launch import serve as jserve

    d = golden_dict("spothedge")
    d["sim"]["duration_hours"] = 0.5
    assert tserve.main(["--spec", _spec_file(tmp_path, d), "--engine",
                        "vector", "--replica-model", "token"]) == 0
    assert "ttft_p50=" in capsys.readouterr().out
    path = _spec_file(tmp_path, dict(
        d, forecast={"name": "markov"},
        replica_policy={"name": "risk_spothedge"}))
    args = ["--spec", path, "--engine", "vector", "--replica-model", "token"]
    assert tserve.main(args) == 0
    got = capsys.readouterr().out.strip().splitlines()
    assert jserve.main(args) == 0
    want = capsys.readouterr().out.strip().splitlines()
    assert "ttft_p50=" in got[-1] and got[1:] == want[1:]
