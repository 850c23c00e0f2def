"""The port's observability (``repro_torch.obs``) held against the
reference's (``repro.obs``) on the CPU.

The fixture is the reference's own (``tests/test_obs.py``): the ``mini``
correlated trace over 3 zones, spothedge at a constant 3 replicas on
g5.48xlarge, Poisson 0.8/s for 2 h, timeout 60 s, concurrency 2, detail
``full``.  The reference's ``JaxServingEngine`` does not run here, so the
port's engines are held against the reference's ``ServingSimulator`` and
``VectorizedServingEngine``:

* the port's legacy and vector engines write event logs byte-identical to
  the reference's, in request mode and in token + migration mode;
* the port's two-phase engine (``TorchServingEngine``, phase B through the
  plain ``scenario_scan`` on the CPU) records the reference vector stream's
  control plane, byte for byte;
* the exporters, ``summarize`` / ``diff`` / ``attribution_report`` and the
  CLI give the reference's output on the same records;
* a ``Service`` at detail ``full`` writes the reference ``Service``'s
  artifact files, byte for byte.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.cluster.traces as jtr  # noqa: E402
import repro.obs as jobs  # noqa: E402
import repro_torch.cluster.traces as ttr  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro.cluster.catalog import default_catalog as j_catalog  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.core.autoscaler import ConstantTarget as JConstant  # noqa: E402
from repro.core.policy import make_policy as j_make_policy  # noqa: E402
from repro.migration.config import MigrationSpec as JMigration  # noqa: E402
from repro.obs.__main__ import main as j_obs_main  # noqa: E402
from repro.serving.engine import VectorizedServingEngine as JVector  # noqa: E402
from repro.serving.latency import make_latency_model as j_make_latency  # noqa: E402
from repro.serving.sim import ServingSimulator as JLegacy  # noqa: E402
from repro.service import Service as JService  # noqa: E402
from repro.service import SpecError as JSpecError  # noqa: E402
from repro.service import spec_from_dict as j_spec_from_dict  # noqa: E402
from repro.workloads import make_workload as j_make_workload  # noqa: E402
from repro_torch.cluster.catalog import default_catalog as t_catalog  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.core.autoscaler import ConstantTarget as TConstant  # noqa: E402
from repro_torch.core.policy import make_policy as t_make_policy  # noqa: E402
from repro_torch.experiments import ScenarioSuite  # noqa: E402
from repro_torch.experiments.report import CellResult  # noqa: E402
from repro_torch.migration.config import MigrationSpec as TMigration  # noqa: E402
from repro_torch.obs.__main__ import main as t_obs_main  # noqa: E402
from repro_torch.serving.engine import VectorizedServingEngine as TVector  # noqa: E402
from repro_torch.serving.latency import make_latency_model as t_make_latency  # noqa: E402
from repro_torch.serving.sim import ServingSimulator as TLegacy  # noqa: E402
from repro_torch.serving.torchengine.engine import TorchServingEngine  # noqa: E402
from repro_torch.service import Service as TService  # noqa: E402
from repro_torch.service import SpecError as TSpecError  # noqa: E402
from repro_torch.service import spec_from_dict as t_spec_from_dict  # noqa: E402
from repro_torch.workloads.arrivals import Request  # noqa: E402

HOURS = 2.0

#: the reference's per-kind event totals of the fixture at detail "full"
#: (tests/test_obs.py, GOLDEN_COUNTS)
GOLDEN_COUNTS = {
    "autoscaler_target": 1,
    "decision": 498,
    "launch_failure": 478,
    "lifecycle": 40,
    "slo_burn": 130,
    "warning": 14,
    "window": 130,
}


def _mini_trace(mod, hours):
    zones = ["us-west-2a", "us-west-2b", "us-east-2a"]
    return mod.synth_correlated_trace(
        zones, {z: z[:-1] for z in zones}, steps=int(hours * 60) + 60,
        dt=60.0, seed=3, max_capacity=4, name="mini")


def _requests(hours):
    reqs = j_make_workload("poisson", rate_per_s=0.8, seed=3).generate(
        hours * 3600.0)
    port = [Request(arrival_s=r.arrival_s, prompt_tokens=r.prompt_tokens,
                    output_tokens=r.output_tokens, id=r.id,
                    client_region=r.client_region) for r in reqs]
    return reqs, port


def run_fixture(cls, *, detail="full", trace_sample=0.01,
                replica_model="request", migration=None, hours=HOURS,
                slo_burn=None, token_scheduler=None, **run_kw):
    """The reference's obs fixture through ``cls`` (either package's
    engine); the recorder is the package's own."""
    port = cls.__module__.startswith("repro_torch")
    reqs = _requests(hours)[1 if port else 0]
    rec = (tobs if port else jobs).ObsRecorder(
        detail=detail, trace_sample=trace_sample, slo_burn=slo_burn)
    kw = {} if token_scheduler is None else {
        "token_scheduler": token_scheduler}
    sim = cls(
        _mini_trace(ttr if port else jtr, hours),
        (t_make_policy if port else j_make_policy)("spothedge"), reqs,
        (t_config if port else j_config)("llama3.2-1b"),
        itype="g5.48xlarge",
        autoscaler=(TConstant if port else JConstant)(3),
        timeout_s=60.0, concurrency=2, workload_name="poisson",
        replica_model=replica_model, migration=migration, obs=rec, **kw)
    return sim.run(hours * 3600.0 + 600.0, **run_kw)


@pytest.fixture(scope="module")
def runs():
    """The request-mode fixture: the reference's legacy and vector engines,
    the port's legacy, vector and two-phase (plain phase B) engines."""
    return {
        "j_legacy": run_fixture(JLegacy),
        "j_vector": run_fixture(JVector),
        "t_legacy": run_fixture(TLegacy),
        "t_vector": run_fixture(TVector),
        "t_card": run_fixture(TorchServingEngine, device="cpu"),
    }


# ---------------------------------------------------------------------------
# the registry and the recorder, against the reference's


def _registry_ops(mod):
    reg = mod.MetricsRegistry()
    empty = bool(reg)
    reg.inc("launches", zone="us-west-2a")
    reg.inc("launches", 2, zone="us-west-2a")
    reg.inc("x", a=1, b=2)
    reg.inc("x", b=2, a=1)
    reg.gauge("target", 3)
    reg.observe("latency_s", 1.0)
    reg.observe("latency_s", 3.0)
    other = mod.MetricsRegistry()
    other.inc("launches", 4, zone="us-west-2a")
    other.gauge("target", 9)
    other.observe("latency_s", 5.0)
    merged = mod.MetricsRegistry.merge_snapshots(
        [reg.snapshot(), None, {}, other.snapshot()])
    return (empty, bool(reg), reg.counter("launches", zone="us-west-2a"),
            reg.counter("launches", zone="nowhere"), reg.snapshot(), merged,
            mod.MetricsRegistry.merge_snapshots([]))


def test_registry_matches_reference():
    got = _registry_ops(tobs)
    assert got == _registry_ops(jobs)
    assert got[4]["counters"] == {"launches{zone=us-west-2a}": 3,
                                  "x{a=1,b=2}": 2}


def test_use_registry_scoping_and_nesting():
    outer, inner = tobs.MetricsRegistry(), tobs.MetricsRegistry()
    default = tobs.get_registry()
    with tobs.use_registry(outer):
        tobs.get_registry().inc("k")
        with tobs.use_registry(inner):
            tobs.get_registry().inc("k")
        tobs.get_registry().inc("k")
    assert tobs.get_registry() is default
    assert (outer.counter("k"), inner.counter("k")) == (2, 1)


def test_latency_profile_fallback_is_run_scoped(tmp_path):
    """No profile row: both packages warn and count the fallback on the
    active registry, each run on its own."""
    missing = str(tmp_path / "none.json")
    counts = {}
    for name, mod, make, cat, cfg in (
            ("port", tobs, t_make_latency, t_catalog, t_config),
            ("ref", jobs, j_make_latency, j_catalog, j_config)):
        itype = cat().instance_type("g5.48xlarge")
        regs = [mod.MetricsRegistry(), mod.MetricsRegistry()]
        for reg in regs:
            with mod.use_registry(reg), pytest.warns(UserWarning):
                make(cfg("llama3.2-1b"), itype, model_id="no-such-model",
                     source="profile", profile=missing)
        counts[name] = [r.snapshot() for r in regs]
    assert counts["port"] == counts["ref"]
    assert counts["port"][0] == {"counters": {
        "latency_profile_fallback{accelerator=A10G,model=no-such-model}": 1}}


def test_recorder_matches_reference():
    for kw in ({"detail": "verbose"}, {"window_s": 0.0},
               {"trace_sample": 1.5}):
        with pytest.raises(ValueError):
            tobs.ObsRecorder(**kw)
    assert tobs.DETAIL_LEVELS == jobs.DETAIL_LEVELS
    got, want = tobs.ObsRecorder(), jobs.ObsRecorder()
    for attr in ("detail", "window_s", "trace_sample", "enabled",
                 "wants_windows"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert [got.replica_ordinal(i) for i in (1234, 99, 1234)] == [0, 1, 0]
    fresh = got.fresh()
    assert (fresh.detail, fresh.window_s, fresh.events) == (
        got.detail, got.window_s, [])
    assert fresh.replica_ordinal(99) == 0
    assert tobs.SLOBurnConfig() == tobs.SLOBurnConfig(
        **vars(jobs.SLOBurnConfig()))
    with pytest.raises(ValueError):
        tobs.SLOBurnConfig(fast_window_s=7200.0)


def _obs_spec(**obs):
    d = {
        "name": "obs-smoke",
        "model": "llama3.2-1b",
        "trace": "aws-1",
        "resources": {"instance_type": "g5.48xlarge"},
        "autoscaler": {"kind": "constant", "target": 2},
        "workload": {"kind": "poisson", "rate_per_s": 0.5, "seed": 7},
        "sim": {"duration_hours": 0.5, "timeout_s": 60.0, "concurrency": 2},
    }
    if obs:
        d["observability"] = obs
    return d


@pytest.mark.parametrize("obs,ok", [
    ({}, True),
    ({"detail": "full", "window_s": 30.0}, True),
    ({"slo_burn": {"target": 0.95, "fast_window_s": 120.0}}, True),
    ({"detail": "everything"}, False),
    ({"window_s": 0}, False),
    ({"verbosity": 3}, False),
    ({"slo_burn": {"target": 1.0}}, False),
    ({"slo_burn": {"fast_window_s": 7200.0}}, False),
    ({"trace_sample": 2.0}, False),
], ids=["default", "full", "slo_burn", "bad-detail", "bad-window",
        "unknown-key", "bad-target", "bad-windows", "bad-sample"])
def test_observability_spec_validation_matches_reference(obs, ok):
    if ok:
        got = t_spec_from_dict(_obs_spec(**obs))
        want = j_spec_from_dict(_obs_spec(**obs))
        assert got.to_dict()["observability"] == \
            want.to_dict()["observability"]
        assert t_spec_from_dict(got.to_dict()) == got
    else:
        with pytest.raises(JSpecError):
            j_spec_from_dict(_obs_spec(**obs))
        with pytest.raises(TSpecError):
            t_spec_from_dict(_obs_spec(**obs))


# ---------------------------------------------------------------------------
# the engines against the reference's


def test_legacy_and_vector_logs_are_the_references(runs):
    want = jobs.dumps_jsonl(runs["j_vector"].obs.events)
    assert jobs.dumps_jsonl(runs["j_legacy"].obs.events) == want
    assert tobs.dumps_jsonl(runs["t_legacy"].obs.events) == want
    assert tobs.dumps_jsonl(runs["t_vector"].obs.events) == want
    assert len(want.splitlines()) == sum(GOLDEN_COUNTS.values())
    spans = jobs.dumps_jsonl(runs["j_vector"].obs.span_records())
    assert spans
    assert tobs.dumps_jsonl(runs["t_legacy"].obs.span_records()) == spans
    assert tobs.dumps_jsonl(runs["t_vector"].obs.span_records()) == spans


def test_golden_event_counts(runs):
    for k in ("j_vector", "t_legacy", "t_vector"):
        assert runs[k].obs.event_counts() == GOLDEN_COUNTS, k
    # phase A replays the control plane: no window samples, so no burn
    # windows either
    assert runs["t_card"].obs.event_counts() == {
        k: v for k, v in GOLDEN_COUNTS.items()
        if k not in ("window", "slo_burn")}


def test_card_engine_records_the_reference_control_plane(runs):
    want = jobs.control_plane_records(runs["j_vector"].obs.records())
    got = runs["t_card"].obs.records()
    assert tobs.dumps_jsonl(got) == jobs.dumps_jsonl(want)
    assert tobs.control_plane_records(got) == got
    card, host = runs["t_card"], runs["t_vector"]
    assert (card.n_completed, card.n_failed) == (host.n_completed,
                                                 host.n_failed)
    assert card.metrics == host.metrics


def test_decisions_carry_reasons_and_replica_links(runs):
    recs = runs["t_vector"].obs.records()
    decisions = [r for r in recs if r["event"] == "decision"]
    launches = [d for d in decisions if d["action"].startswith("launch")]
    assert launches and any(d.get("reason") for d in decisions)
    provisioned = {r["instance_id"] for r in recs
                   if r["event"] == "lifecycle" and r["phase"] == "provision"}
    linked = [d["instance_id"] for d in launches if "instance_id" in d]
    assert linked and set(linked) <= provisioned


@pytest.mark.parametrize("cls", [TVector, TLegacy, TorchServingEngine],
                         ids=["vector", "legacy", "card-plain"])
def test_detail_off_and_full_are_metric_identical(cls):
    kw = {"device": "cpu"} if cls is TorchServingEngine else {}
    off = run_fixture(cls, detail="off", hours=1.0, **kw)
    full = run_fixture(cls, detail="full", hours=1.0, **kw)
    assert off.obs is None and off.metrics is None
    assert full.obs is not None and full.obs.events
    for f in ("n_requests", "n_completed", "n_failed", "n_preemptions",
              "total_cost", "availability", "n_retried_requests"):
        assert getattr(off, f) == getattr(full, f), f
    np.testing.assert_array_equal(off.latencies_s, full.latencies_s)


def test_token_migration_logs_are_the_references():
    kw = dict(replica_model="token", hours=1.0, trace_sample=1.0)
    want_l = run_fixture(JLegacy, migration=JMigration(
        enabled=True, drain_threshold_s=2.0), **kw)
    want_v = run_fixture(JVector, migration=JMigration(
        enabled=True, drain_threshold_s=2.0), **kw)
    spec = TMigration(enabled=True, drain_threshold_s=2.0)
    got_l = run_fixture(TLegacy, migration=spec, **kw)
    got_v = run_fixture(TVector, migration=spec, **kw)
    want = jobs.dumps_jsonl(want_v.obs.events)
    assert jobs.dumps_jsonl(want_l.obs.events) == want
    assert tobs.dumps_jsonl(got_l.obs.events) == want
    assert tobs.dumps_jsonl(got_v.obs.events) == want
    assert got_v.obs.event_counts().get("migration_plan", 0) > 0
    spans = jobs.dumps_jsonl(want_v.obs.span_records())
    assert tobs.dumps_jsonl(got_l.obs.span_records()) == spans
    assert tobs.dumps_jsonl(got_v.obs.span_records()) == spans


# ---------------------------------------------------------------------------
# exporters, summaries, attribution and the CLI


def test_jsonl_roundtrip(tmp_path, runs):
    events = runs["t_vector"].obs.events
    path = tobs.write_jsonl(events, str(tmp_path / "run.jsonl"))
    records = tobs.read_jsonl(path)
    assert tobs.dumps_jsonl(records) == tobs.dumps_jsonl(events)
    assert all(r["schema"] == 1 for r in records)
    with open(path, "rb") as f:
        mine = f.read()
    ref = jobs.write_jsonl(runs["j_vector"].obs.events,
                           str(tmp_path / "ref.jsonl"))
    with open(ref, "rb") as f:
        assert mine == f.read()


def test_chrome_trace_roundtrip(tmp_path, runs):
    obs = runs["t_vector"].obs
    spans = obs.span_records()
    path = tobs.write_chrome_trace(obs.events, str(tmp_path / "t.json"),
                                   spans=spans)
    with open(path) as f:
        trace = json.load(f)
    assert trace["otherData"]["schema"] == 1
    assert {"M", "X", "i", "C"} <= {e["ph"] for e in trace["traceEvents"]}
    assert all(e["dur"] >= 0 for e in trace["traceEvents"]
               if e["ph"] == "X")
    assert json.dumps(tobs.chrome_trace(obs.records(), spans=spans),
                      sort_keys=True) == json.dumps(trace, sort_keys=True)
    ref = jobs.write_chrome_trace(
        runs["j_vector"].obs.events, str(tmp_path / "r.json"),
        spans=runs["j_vector"].obs.span_records())
    with open(path, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def test_summarize_diff_and_attribution_are_the_references(runs):
    v, c = runs["t_vector"].obs.records(), runs["t_card"].obs.records()
    jv = runs["j_vector"].obs.records()
    s = tobs.summarize(v)
    assert s == jobs.summarize(jv)
    assert s["event_counts"] == GOLDEN_COUNTS
    assert tobs.diff_summaries(v, v)["identical"]
    diff = tobs.diff_summaries(v, c)
    assert diff == jobs.diff_summaries(jv, c)
    assert not diff["identical"]
    assert diff["event_counts"]["window"]["delta"] == -GOLDEN_COUNTS["window"]
    spans = runs["t_vector"].obs.span_records()
    rep = tobs.attribution_report(v, top=5, spans=spans)
    assert rep == jobs.attribution_report(jv, top=5, spans=spans)
    assert rep["n_decisions"] == GOLDEN_COUNTS["decision"]
    assert len(rep["top_decisions"]) == 5


def _cli(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_cli_output_is_the_references(tmp_path, runs, capsys):
    obs = runs["t_vector"].obs
    a = tobs.write_jsonl(obs.events, str(tmp_path / "a.jsonl"))
    b = tobs.write_jsonl(runs["t_card"].obs.records(),
                         str(tmp_path / "b.jsonl"))
    sp = tobs.write_jsonl(obs.span_records(), str(tmp_path / "a.spans.jsonl"))
    o = obs.span_records()[0]["ordinal"]
    cases = [
        (["summarize", a], 0), (["summarize", a, "--json"], 0),
        (["diff", a, a], 0), (["diff", a, b], 1), (["diff", a, b, "--json"], 1),
        (["attribute", a, "--top", "3"], 0),
        (["attribute", a, "--spans", sp, "--json"], 0),
        (["request", sp, str(o)], 0), (["request", sp, str(o), "--json"], 0),
        (["request", sp, "999999"], 1),
        (["slo", a], 0), (["slo", a, "--json"], 0),
    ]
    for argv, rc in cases:
        got = _cli(t_obs_main, argv, capsys)
        want = _cli(j_obs_main, argv, capsys)
        assert got == want and got[0] == rc, argv
    out = str(tmp_path / "a.trace.json")
    assert _cli(t_obs_main, ["trace", a, "-o", out], capsys)[0] == 0
    with open(out) as f:
        assert json.load(f)["traceEvents"]


# ---------------------------------------------------------------------------
# the front door: Service, CellResult, the suite


def test_service_artifacts_are_the_references(tmp_path):
    got_dir, want_dir = tmp_path / "port", tmp_path / "ref"
    svc = TService(_obs_spec(detail="full", out_dir=str(got_dir)),
                   engine="vector")
    res = svc.run()
    ref = JService(_obs_spec(detail="full", out_dir=str(want_dir)))
    ref.run()
    assert set(svc.artifacts) == set(ref.artifacts) == {
        "events", "spans", "trace"}
    for kind in svc.artifacts:
        with open(svc.artifacts[kind], "rb") as a, \
                open(ref.artifacts[kind], "rb") as b:
            assert a.read() == b.read(), kind
    assert tobs.dumps_jsonl(tobs.read_jsonl(svc.artifacts["events"])) == \
        tobs.dumps_jsonl(res.obs.records())
    status = svc.status()
    assert status["obs_event_counts"] == res.obs.event_counts()
    assert status["obs_artifacts"] == svc.artifacts


def test_service_on_the_card_engine_writes_its_artifacts(tmp_path):
    svc = TService(_obs_spec(detail="full", trace_sample=1.0,
                             out_dir=str(tmp_path)))
    res = svc.run(device="cpu")
    assert set(svc.artifacts) == {"events", "spans", "trace"}
    assert sorted(os.listdir(tmp_path)) == [
        "obs-smoke.events.jsonl", "obs-smoke.spans.jsonl",
        "obs-smoke.trace.json"]
    assert tobs.read_jsonl(svc.artifacts["spans"]) == \
        res.obs.span_records()


def test_service_default_detail_writes_nothing(tmp_path):
    svc = TService(_obs_spec(out_dir=str(tmp_path)), engine="vector")
    res = svc.run()
    assert res.obs is not None and svc.artifacts == {}
    assert list(tmp_path.iterdir()) == []


def test_cell_result_carries_the_obs_fields(runs):
    port = CellResult.from_result({"policy": "spothedge"}, runs["t_vector"],
                                  0.1)
    from repro.experiments.report import CellResult as JCellResult

    ref = JCellResult.from_result({"policy": "spothedge"}, runs["j_vector"],
                                  0.1)
    for f in ("metrics", "obs_event_counts", "obs_windows", "slo_burn",
              "n_spans"):
        assert getattr(port, f) == getattr(ref, f), f
    assert port.obs_event_counts == GOLDEN_COUNTS
    assert len(port.obs_windows) == GOLDEN_COUNTS["window"]
    assert port.to_dict()["obs_event_counts"] == GOLDEN_COUNTS
    card = CellResult.from_result({"policy": "spothedge"}, runs["t_card"],
                                  0.1)
    assert card.obs_windows is None and card.slo_burn is None
    assert card.n_spans == len(runs["t_card"].obs.span_records())


def test_suite_merges_the_cells_snapshots(tmp_path):
    """Every cell counts its profile fallback on its own registry; the
    report merges them."""
    d = _obs_spec()
    d["latency"] = {"source": "profile",
                    "profile": str(tmp_path / "none.json")}
    d["sim"] = dict(d["sim"], duration_hours=0.25)
    d["sweep"] = {"seeds": [0, 1]}
    with pytest.warns(UserWarning):
        report = ScenarioSuite.from_spec(d).run(engine="vector")
    key = "latency_profile_fallback{accelerator=A10G,model=llama3.2-1b}"
    assert [c.metrics for c in report.cells] == [
        {"counters": {key: 1}}] * 2
    assert report.metrics == {"counters": {key: 2}}
    assert report.to_dict()["metrics"] == report.metrics
    with pytest.warns(UserWarning):
        card = ScenarioSuite.from_spec(d).run(device="cpu")
    assert card.metrics == report.metrics
