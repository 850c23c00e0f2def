"""The port's token-level serving model against the reference's, on the CPU.

The port keeps its own copies of the token engine's configuration
(``TokenSchedulerConfig``, ``TokenEngineConfig.from_latency``), metrics
(``TokenRecord``, ``TokenStats``) and scheduler (``ContinuousBatch``), of
the token mode of ``VectorizedServingEngine``, of the legacy
``ServingSimulator`` with its replicas and balancers, and of the front
door's token paths (the ``serving:`` section, the ``replica_models`` sweep
axis, ``run_cells`` on a mixed matrix, the serve CLI).  Each is held here
against the reference on the same inputs.

Tolerances: counts exact; costs 1e-9, availability 1e-12; latencies and
the TTFT / TPOT arrays 1e-6; goodput and SLO attainment 1e-9.  The
scheduler takes the reference's float operations in its order, so the
batch-level checks are exact.
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.cluster.catalog as jcat  # noqa: E402
import repro.cluster.traces as jtr  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.core.autoscaler import ConstantTarget as JConstant  # noqa: E402
from repro.core.policy import make_policy as j_make_policy  # noqa: E402
from repro.experiments import ScenarioSuite as JSuite  # noqa: E402
from repro.serving import latency as jlat  # noqa: E402
from repro.serving import load_balancer as jlb  # noqa: E402
from repro.serving.engine import VectorizedServingEngine as JVector  # noqa: E402
from repro.serving.sim import ServingSimulator as JLegacy  # noqa: E402
from repro.serving.token import batch as jbatch  # noqa: E402
from repro.serving.token import config as jtok  # noqa: E402
from repro.serving.token import metrics as jmet  # noqa: E402
from repro.service import Service as JService  # noqa: E402
from repro.service import spec_from_dict as j_spec_from_dict  # noqa: E402
from repro.workloads import make_workload as j_make_workload  # noqa: E402

import repro_torch.cluster.catalog as tcat  # noqa: E402
import repro_torch.cluster.traces as ttr  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.core.autoscaler import ConstantTarget as TConstant  # noqa: E402
from repro_torch.core.policy import make_policy as t_make_policy  # noqa: E402
from repro_torch.experiments import ScenarioSuite as TSuite  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serving import latency as tlat  # noqa: E402
from repro_torch.serving import load_balancer as tlb  # noqa: E402
from repro_torch.serving.engine import VectorizedServingEngine as TVector  # noqa: E402
from repro_torch.serving.sim import ServingSimulator as TLegacy  # noqa: E402
from repro_torch.serving.token import batch as tbatch  # noqa: E402
from repro_torch.serving.token import config as ttok  # noqa: E402
from repro_torch.serving.token import metrics as tmet  # noqa: E402
from repro_torch.serving.torchengine import engine as teng  # noqa: E402
from repro_torch.service import Service as TService  # noqa: E402
from repro_torch.service import spec_from_dict  # noqa: E402
from repro_torch.workloads.arrivals import Request  # noqa: E402

COUNTS = ("n_requests", "n_completed", "n_failed", "n_retried_requests",
          "n_preemptions", "n_launch_failures", "lost_kv_tokens")
TOKEN_COUNTS = ("n_requests", "n_recorded", "n_slo_ok", "n_kv_preempted_seqs",
                "n_killed_queued", "lost_prefill_tokens", "lost_decode_tokens",
                "n_drained_seqs", "n_migrated_seqs", "migrated_kv_tokens",
                "saved_prefill_tokens", "saved_decode_tokens")


def assert_same_result(got, want):
    """Tentpole part a's tolerances, field for field, the token stats and
    their windows included."""
    for k in COUNTS:
        assert getattr(got, k) == getattr(want, k), k
    for k in ("total_cost", "spot_cost", "od_cost", "cost_vs_ondemand"):
        assert getattr(got, k) == pytest.approx(getattr(want, k), abs=1e-9), k
    assert got.availability == pytest.approx(want.availability, abs=1e-12)
    assert (got.policy, got.trace, got.workload) == (want.policy, want.trace,
                                                      want.workload)
    a, b = np.sort(got.latencies_s), np.sort(want.latencies_s)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    if want.token is None:
        assert got.token is None
        return
    gt, wt = got.token, want.token
    for k in TOKEN_COUNTS:
        assert getattr(gt, k) == getattr(wt, k), k
    for k in ("goodput_rps", "slo_attainment", "migration_transfer_s",
              "recompute_saved_s"):
        assert getattr(gt, k) == pytest.approx(getattr(wt, k), abs=1e-9), k
    for k in ("ttft_s", "tpot_s"):
        x, y = np.sort(getattr(gt, k)), np.sort(getattr(wt, k))
        assert x.shape == y.shape, k
        np.testing.assert_allclose(x, y, atol=1e-6, rtol=0, err_msg=k)
    assert gt.windows == wt.windows
    assert json.dumps(gt.to_dict()) == json.dumps(wt.to_dict())
    assert got.summary() == want.summary()


# ---------------------------------------------------------------------------
# configuration: TokenEngineConfig.from_latency over the latency models
# ---------------------------------------------------------------------------


def _latency_pair(arch, itype, source):
    """(reference, port) latency models of one (model, instance): the
    roofline, or a profiled model with measured shares."""
    jc, tc = j_config(arch), t_config(arch)
    ti = tcat.default_catalog().instance_type(itype)
    # the H100 is the port's instance type: the reference gets its figures
    ji = (jcat.InstanceType(**dataclasses.asdict(ti)) if itype == "h100"
          else jcat.default_catalog().instance_type(itype))
    if source == "roofline":
        return (jlat.LatencyModel.for_model(jc, ji),
                tlat.LatencyModel.for_model(tc, ti))
    kw = dict(mfu_prefill=0.31, mbu_decode=0.62)
    return (jlat.ProfiledLatencyModel(cfg=jc, itype=ji,
                                      n_params=float(jc.approx_params()), **kw),
            tlat.ProfiledLatencyModel(cfg=tc, itype=ti,
                                      n_params=float(tc.approx_params()), **kw))


@pytest.mark.parametrize("source", ["roofline", "profile"])
@pytest.mark.parametrize("itype", ["g5.48xlarge", "h100"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_engine_config_is_the_references(arch, itype, source):
    jlm, tlm = _latency_pair(arch, itype, source)
    for knobs in ({}, {"kv_budget_tokens": 4096, "max_batch": 8,
                       "prefill_chunk_tokens": 128, "iter_overhead_s": 0.002}):
        want = jtok.TokenEngineConfig.from_latency(
            jlm, jtok.TokenSchedulerConfig(**knobs))
        got = ttok.TokenEngineConfig.from_latency(
            tlm, ttok.TokenSchedulerConfig(**knobs))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(ttok.TokenEngineConfig)] == [
        f.name for f in dataclasses.fields(jtok.TokenEngineConfig)]


@pytest.mark.parametrize("bad", [{"slo_ttft_s": 0}, {"slo_tpot_s": -1},
                                 {"prefill_chunk_tokens": 0}, {"max_batch": 0},
                                 {"kv_budget_tokens": 0},
                                 {"iter_overhead_s": -0.1},
                                 {"goodput_window_s": 0}])
def test_scheduler_knobs_refused_as_the_reference(bad):
    with pytest.raises(ValueError) as want:
        jtok.TokenSchedulerConfig(**bad)
    with pytest.raises(ValueError) as got:
        ttok.TokenSchedulerConfig(**bad)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_token_stats_are_the_references(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 400))
    rows = []
    for k in range(n):
        arr = float(rng.uniform(0, 3000))
        first = arr + float(rng.exponential(2.0))
        rows.append(dict(req_id=k, arrival_s=arr, first_token_s=first,
                         finish_s=first + float(rng.exponential(8.0)),
                         output_tokens=int(rng.integers(1, 600)),
                         rtt_s=float(rng.choice([0.0, 0.03, 0.12]))))
    kw = dict(slo_ttft_s=2.5, slo_tpot_s=0.05, horizon_s=3000.0,
              window_s=float(rng.choice([60.0, 45.0])), n_requests=n + 7,
              n_kv_preempted_seqs=3, lost_prefill_tokens=11,
              migration_transfer_s=0.25)
    want = jmet.TokenStats.from_records(
        [jmet.TokenRecord(**r) for r in rows], **kw)
    got = tmet.TokenStats.from_records(
        [tmet.TokenRecord(**r) for r in rows], **kw)
    assert got.to_dict() == want.to_dict()
    np.testing.assert_array_equal(got.ttft_s, want.ttft_s)
    np.testing.assert_array_equal(got.tpot_s, want.tpot_s)
    for q in (50, 90, 99):
        a, b = got.ttft_pct(q), want.ttft_pct(q)
        assert a == b or (math.isnan(a) and math.isnan(b))


# ---------------------------------------------------------------------------
# the scheduler: ContinuousBatch under seeded random operations
# ---------------------------------------------------------------------------


def _engine_cfgs(seed):
    rng = np.random.default_rng(seed)
    arch = ["llama3.2-1b", "command-r-35b", "falcon-mamba-7b"][seed % 3]
    jlm, tlm = _latency_pair(arch, "g5.48xlarge", "roofline")
    knobs = dict(prefill_chunk_tokens=int(rng.choice([64, 512])),
                 kv_budget_tokens=int(rng.choice([3000, 20000])),
                 max_batch=int(rng.choice([4, 64])),
                 iter_overhead_s=float(rng.choice([0.0, 0.003])))
    return (jtok.TokenEngineConfig.from_latency(
                jlm, jtok.TokenSchedulerConfig(**knobs)),
            ttok.TokenEngineConfig.from_latency(
                tlm, ttok.TokenSchedulerConfig(**knobs)))


def _batch_state(b):
    return (b.now, list(b.queue), b.reserved_tokens, b.completed,
            b.iter_states(), b.load, b.kv_tokens, b.committed_tokens,
            b.backlog_hint_s())


def _same_states(a, b):
    # nan first-token times compare equal here
    assert json.dumps(a) == json.dumps(b)


@pytest.mark.parametrize("seed", range(8))
def test_continuous_batch_is_the_references(seed):
    """Seeded random enqueue / enqueue_migrated / advance / expire /
    remove / kill sequences: every completion, kill report and state
    snapshot equal, to the bit."""
    jcfg, tcfg = _engine_cfgs(seed)
    rng = np.random.default_rng(100 + seed)
    want, got = jbatch.ContinuousBatch(jcfg), tbatch.ContinuousBatch(tcfg)
    t, key = 0.0, 0
    n_done = 0
    for _ in range(300):
        op = rng.choice(["enqueue", "enqueue", "migrated", "advance",
                         "advance", "expire", "remove", "kill"],
                        p=[.3, .1, .07, .3, .1, .06, .04, .03])
        if op in ("enqueue", "migrated"):
            p, o = int(rng.integers(1, 3000)), int(rng.integers(1, 900))
            args = (key, p, o, t - float(rng.uniform(0, 20)), t)
            if op == "enqueue":
                rtt = float(rng.choice([0.0, 0.08]))
                a = want.enqueue(*args, rtt_s=rtt)
                b = got.enqueue(*args, rtt_s=rtt)
            else:
                pref = int(rng.integers(0, p + 1))
                dec = int(rng.integers(0, o)) if pref == p else 0
                first = t - 1.0 if dec else float("nan")
                mig = (*args, pref, dec, first)
                a, b = want.enqueue_migrated(*mig), got.enqueue_migrated(*mig)
            assert a == b
            key += 1
        elif op == "advance":
            t += float(rng.exponential(3.0 if rng.random() < .8 else 60.0))
            a, b = want.advance(t), got.advance(t)
            assert [dataclasses.asdict(c) for c in b] == [
                dataclasses.asdict(c) for c in a]
            n_done += len(a)
        elif op == "expire":
            assert got.expire_queue(t, 30.0) == want.expire_queue(t, 30.0)
        elif op == "remove":
            keys = [s[0] for s in want.iter_states()][::2]
            want.remove(keys)
            got.remove(keys)
        else:
            assert dataclasses.asdict(got.kill()) == dataclasses.asdict(
                want.kill())
        _same_states(_batch_state(got), _batch_state(want))
    assert n_done > 0


# ---------------------------------------------------------------------------
# the engines: token mode, vector and legacy, port against reference
# ---------------------------------------------------------------------------


def _mini_trace(mod, steps, seed):
    zones = ["us-west-2a", "us-west-2b", "us-east-2a"]
    zmap = {z: z[:-1] for z in zones}
    return mod.synth_correlated_trace(zones, zmap, steps=steps, dt=60.0,
                                      seed=seed, max_capacity=4, name="mini")


def port_requests(reqs):
    return [Request(arrival_s=r.arrival_s, prompt_tokens=r.prompt_tokens,
                    output_tokens=r.output_tokens, id=r.id,
                    client_region=r.client_region) for r in reqs]


def engine_runs(policy, lb, *, hours, seed, rate=0.8, arch="command-r-35b",
                migration=None, replica_model="token", workload="poisson",
                target=3):
    """The reference's vector and legacy engines and the port's, on one
    trace, tape and configuration: {name: ServingResult}."""
    from repro.migration import MigrationSpec as JMig
    from repro_torch.migration import MigrationSpec as TMig

    rate_key = "rate_per_s" if workload == "poisson" else "base_rate_per_s"
    reqs = j_make_workload(workload, **{rate_key: rate, "seed": seed}).generate(
        hours * 3600.0)
    steps = int(hours * 60) + 30
    out = {}
    for name, cls in (("ref vector", JVector), ("ref legacy", JLegacy),
                      ("port vector", TVector), ("port legacy", TLegacy)):
        ref = name.startswith("ref")
        lbs = jlb if ref else tlb
        kw = dict(itype="g5.48xlarge", timeout_s=60.0,
                  replica_model=replica_model,
                  autoscaler=(JConstant if ref else TConstant)(target),
                  lb=(lbs.RoundRobinBalancer() if lb == "rr"
                      else lbs.LeastLoadedBalancer()))
        if migration is not None:
            kw["migration"] = (JMig if ref else TMig)(**migration)
        sim = cls(_mini_trace(jtr if ref else ttr, steps, seed),
                  (j_make_policy if ref else t_make_policy)(policy),
                  reqs if ref else port_requests(reqs),
                  (j_config if ref else t_config)(arch), **kw)
        out[name] = sim.run(hours * 3600.0 + 300.0)
    return out


ENGINE_CASES = [("spothedge", "ll"), ("even_spread", "rr"),
                ("ondemand_only", "ll")]


@pytest.mark.parametrize("replica_model", ["token", "request"])
@pytest.mark.parametrize("policy,lb", ENGINE_CASES)
def test_engines_are_the_references(policy, lb, replica_model):
    """The port's vector engine and legacy simulator against both of the
    reference's, on a 0.5 h tape, token and request model."""
    runs = engine_runs(policy, lb, hours=0.5, seed=7, rate=1.2,
                       replica_model=replica_model)
    want = runs["ref vector"]
    assert want.n_completed > 0
    for name in ("port vector", "port legacy", "ref legacy"):
        assert_same_result(runs[name], want)
    if replica_model == "token":
        assert want.token.n_recorded > 0


def test_legacy_runs_a_balancer_subclass():
    """A balancer subclass runs on the legacy simulator only, as in the
    reference: the vector engine refuses it with the reference's message."""
    reqs = j_make_workload("poisson", rate_per_s=0.8, seed=5).generate(1800.0)

    class JNearest(jlb.LeastLoadedBalancer):
        def pick(self, req, now):
            return min(self._ready, key=lambda r: (self.rtt_s(req, r), r.id),
                       default=None)

    class TNearest(tlb.LeastLoadedBalancer):
        def pick(self, req, now):
            return min(self._ready, key=lambda r: (self.rtt_s(req, r), r.id),
                       default=None)

    common = dict(itype="g5.48xlarge", timeout_s=60.0, replica_model="token")
    want = JLegacy(_mini_trace(jtr, 60, 5), j_make_policy("spothedge"), reqs,
                   j_config("llama3.2-1b"), autoscaler=JConstant(3),
                   lb=JNearest(), **common).run(2100.0)
    got = TLegacy(_mini_trace(ttr, 60, 5), t_make_policy("spothedge"),
                  port_requests(reqs), t_config("llama3.2-1b"),
                  autoscaler=TConstant(3), lb=TNearest(), **common).run(2100.0)
    assert_same_result(got, want)
    with pytest.raises(TypeError) as e_port:
        TVector(_mini_trace(ttr, 60, 5), t_make_policy("spothedge"), [],
                t_config("llama3.2-1b"), lb=TNearest(), **common)
    with pytest.raises(TypeError) as e_ref:
        JVector(_mini_trace(jtr, 60, 5), j_make_policy("spothedge"), [],
                j_config("llama3.2-1b"), lb=JNearest(), **common)
    assert str(e_port.value).replace("TNearest", "X") == str(
        e_ref.value).replace("JNearest", "X")


# the token matrix's aws-1 SpotHedge token cell (benchmarks/token_engine.py)
TOKEN_CELL = {
    "name": "token-engine", "model": "command-r-35b", "trace": "aws-1",
    "resources": {"instance_type": "g5.48xlarge"},
    "replica_policy": {"name": "spothedge"},
    "autoscaler": {"kind": "constant", "target": 4},
    "workload": {"kind": "arena", "rate_per_s": 2.0, "seed": 11},
    "serving": {"slo": {"ttft_s": 10.0, "tpot_s": 0.2}},
    "sim": {"duration_hours": 2.0, "control_interval_s": 15.0,
            "timeout_s": 100.0, "concurrency": 4, "drain_s": 300.0,
            "replica_model": "token"},
}


def test_token_matrix_cell_at_full_size():
    """The 2 h cell the reference benchmark reports, through ``Service`` on
    the port's host engine: the reference's numbers."""
    want = JService(TOKEN_CELL).run()
    got = TService(TOKEN_CELL, engine="vector").run()
    assert_same_result(got, want)
    assert round(got.pct(50), 6) == 3.452665
    assert round(got.token.ttft_pct(50), 6) == 0.689862
    assert round(got.token.goodput_rps, 6) == 2.242361
    assert got.lost_kv_tokens == 2468


# ---------------------------------------------------------------------------
# the spec: serving section, replica-model sugar, the sweep axis
# ---------------------------------------------------------------------------


SERVING_SPECS = [
    {"serving": {"replica_model": "token"}},
    {"serving": {"slo": {"ttft_s": 2.5, "tpot_s": 0.05},
                 "prefill_chunk_tokens": 256, "max_batch": 32,
                 "kv_budget_tokens": 50000, "iter_overhead_s": 0.002,
                 "goodput_window_s": 30.0, "concurrency_cap": 8},
     "sim": {"replica_model": "token"}},
    {"serving": {"replica_model": "request", "prefill_chunk_tokens": 64}},
    {"sweep": {"replica_models": ["request", "token"],
               "policies": ["spothedge", "ondemand_only"]}},
]


@pytest.mark.parametrize("extra", SERVING_SPECS)
def test_serving_section_round_trips_as_the_reference(extra):
    d = {**TOKEN_CELL, **extra}
    d["sim"] = {"duration_hours": 1.0, **extra.get("sim", {})}
    want, got = j_spec_from_dict(d).to_dict(), spec_from_dict(d).to_dict()
    assert got == want
    assert spec_from_dict(got).to_dict() == got


@pytest.mark.parametrize("sweep", [
    {"replica_models": ["request", "token"]},
    {"replica_models": ["token"], "traces": ["aws-1", "gcp-1"]},
    {"policies": ["spothedge", "ondemand_only"], "traces": ["aws-1", "aws-3"],
     "replica_models": ["request", "token"]},
])
def test_replica_models_axis_gives_the_references_cells(sweep):
    d = dict(TOKEN_CELL, sweep=sweep)
    d["sim"] = dict(d["sim"], replica_model="request")
    want, got = JSuite.from_spec(d), TSuite.from_spec(d)
    assert [sc.labels for sc in got.scenarios] == [
        sc.labels for sc in want.scenarios]
    for a, b in zip(got.scenarios, want.scenarios):
        assert a.spec.to_dict() == b.spec.to_dict()
        assert a.tape_key == b.tape_key


# ---------------------------------------------------------------------------
# the mixed matrix: token cells on the host, request cells through phase B
# ---------------------------------------------------------------------------


def _mixed_spec(hours=0.5):
    d = dict(TOKEN_CELL, sweep={"policies": ["spothedge", "ondemand_only"],
                                "replica_models": ["request", "token"]})
    d["sim"] = dict(d["sim"], duration_hours=hours, replica_model="request")
    return d


def test_mixed_matrix_routes_token_cells_to_the_host():
    """``run_cells(device="cpu")`` over a mixed matrix: the request cells
    through the plain ``scenario_scan`` in one shape group, the token cells
    on the host engine, no oracle rerun, ``outputs`` and ``groups`` aligned
    with the engines, every cell the reference's."""
    d = _mixed_spec()
    cells = TSuite.from_spec(d).cells()
    token = [c.spec.sim.replica_model == "token" for c in cells]
    assert token == [False, True, False, True]
    with pytest.raises(RuntimeError, match="token-model cells"):
        cells[1].engine.record_schedule()
    outs, groups = [], []
    got = teng.run_cells([c.engine for c in cells],
                         [c.duration_s for c in cells], outputs=outs,
                         groups=groups, device="cpu")
    assert groups == [[0, 2]]
    assert [o is None for o in outs] == token
    assert [c.engine.ran_on_host for c in cells] == token
    assert not any(c.engine.fell_back for c in cells)
    assert [c.engine.schedule is None for c in cells] == token
    want = JSuite.from_spec(d)
    for cell, res, sc in zip(cells, got, want.scenarios):
        assert cell.labels == sc.labels
        ref = JService(dataclasses.replace(sc.spec)).run()
        assert_same_result(res, ref)


def test_suite_reports_token_cells_on_the_host(tmp_path):
    d = _mixed_spec()
    got = TSuite.from_spec(d).run(device="cpu", save_to=str(tmp_path))
    want = JSuite.from_spec(d).run()
    assert (got.shape_groups, got.oracle_reruns) == (1, [])
    assert got.host_token_cells == ["spothedge/aws-1/arena/11/token",
                                    "ondemand_only/aws-1/arena/11/token"]
    skip = {"wall_s", "obs_event_counts", "metrics", "obs_windows",
            "slo_burn", "n_spans"}
    for a, b in zip(got.cells, want.cells):
        da, db = a.to_dict(), b.to_dict()
        assert set(da) - skip == set(db) - skip
        for k in set(db) - skip:
            if isinstance(db[k], float):
                assert da[k] == pytest.approx(db[k], abs=1e-6, nan_ok=True), k
            else:
                assert da[k] == db[k], k
    saved = json.loads((tmp_path / "scenario_token-engine.json").read_text())
    assert saved["host_token_cells"] == got.host_token_cells
    assert "2 token cell(s) on the host engine" in got.summary()


def test_service_runs_a_token_spec_on_each_engine():
    """``Service`` under ``jax`` (the token cell on the host engine, so no
    lane and no rerun), ``vector`` and ``legacy``: one result."""
    d = dict(TOKEN_CELL, sim=dict(TOKEN_CELL["sim"], duration_hours=0.5))
    want = JService(d).run()
    svc = TService(d)
    assert svc.spec.sim.engine == "jax"
    assert_same_result(svc.run(device="cpu"), want)
    st = svc.status()
    assert st["token_on_host"] and not st["oracle_rerun"]
    for engine in ("vector", "legacy"):
        assert_same_result(TService(d, engine=engine).run(), want)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["vector", "legacy", "jax"])
def test_cli_runs_the_token_model(tmp_path, capsys, engine):
    d = dict(TOKEN_CELL, sim=dict(TOKEN_CELL["sim"], duration_hours=0.5,
                                  replica_model="request"))
    path = tmp_path / "s.json"
    path.write_text(json.dumps(d))
    argv = ["--spec", str(path), "--replica-model", "token", "--status",
            "--engine", engine]
    if engine == "jax":
        argv += ["--device", "cpu"]
    assert tserve.main(argv) == 0
    out = capsys.readouterr().out
    status = json.loads(out[out.index("\n{") + 1:])
    want = JService(dict(d, sim=dict(d["sim"], replica_model="token"))).run()
    assert status["n_completed"] == want.n_completed
    assert status["p50_s"] == pytest.approx(want.pct(50), abs=1e-6)
    assert f"ttft_p50={want.token.ttft_pct(50):5.2f}s" in out
    with pytest.raises(SystemExit) as e:
        tserve.main(["--spec", str(path), "--engine", "legacy", "--device",
                     "cuda"])
    assert e.value.code == 2
