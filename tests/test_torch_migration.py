"""The port's grace-period KV migration against the reference's, on the CPU.

The port keeps its own copies of ``MigrationSpec``, the cost model
(``compression_factor``, ``kv_transfer_bytes`` / ``_s``, ``plan_reshard``
and its ``RemeshPlan``), the planner (``plan_preemption``), the runtime
(``MigrationRuntime``) and both engines' warned-preemption paths.  Each is
held here against the reference on the same inputs: the pure parts and the
runtime exactly, the engines at tentpole part a's tolerances
(``tests/test_torch_token.py``'s ``assert_same_result``).  int8 KV
quantisation itself (the reference's ``distributed/compression.py``) is not
ported: migration uses only its byte factor.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.cluster.catalog as jcat  # noqa: E402
from repro import migration as jmig  # noqa: E402
from repro.experiments import ScenarioSuite as JSuite  # noqa: E402
from repro.serving.token import batch as jbatch  # noqa: E402
from repro.serving.token import config as jtok  # noqa: E402
from repro.service import spec_from_dict as j_spec_from_dict  # noqa: E402

from repro_torch import migration as tmig  # noqa: E402
from repro_torch.experiments import ScenarioSuite as TSuite  # noqa: E402
from repro_torch.serving.token import batch as tbatch  # noqa: E402
from repro_torch.serving.token import config as ttok  # noqa: E402
from repro_torch.service import SpecError, spec_from_dict  # noqa: E402
from test_torch_token import (  # noqa: E402
    ENGINE_CASES,
    TOKEN_CELL,
    _latency_pair,
    assert_same_result,
    engine_runs,
)

# ---------------------------------------------------------------------------
# config and cost model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {}, {"enabled": True, "compression": "int8", "drain_threshold_s": 2.0},
    {"enabled": True, "bandwidth_gbps": 2.5, "migrate_threshold_tokens": 64,
     "link_latency_s": 0.0},
])
def test_migration_spec_is_the_references(kw):
    got, want = tmig.MigrationSpec(**kw), jmig.MigrationSpec(**kw)
    assert got.to_dict() == want.to_dict()
    assert [f.name for f in dataclasses.fields(got)] == [
        f.name for f in dataclasses.fields(want)]


@pytest.mark.parametrize("bad", [{"compression": "zstd"},
                                 {"bandwidth_gbps": 0.0},
                                 {"drain_threshold_s": -1.0},
                                 {"migrate_threshold_tokens": -1},
                                 {"link_latency_s": -0.1}])
def test_migration_spec_refusals_are_the_references(bad):
    with pytest.raises(ValueError) as want:
        jmig.MigrationSpec(**bad)
    with pytest.raises(ValueError) as got:
        tmig.MigrationSpec(**bad)
    assert str(got.value) == str(want.value)


def test_transfer_cost_is_the_references():
    for mode in ("none", "int8"):
        assert tmig.compression_factor(mode) == jmig.compression_factor(mode)
        for tokens in (0, 1, 777, 131072):
            for per_tok in (0.0, 32768.0, 163840.0):
                nb = tmig.kv_transfer_bytes(tokens, per_tok, mode)
                assert nb == jmig.kv_transfer_bytes(tokens, per_tok, mode)
                for bw in (0.0, 1.25e9, 12.5e9):
                    for lat in (0.0, 0.05):
                        assert tmig.kv_transfer_s(nb, bw, lat) == \
                            jmig.kv_transfer_s(nb, bw, lat)
    with pytest.raises(ValueError, match="zstd"):
        tmig.compression_factor("zstd")
    assert tmig.INT8_KV_FACTOR == jmig.INT8_KV_FACTOR


@pytest.mark.parametrize("mesh,names,surv,axis", [
    ((8, 4), ("data", "model"), 24, "data"),
    ((8, 4), ("data", "model"), 17, "data"),
    ((2, 8), ("data", "model"), 9, "model"),
    ((4, 4), ("data", "model"), 3, "data"),
    ((16,), ("data",), 16, "data"),
])
def test_plan_reshard_is_the_references(mesh, names, surv, axis):
    kw = dict(kv_resident_bytes=3.2e9, weight_bytes=7e10,
              bandwidth_bytes_per_s=12.5e9, link_latency_s=0.05,
              shrink_axis=axis)
    got = tmig.plan_reshard(mesh, names, surv, **kw)
    want = jmig.plan_reshard(mesh, names, surv, **kw)
    if want is None:
        assert got is None
        return
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.new_chip_count, got.total_s) == (want.new_chip_count,
                                                 want.total_s)
    plan = got.to_remesh_plan()
    assert isinstance(plan, tmig.RemeshPlan)
    ref = want.to_remesh_plan()
    assert dataclasses.asdict(plan) == {
        f: getattr(ref, f) for f in ("old_shape", "new_shape", "axis_names",
                                     "dropped_chips")}


@pytest.mark.parametrize("args,match", [
    (((4, 2), ("data",), 4), "mismatch"),
    (((4, 2), ("data", "model"), 4, "pipe"), "no axis"),
])
def test_plan_reshard_refusals_are_the_references(args, match):
    shape, names, surv, *axis = args
    kw = dict(bandwidth_bytes_per_s=1e9)
    if axis:
        kw["shrink_axis"] = axis[0]
    for mod in (tmig, jmig):
        with pytest.raises(ValueError, match=match):
            mod.plan_reshard(shape, names, surv, **kw)


# ---------------------------------------------------------------------------
# the planner on seeded random sequences and targets
# ---------------------------------------------------------------------------


def _engine_cfg_pair(arch="command-r-35b"):
    jlm, tlm = _latency_pair(arch, "g5.48xlarge", "roofline")
    return (jtok.TokenEngineConfig.from_latency(jlm),
            ttok.TokenEngineConfig.from_latency(tlm))


def _decision(d):
    s = d.state
    return (s.key, d.action, d.target_rid, d.transfer_s, d.resume_offset_s)


@pytest.mark.parametrize("seed", range(10))
def test_plan_preemption_is_the_references(seed):
    rng = np.random.default_rng(seed)
    jcfg, tcfg = _engine_cfg_pair()
    rows = []
    for k in range(int(rng.integers(0, 40))):
        p, o = int(rng.integers(1, 4000)), int(rng.integers(1, 1200))
        pref = int(rng.integers(0, p + 1))
        dec = int(rng.integers(0, o)) if pref == p else 0
        rows.append((k, p, o, pref, dec, float(rng.uniform(0, 500)),
                     float(rng.uniform(0, 500)),
                     float(rng.uniform(0, 500)) if dec else float("nan")))
    targets = [(int(rid), int(rng.integers(0, 60000)),
                float(rng.choice([1.25e9, 3.125e9, 12.5e9])))
               for rid in rng.permutation(6)[: int(rng.integers(0, 6))]]
    spec_kw = dict(enabled=True,
                   compression=str(rng.choice(["none", "int8"])),
                   drain_threshold_s=float(rng.choice([0.0, 2.0, 30.0])),
                   migrate_threshold_tokens=int(rng.choice([1, 256])))
    grace = float(rng.choice([5.0, 30.0, 120.0]))
    want = jmig.plan_preemption(
        [jmig.SeqState(*r) for r in rows],
        [jmig.TargetInfo(*t) for t in targets], grace, jcfg,
        jmig.MigrationSpec(**spec_kw))
    got_targets = [tmig.TargetInfo(*t) for t in targets]
    got = tmig.plan_preemption(
        [tmig.SeqState(*r) for r in rows], got_targets, grace, tcfg,
        tmig.MigrationSpec(**spec_kw))
    assert [_decision(d) for d in got] == [_decision(d) for d in want]
    ref_targets = [jmig.TargetInfo(*t) for t in targets]
    jmig.plan_preemption([jmig.SeqState(*r) for r in rows], ref_targets,
                         grace, jcfg, jmig.MigrationSpec(**spec_kw))
    assert [t.headroom_tokens for t in got_targets] == [
        t.headroom_tokens for t in ref_targets]


# ---------------------------------------------------------------------------
# the runtime on seeded random batches
# ---------------------------------------------------------------------------


class _Inst:
    """The fields of an instance the runtime reads."""

    def __init__(self, zone):
        z = jcat.default_catalog().zone(zone)
        self.zone, self.region, self.cloud = zone, z.region, z.cloud


ZONES = ["us-west-2a", "us-west-2b", "us-east-2a", "us-central1-a",
         "eu-central-1a"]


def _fill(batches, rng, n, t):
    """The same random work into a reference and a port batch, advanced
    to ``t``."""
    for k in range(n):
        p, o = int(rng.integers(1, 3000)), int(rng.integers(1, 1500))
        enq = float(rng.uniform(0, t / 2))
        for b in batches:
            b.enqueue(k, p, o, enq, enq)
    for b in batches:
        b.advance(t)


@pytest.mark.parametrize("seed", range(6))
def test_runtime_is_the_references(seed):
    """One warned preemption: the same plan carried out on the same
    batches, the drained and migrated sequences, the kill report, the
    savings and the targets' queues equal."""
    rng = np.random.default_rng(seed)
    jcfg, tcfg = _engine_cfg_pair()
    spec_kw = dict(enabled=True, compression=str(rng.choice(["none", "int8"])),
                   drain_threshold_s=float(rng.choice([0.0, 2.0, 30.0])))
    if rng.random() < 0.3:
        spec_kw["bandwidth_gbps"] = 2.5
    j_src, t_src = jbatch.ContinuousBatch(jcfg), tbatch.ContinuousBatch(tcfg)
    _fill((j_src, t_src), rng, int(rng.integers(1, 30)),
          float(rng.uniform(5, 60)))
    zones = [ZONES[int(z)] for z in rng.permutation(len(ZONES))]
    j_tg, t_tg = [], []
    for rid, zone in enumerate(zones[1:]):
        jb, tb = jbatch.ContinuousBatch(jcfg), tbatch.ContinuousBatch(tcfg)
        _fill((jb, tb), rng, int(rng.integers(0, 20)), 30.0)
        j_tg.append((10 + rid, jb, _Inst(zone)))
        t_tg.append((10 + rid, tb, _Inst(zone)))
    now, grace = 60.0, float(rng.choice([5.0, 30.0, 120.0]))
    want = jmig.MigrationRuntime(jmig.MigrationSpec(**spec_kw), jcfg
                                 ).execute_preemption(
        j_src, _Inst(zones[0]), j_tg, now, grace)
    got = tmig.MigrationRuntime(tmig.MigrationSpec(**spec_kw), tcfg
                                ).execute_preemption(
        t_src, _Inst(zones[0]), t_tg, now, grace)
    # json: a sequence with no first token yet carries nan
    assert json.dumps([dataclasses.asdict(s) for s in got.drained]) == \
        json.dumps([dataclasses.asdict(s) for s in want.drained])
    assert json.dumps([(dataclasses.asdict(m.state), m.target_rid,
                        m.transfer_s, m.resume_s) for m in got.migrated]) == \
        json.dumps([(dataclasses.asdict(m.state), m.target_rid, m.transfer_s,
                     m.resume_s) for m in want.migrated])
    assert dataclasses.asdict(got.kill_report) == dataclasses.asdict(
        want.kill_report)
    for f in ("migrated_kv_tokens", "saved_prefill_tokens",
              "saved_decode_tokens", "transfer_s_total", "recompute_saved_s",
              "n_drained", "n_migrated"):
        assert getattr(got, f) == getattr(want, f), f
    for (_, jb, _), (_, tb, _) in zip(j_tg, t_tg):
        assert json.dumps(list(tb.queue)) == json.dumps(list(jb.queue))
        assert tb.committed_tokens == jb.committed_tokens
        # the migrated sequences resume with their KV on the targets
        assert [dataclasses.asdict(c) for c in tb.advance(900.0)] == [
            dataclasses.asdict(c) for c in jb.advance(900.0)]
    assert t_src.load == j_src.load == 0


def test_runtime_refuses_a_disabled_spec():
    _, tcfg = _engine_cfg_pair()
    with pytest.raises(ValueError, match="enabled"):
        tmig.MigrationRuntime(tmig.MigrationSpec(), tcfg)


# ---------------------------------------------------------------------------
# the engines with migration on
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mig", [
    dict(enabled=True, compression="int8", drain_threshold_s=2.0),
    dict(enabled=True, compression="none", drain_threshold_s=0.0,
         bandwidth_gbps=25.0),
], ids=["int8-drain2", "none-drain0-25gbps"])
@pytest.mark.parametrize("policy,lb", ENGINE_CASES)
def test_engines_with_migration_are_the_references(policy, lb, mig):
    """The port's vector engine and legacy simulator with migration on,
    against both of the reference's, on a 0.5 h tape."""
    runs = engine_runs(policy, lb, hours=0.5, seed=5, rate=1.5, migration=mig)
    want = runs["ref vector"]
    for name in ("port vector", "port legacy", "ref legacy"):
        assert_same_result(runs[name], want)


def test_migration_paths_are_exercised():
    """The spot policies' cases above do migrate: sequences drain and move,
    and less KV is lost than with migration off."""
    mig = dict(enabled=True, compression="int8", drain_threshold_s=2.0)
    on = engine_runs("spothedge", "ll", hours=0.5, seed=5, rate=1.5,
                     migration=mig)
    off = engine_runs("spothedge", "ll", hours=0.5, seed=5, rate=1.5)
    got_on, got_off = on["port vector"], off["port vector"]
    assert got_on.n_preemptions > 0
    assert got_on.token.n_migrated_seqs > 0
    assert got_on.token.n_drained_seqs > 0
    assert got_on.token.migrated_kv_tokens > 0
    assert got_on.lost_kv_tokens < got_off.lost_kv_tokens
    assert_same_result(got_off, off["ref vector"])


def test_engines_refuse_migration_without_the_token_model():
    from repro_torch.serving.engine import VectorizedServingEngine
    from repro_torch.serving.sim import ServingSimulator

    from test_torch_token import _mini_trace, t_config, t_make_policy, ttr
    for cls in (VectorizedServingEngine, ServingSimulator):
        with pytest.raises(ValueError, match="replica_model='token'"):
            cls(_mini_trace(ttr, 10, 0), t_make_policy("spothedge"), [],
                t_config("llama3.2-1b"), itype="g5.48xlarge",
                migration=tmig.MigrationSpec(enabled=True))


# ---------------------------------------------------------------------------
# the spec, the loader and the sweep axis
# ---------------------------------------------------------------------------


MIG_SPECS = [
    {"serving": {"replica_model": "token"}, "migration": {"enabled": False}},
    {"serving": {"replica_model": "token"},
     "migration": {"enabled": True, "compression": "int8",
                   "drain_threshold_s": 2.0, "bandwidth_gbps": 10.0}},
    {"migration": {"enabled": True},
     "sweep": {"replica_models": ["request", "token"]}},
    {"serving": {"replica_model": "token"},
     "sweep": {"migration": [False, True,
                             {"enabled": True, "compression": "int8"}]}},
]


@pytest.mark.parametrize("extra", MIG_SPECS)
def test_migration_section_round_trips_as_the_reference(extra):
    d = {**TOKEN_CELL, **extra}
    d["sim"] = {"duration_hours": 1.0}
    got, want = spec_from_dict(d), j_spec_from_dict(d)
    assert got.to_dict() == want.to_dict()
    assert spec_from_dict(got.to_dict()).to_dict() == got.to_dict()
    if "migration" in extra:
        assert isinstance(got.migration, tmig.MigrationSpec)


@pytest.mark.parametrize("extra,match", [
    ({"migration": {"compression": "zstd"}}, "migration: migration.compression"),
    ({"migration": {"drain_threshold_s": -1}}, "migration.drain_threshold_s"),
    ({"migration": {"enabled": True, "window": 3}}, "unknown keys"),
    ({"migration": {"enabled": True}}, "requires the token-level engine"),
    ({"serving": {"replica_model": "token"},
      "sweep": {"migration": [{"compression": "lz4"}]}},
     "sweep.migration entry"),
    ({"serving": {"replica_model": "token"}, "sweep": {"migration": ["on"]}},
     "sweep.migration entries"),
])
def test_loader_refuses_bad_migration_knobs_as_spec_errors(extra, match):
    d = {**TOKEN_CELL, **extra}
    d["sim"] = {"duration_hours": 1.0}
    with pytest.raises(SpecError, match=match):
        spec_from_dict(d)


@pytest.mark.parametrize("extra", [
    {"serving": {"replica_model": "token"},
     "migration": {"enabled": False, "drain_threshold_s": 2.0},
     "sweep": {"migration": [False, True]}},
    {"sweep": {"replica_models": ["request", "token"],
               "migration": [False, True]}},
    {"migration": {"enabled": True, "compression": "int8"},
     "sweep": {"replica_models": ["request", "token"],
               "policies": ["spothedge", "ondemand_only"]}},
    {"serving": {"replica_model": "token"},
     "sweep": {"migration": [True, {"enabled": False}],
               "traces": ["aws-1", "aws-3"]}},
])
def test_migration_axis_gives_the_references_cells(extra):
    d = {**TOKEN_CELL, **extra}
    d["sim"] = {"duration_hours": 1.0}
    want, got = JSuite.from_spec(d), TSuite.from_spec(d)
    assert [sc.labels for sc in got.scenarios] == [
        sc.labels for sc in want.scenarios]
    for a, b in zip(got.scenarios, want.scenarios):
        assert a.spec.to_dict() == b.spec.to_dict()
        assert a.tape_key == b.tape_key
