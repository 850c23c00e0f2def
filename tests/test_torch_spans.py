"""The port's request spans held against the reference's on the CPU: the
tiling invariant, the sampling hash, token + migration spans byte for byte,
the two-phase engine's spans rebuilt from ``scenario_scan``'s span
timelines, and the pinned burn alert.

The counterpart of ``tests/test_spans.py``: the fixture is its 1 h ``mini``
scenario (spothedge, 3 replicas, Poisson 0.8/s, trace_sample 1.0).
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.obs as jobs  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro.migration.config import MigrationSpec as JMigration  # noqa: E402
from repro.obs.spans import SpanCollector as JCollector  # noqa: E402
from repro.obs.spans import span_sampled as j_span_sampled  # noqa: E402
from repro.serving.engine import VectorizedServingEngine as JVector  # noqa: E402
from repro.serving.sim import ServingSimulator as JLegacy  # noqa: E402
from repro.serving.token import TokenSchedulerConfig as JTokenKnobs  # noqa: E402
from repro_torch.migration.config import MigrationSpec as TMigration  # noqa: E402
from repro_torch.obs.spans import SpanCollector  # noqa: E402
from repro_torch.obs.spans import span_sampled  # noqa: E402
from repro_torch.serving.engine import VectorizedServingEngine as TVector  # noqa: E402
from repro_torch.serving.sim import ServingSimulator as TLegacy  # noqa: E402
from repro_torch.serving.token import TokenSchedulerConfig as TTokenKnobs  # noqa: E402
from repro_torch.serving.torchengine.engine import (  # noqa: E402
    TorchServingEngine,
    reconstruct_spans,
    run_cells,
)
from test_torch_obs import run_fixture  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - environment-dependent
    HAVE_HYPOTHESIS = False

HOURS = 1.0


def check_span_tiling(records):
    """Every span record tiles [arrival, last close] contiguously."""
    assert records == sorted(records, key=lambda r: r["ordinal"])
    for rec in records:
        assert rec["schema"] == 1 and rec["event"] == "span"
        assert rec["attempts"] >= 1
        assert rec["outcome"] in ("ok", "timeout", "rejected", "unresolved")
        segs = rec["segments"]
        assert segs, rec
        assert segs[0]["t0_s"] == rec["arrival_s"], rec
        prev_end = None
        for seg in segs:
            assert seg["t1_s"] >= seg["t0_s"], rec
            if prev_end is not None:
                assert seg["t0_s"] == prev_end, rec
            prev_end = seg["t1_s"]


def served_once(records):
    """The reference's filter (tests/test_spans.py): one attempt, served,
    outcome ``ok`` or ``timeout``: the spans the card's kernel resolves."""
    return {r["ordinal"]: r for r in records
            if r["attempts"] == 1
            and any(s["name"] == "service" for s in r["segments"])
            and r["outcome"] in ("ok", "timeout")}


def assert_card_spans(card, host):
    """The card's spans equal the host's after the filter.  A request the
    host retried shows its last attempt on the card (one attempt, no
    preempt cut), so those ordinals are the only extra ones."""
    want = served_once(host)
    got = {r["ordinal"]: r for r in card}
    for o, rec in want.items():
        assert json.dumps(got.get(o), sort_keys=True) == \
            json.dumps(rec, sort_keys=True), o
    retried = {r["ordinal"] for r in host if r["attempts"] > 1}
    assert set(got) - set(want) <= retried


#: the tap language of the random replay: any call order keeps the tiling
_OPS = (
    "dispatch", "start", "finish", "expire", "reject", "preempt",
    "token_join", "token_chunk", "token_prefill_done", "finish_token",
    "migrate", "migrate_arrive",
)


def replay_collector(cls, ops):
    """Replay (op code, dt) pairs into a one-request collector of ``cls``;
    returns its records."""
    col = cls(1.0, [SimpleNamespace(id=0, arrival_s=0.0)])
    t = 0.0
    for code, dt in ops:
        t += dt
        op = _OPS[code % len(_OPS)]
        if op == "dispatch":
            col.dispatch(0, t, 1, 0.01, 0.0, token=bool(code % 2))
        elif op == "start":
            col.start(0, t)
        elif op == "finish":
            col.finish(0, t, "ok", t)
        elif op == "expire":
            col.expire(0, t, 0.0)
        elif op == "reject":
            col.reject(0, t)
        elif op == "preempt":
            col.preempt(0, t)
        elif op == "token_join":
            col.token_join(0, t, prefilling=bool(code % 2))
        elif op == "token_chunk":
            col.token_chunk(0, 7)
        elif op == "token_prefill_done":
            col.token_prefill_done(0, t)
        elif op == "finish_token":
            col.finish_token(0, t, t, 0.0, "ok", t)
        elif op == "migrate":
            col.migrate(0, t, to_replica=2, transfer_s=0.5, plan_t=t)
        elif op == "migrate_arrive":
            col.migrate_arrive(0, t, replica=2)
    col.finalize(t + 1.0)
    return col.records()


def _check_replay(ops):
    got = replay_collector(SpanCollector, ops)
    check_span_tiling(got)
    assert got == replay_collector(JCollector, ops)


def test_span_tiling_replay_fixed_sample():
    rng = np.random.default_rng(0)
    for _ in range(100):
        n = int(rng.integers(0, 40))
        _check_replay([(int(rng.integers(0, len(_OPS))),
                         float(rng.uniform(0, 30))) for _ in range(n)])


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
def test_span_tiling_hypothesis():
    @settings(max_examples=80, deadline=None)
    @given(st.lists(st.tuples(
        st.integers(0, len(_OPS) - 1),
        st.floats(0.0, 30.0, allow_nan=False, allow_infinity=False)),
        max_size=40))
    def prop(ops):
        _check_replay(ops)

    prop()


@pytest.mark.parametrize("rate", [0.0, 0.01, 0.25, 0.999, 1.0])
def test_span_sampled_is_the_references(rate):
    picks = [span_sampled(o, rate) for o in range(5000)]
    assert picks == [j_span_sampled(o, rate) for o in range(5000)]
    if 0.0 < rate < 1.0:
        assert abs(sum(picks) / len(picks) - rate) < 0.1


# ---------------------------------------------------------------------------
# engine runs


@pytest.fixture(scope="module")
def token_migration_runs():
    kw = dict(replica_model="token", hours=HOURS, trace_sample=1.0)
    return (
        run_fixture(TLegacy, migration=TMigration(
            enabled=True, drain_threshold_s=2.0), **kw),
        run_fixture(TVector, migration=TMigration(
            enabled=True, drain_threshold_s=2.0), **kw),
        run_fixture(JVector, migration=JMigration(
            enabled=True, drain_threshold_s=2.0), **kw),
    )


def test_span_tiling_token_migration(token_migration_runs):
    _, vector, _ = token_migration_runs
    recs = vector.obs.span_records()
    assert recs
    check_span_tiling(recs)
    kinds = {s["name"] for r in recs for s in r["segments"]}
    assert {"queue", "admit", "prefill", "decode"} <= kinds
    if vector.token.n_migrated_seqs:
        assert "transfer" in kinds


def test_token_migration_spans_are_the_references(token_migration_runs):
    legacy, vector, ref = token_migration_runs
    want = jobs.dumps_jsonl(ref.obs.span_records())
    assert want
    assert tobs.dumps_jsonl(legacy.obs.span_records()) == want
    assert tobs.dumps_jsonl(vector.obs.span_records()) == want


def test_sampling_subset_matches_hash():
    res = run_fixture(TVector, trace_sample=0.25, hours=HOURS)
    recs = res.obs.span_records()
    assert recs and all(span_sampled(r["ordinal"], 0.25) for r in recs)
    want = run_fixture(JVector, trace_sample=0.25, hours=HOURS)
    assert tobs.dumps_jsonl(recs) == \
        jobs.dumps_jsonl(want.obs.span_records())


# ---------------------------------------------------------------------------
# the card engine's spans, rebuilt from scenario_scan's plain version


@pytest.mark.parametrize("hours", [1.0, 2.0], ids=["1h", "2h"])
def test_card_spans_are_the_references_after_the_filter(hours):
    ref = run_fixture(JVector, trace_sample=1.0, hours=hours)
    card = run_fixture(TorchServingEngine, trace_sample=1.0, hours=hours,
                       device="cpu")
    sj, sc = ref.obs.span_records(), card.obs.span_records()
    assert sj and sc
    check_span_tiling(sc)
    assert_card_spans(sc, sj)
    if hours == 1.0:
        # the reference's own case: no request retried, the sets coincide
        assert set(r["ordinal"] for r in sc) == set(served_once(sj))
    assert (card.n_completed, card.n_failed) == (ref.n_completed,
                                                 ref.n_failed)


def test_card_engine_carries_timelines_exactly_when_it_samples():
    """``trace_on`` follows the recorder: off at detail ``off`` or a zero
    sample rate, on otherwise; a sampling cell whose outputs lack the
    timelines raises."""
    engines = {}
    for name, kw in (("off", dict(detail="off")),
                     ("zero", dict(trace_sample=0.0)),
                     ("on", dict(trace_sample=0.01))):
        res = run_fixture(TorchServingEngine, hours=0.25, device="cpu", **kw)
        engines[name] = res
    assert engines["off"].obs is None
    assert engines["zero"].obs.span_records() == []
    assert engines["on"].obs.span_records()
    eng = _fixture_engine(trace_sample=1.0)
    sched = eng.record_schedule(0.25 * 3600.0 + 600.0)
    assert sched.trace_on
    outs = []
    run_cells([eng], [0.25 * 3600.0 + 600.0], outputs=outs, device="cpu")
    lane = {k: v for k, v in outs[0].items() if k != "disp_t"}
    with pytest.raises(RuntimeError, match="span timelines"):
        reconstruct_spans(eng, sched, lane)
    quiet = _fixture_engine(detail="off")
    assert not quiet.record_schedule(0.25 * 3600.0 + 600.0).trace_on


def _fixture_engine(**obs):
    from test_torch_obs import _mini_trace, _requests
    import repro_torch.cluster.traces as ttr
    from repro_torch.configs import get_config
    from repro_torch.core.autoscaler import ConstantTarget
    from repro_torch.core.policy import make_policy

    return TorchServingEngine(
        _mini_trace(ttr, 0.25), make_policy("spothedge"), _requests(0.25)[1],
        get_config("llama3.2-1b"), itype="g5.48xlarge",
        autoscaler=ConstantTarget(3), timeout_s=60.0, concurrency=2,
        workload_name="poisson", obs=tobs.ObsRecorder(**obs))


# ---------------------------------------------------------------------------
# the burn alert


def test_burn_alert_fires_pinned():
    kw = dict(replica_model="token", hours=HOURS, trace_sample=1.0)
    res = run_fixture(TVector, slo_burn=tobs.SLOBurnConfig(),
                      token_scheduler=TTokenKnobs(slo_ttft_s=0.2,
                                                  slo_tpot_s=0.0008), **kw)
    ref = run_fixture(JVector, slo_burn=jobs.SLOBurnConfig(),
                      token_scheduler=JTokenKnobs(slo_ttft_s=0.2,
                                                  slo_tpot_s=0.0008), **kw)
    burns = [e.to_record() for e in res.obs.events if e.KIND == "slo_burn"]
    assert burns
    alerting = [r for r in burns if r.get("alerting")]
    assert alerting, "unattainable SLO targets must trip the alert"
    assert {n for r in alerting for n in r["alerting"]} & {"ttft", "tpot"}
    summ = res.obs.slo_burn_summary()
    assert summ == ref.obs.slo_burn_summary()
    assert summ["alert_windows"] == len(alerting)
    assert summ["windows"] == len(burns)
    assert tobs.dumps_jsonl(res.obs.events) == \
        jobs.dumps_jsonl(ref.obs.events)
    assert tobs.burn_table(res.obs.records()) == \
        jobs.burn_table(ref.obs.records())
