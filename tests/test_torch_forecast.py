"""The port's spot-availability forecasters against the reference, on the
CPU.

``repro_torch.forecast`` is the port's own copy of ``repro.forecast``: the
registry, the persistence / EWMA / regional-Markov estimators and the
backtest harness with its CLI, plus the trace statistics CLI, the
``forecast:`` spec section and the suite's ``forecasters`` axis.  Each is
held here against the reference on the same inputs: seeded observation
streams and controller events (numpy), the four named traces, the twelve
committed backtest reports under ``artifacts/forecast/``.  Tolerance:
none; predictions, scores and reports are the reference's to the bit, and
error messages word for word.
"""

import dataclasses
import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.cluster.traces as jtr  # noqa: E402
import repro.forecast as jfc  # noqa: E402
import repro.forecast.backtest as jbt  # noqa: E402
import repro.service.spec as jspec  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro.experiments import ScenarioSuite as JSuite  # noqa: E402
from repro.service import spec_from_dict as j_spec_from_dict  # noqa: E402

import repro_torch.cluster.traces as ttr  # noqa: E402
import repro_torch.forecast as tfc  # noqa: E402
import repro_torch.forecast.backtest as tbt  # noqa: E402
import repro_torch.service.spec as tspec  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.experiments import ScenarioSuite as TSuite  # noqa: E402
from repro_torch.service import SpecError  # noqa: E402
from repro_torch.service import spec_from_dict as t_spec_from_dict  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
FORECASTERS = ("persistence", "ewma", "markov")
TRACES = ("aws-1", "aws-2", "aws-3", "gcp-1")


def _raised(fn, exc=Exception):
    """The exception ``fn`` raises, as (type name, message)."""
    with pytest.raises(exc) as e:
        fn()
    return type(e.value).__name__, str(e.value)


# ---------------------------------------------------------------------------
# the registry and the contract's checks
# ---------------------------------------------------------------------------


def test_forecaster_registry_is_the_references():
    assert tfc.registered_forecasters() == jfc.registered_forecasters() == \
        sorted(FORECASTERS)
    for name in FORECASTERS:
        got, want = tfc.make_forecaster(name), jfc.make_forecaster(name)
        assert type(got).__name__ == type(want).__name__
        assert got.name == want.name == name
    assert _raised(lambda: tfc.make_forecaster("oracle"), KeyError) == \
        _raised(lambda: jfc.make_forecaster("oracle"), KeyError)


def _short_trace(mod):
    return mod.SpotTrace(zones=("us-west-2a",), cap=np.ones((4, 1), int),
                         dt=60.0, name="short")


# each case: what a package does with a bad argument; the port must raise
# the reference's exception, word for word
BAD_ARGS = [
    ("persistence prior", lambda m: m.make_forecaster("persistence",
                                                      prior=1.5)),
    ("ewma half-life", lambda m: m.make_forecaster("ewma", halflife_s=0)),
    ("ewma mix half-life", lambda m: m.make_forecaster(
        "ewma", mix_halflife_s=-1.0)),
    ("ewma prior", lambda m: m.make_forecaster("ewma", prior=-0.1)),
    ("markov smoothing", lambda m: m.make_forecaster("markov", smoothing=0)),
    ("unknown kwarg", lambda m: m.make_forecaster("markov", halflife_s=1.0)),
    ("zone forecast", lambda m: m.ZoneForecast(zone="z", p_available=1.5,
                                               p_preempt=0.0)),
    ("horizon", lambda m: m.make_forecaster("ewma").predict(0.0, 0.0)),
    ("backtest horizons", lambda m: m.run_backtest("gcp-1", "ewma",
                                                   horizons=[0, 5])),
]


@pytest.mark.parametrize("call", [b[1] for b in BAD_ARGS],
                         ids=[b[0] for b in BAD_ARGS])
def test_bad_arguments_raise_the_references_errors(call):
    assert _raised(lambda: call(tfc)) == _raised(lambda: call(jfc))


def test_too_short_trace_raises_the_references_error():
    assert _raised(lambda: tfc.run_backtest(_short_trace(ttr), "markov")) == \
        _raised(lambda: jfc.run_backtest(_short_trace(jtr), "markov"))


# ---------------------------------------------------------------------------
# predictions on seeded observation streams and event sequences
# ---------------------------------------------------------------------------

# two regions of the catalog, one zone it does not know (its region comes
# from infer_region), and one zone only the events name
ZONES = ["us-west-2a", "us-west-2b", "us-west-2c", "us-east-1a",
         "us-east-1b", "edge-7x"]
KNOWN_REGIONS = {z: z[:-1] for z in ZONES[:5]}
KINDS = ("PREEMPTION", "LAUNCH_FAILURE", "READY", "WARNING")


def _stream(seed, n=500):
    """A seeded history: (now, row) observations, partial rows included,
    and (now, kind, zone) controller events; same-instant duplicates,
    stale gaps and regional crunches are all in it."""
    rng = np.random.default_rng(seed)
    now, crunch, out = 0.0, False, []
    for _ in range(n):
        now += float(rng.choice([0.0, 15.0, 60.0, 60.0, 60.0, 240.0]))
        if rng.random() < 0.05:
            crunch = not crunch
        if rng.random() < 0.6:
            zones = [z for z in ZONES if rng.random() < 0.7]
            out.append(("row", now, {
                z: bool(rng.random() < (0.3 if crunch and z.startswith(
                    "us-west") else 0.93)) for z in zones}))
        else:
            zone = str(rng.choice(ZONES + ["eu-west-1a"]))
            out.append(("event", now, KINDS[int(rng.integers(4))], zone))
    return out


def _replay(pkg, event_mod, name, seed):
    """Every prediction the forecaster makes along the stream, as floats."""
    fc = pkg.make_forecaster(name)
    fc.reset(ZONES, KNOWN_REGIONS, dt=60.0)
    rng = np.random.default_rng(seed + 100)
    got = []
    for item in _stream(seed):
        if item[0] == "row":
            fc.observe(item[1], item[2])
        else:
            _, now, kind, zone = item
            fc.observe_event(event_mod.ControllerEvent(
                kind=getattr(event_mod.EventKind, kind), zone=zone, now=now,
                instance_id=None))
        at = item[1] + float(rng.uniform(0.0, 120.0))
        for horizon in (60.0, 450.0, 1800.0):
            for z, f in fc.predict(at, horizon).items():
                got.append((z, horizon, f.p_available, f.p_preempt))
        if name == "markov":
            got.extend((z, b, pq) for z in ZONES
                       for b, pq in fc.rates(z).items())
    return got


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", FORECASTERS)
def test_predictions_are_the_references_to_the_bit(name, seed):
    got = _replay(tfc, tpol, name, seed)
    want = _replay(jfc, jpol, name, seed)
    assert len(got) == len(want) > 3000
    assert got == want
    # the stream moves the scores: not a constant answer
    assert len({g[2] for g in got if len(g) == 4}) > (
        2 if name == "persistence" else 100)


def test_sibling_regions_are_the_references():
    for z in ZONES + ["europe-west4-a", "eastus-2"]:
        assert tfc.infer_region(z) == jfc.infer_region(z)
    got, want = tfc.make_forecaster("markov"), jfc.make_forecaster("markov")
    for fc in (got, want):
        fc.reset(ZONES, KNOWN_REGIONS)
    assert got._sibs == want._sibs and got._region_of == want._region_of


# ---------------------------------------------------------------------------
# backtests: the named traces, the committed reports, the CLIs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fc", FORECASTERS)
@pytest.mark.parametrize("trace", TRACES)
def test_backtest_is_the_references_and_the_artifact(trace, fc):
    got = tfc.run_backtest(trace, fc)
    want = jfc.run_backtest(trace, fc)
    assert [dataclasses.asdict(h) for h in got.horizons] == [
        dataclasses.asdict(h) for h in want.horizons]
    assert got.mean_brier_avail == want.mean_brier_avail
    assert got.to_dict() == want.to_dict()
    path = os.path.join(ROOT, "artifacts", "forecast",
                        f"backtest_{trace}_{fc}.json")
    with open(path) as f:
        assert got.to_dict() == json.load(f)
    # and the port reads the committed report back as the reference does
    assert dataclasses.asdict(tbt.BacktestReport.load(path)) == \
        dataclasses.asdict(jbt.BacktestReport.load(path))


def _stdout(fn, *args):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


def test_backtest_cli_is_the_references(tmp_path, monkeypatch):
    args = ["--trace", "gcp-1", "--horizons", "5", "15", "--warmup", "60",
            "--max-steps", "900"]
    rc_t, out_t = _stdout(tbt.main, args + ["--out-dir", str(tmp_path / "t")])
    rc_j, out_j = _stdout(jbt.main, args + ["--out-dir", str(tmp_path / "j")])
    assert rc_t == rc_j == 0
    assert out_t.replace(str(tmp_path / "t"), "") == \
        out_j.replace(str(tmp_path / "j"), "")
    for fc in FORECASTERS:
        name = f"backtest_gcp-1_{fc}.json"
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()
    # the default directory is the run's scratch directory, not the
    # committed artifacts
    monkeypatch.chdir(tmp_path)
    assert _stdout(tbt.main, ["--trace", "gcp-1", "--forecasters", "ewma",
                              "--max-steps", "400"])[0] == 0
    assert (tmp_path / "chiprun_out" / "forecast" /
            "backtest_gcp-1_ewma.json").exists()


@pytest.mark.parametrize("args", [["--json"], ["aws-1", "gcp-1"]],
                         ids=["json", "table"])
def test_trace_stats_cli_is_the_references(args):
    rc_t, out_t = _stdout(ttr.main, args)
    rc_j, out_j = _stdout(jtr.main, args)
    assert rc_t == rc_j == 0 and out_t == out_j and out_t


# ---------------------------------------------------------------------------
# the forecast: section and the forecasters axis
# ---------------------------------------------------------------------------

BASE = {
    "name": "fc", "model": "llama3.2-1b", "trace": "gcp-1",
    "resources": {"instance_type": "p3.2xlarge"},
    "replica_policy": {"name": "risk_spothedge"},
    "autoscaler": {"kind": "constant", "target": 3},
    "workload": {"kind": "poisson", "rate_per_s": 0.5, "seed": 4},
    "sim": {"duration_hours": 1.0},
}

FORECAST_SECTIONS = [
    {"name": "markov"},
    {"name": "ewma", "horizon_s": 900.0, "risk_threshold": 0.5,
     "calm_threshold": 0.1, "args": {"halflife_s": 3600.0}},
    {"name": "persistence", "args": {"prior": 0.7}},
]


@pytest.mark.parametrize("section", FORECAST_SECTIONS,
                         ids=[s["name"] for s in FORECAST_SECTIONS])
def test_forecast_spec_round_trips(section):
    got = t_spec_from_dict({**BASE, "forecast": section})
    want = j_spec_from_dict({**BASE, "forecast": section})
    assert isinstance(got.forecast, tspec.ForecastSpec)
    assert got.to_dict() == want.to_dict()
    assert got.forecast.policy_kwargs() == want.forecast.policy_kwargs()
    assert t_spec_from_dict(got.to_dict()) == got
    assert j_spec_from_dict(got.to_dict()).to_dict() == want.to_dict()
    assert tspec.ForecastSpec().to_dict() == jspec.ForecastSpec().to_dict()


BAD_FORECAST = [
    ("horizon", {"forecast": {"horizon_s": 0}}),
    ("risk threshold", {"forecast": {"risk_threshold": 1.5}}),
    ("calm threshold", {"forecast": {"calm_threshold": -0.1}}),
    ("empty name", {"forecast": {"name": ""}}),
    ("unknown name", {"forecast": {"name": "oracle"}}),
    ("unknown key", {"forecast": {"name": "markov", "window": 3}}),
    ("not a mapping", {"forecast": ["markov"]}),
    ("sweep entry type", {"sweep": {"forecasters": [3]}}),
    ("sweep empty entry", {"sweep": {"forecasters": [""]}}),
    ("sweep unknown", {"sweep": {"forecasters": ["markov", "oracle"]}}),
]


@pytest.mark.parametrize("extra", [b[1] for b in BAD_FORECAST],
                         ids=[b[0] for b in BAD_FORECAST])
def test_forecast_errors_are_the_references(extra):
    got = _raised(lambda: t_spec_from_dict({**BASE, **extra}), ValueError)
    want = _raised(lambda: j_spec_from_dict({**BASE, **extra}), ValueError)
    assert got[1] == want[1] and got[0] == "SpecError"


AXES = [
    ("with a base section",
     {"forecast": {"name": "ewma", "horizon_s": 600.0},
      "sweep": {"policies": ["spothedge", "risk_spothedge", "omniscient",
                             {"name": "risk_spothedge",
                              "args": {"surge_overprovision": 2}}],
                "forecasters": ["persistence", "markov"],
                "seeds": [0, 1]}}),
    ("without one",
     {"sweep": {"policies": ["even_spread", "risk_spothedge"],
                "forecasters": ["markov", "ewma", "persistence"],
                "traces": ["gcp-1", "aws-1"]}}),
]


@pytest.mark.parametrize("extra", [a[1] for a in AXES],
                         ids=[a[0] for a in AXES])
def test_forecasters_axis_gives_the_references_cells(extra):
    d = {**BASE, **extra}
    got = TSuite.from_spec(d).scenarios
    want = JSuite.from_spec(d).scenarios
    assert [sc.labels for sc in got] == [sc.labels for sc in want]
    assert [sc.cell_id for sc in got] == [sc.cell_id for sc in want]
    assert [sc.spec.to_dict() for sc in got] == [sc.spec.to_dict()
                                                 for sc in want]
    assert [sc.tape_key for sc in got] == [sc.tape_key for sc in want]
    # a policy that ignores the forecast keeps one unlabelled cell
    for sc in got:
        uses = getattr(tpol.policy_class(sc.spec.replica_policy.name),
                       "uses_forecast", False)
        assert ("forecaster" in sc.labels) == uses
