"""Package rules of the port: its own configs equal the reference's, it
imports neither JAX nor the reference package, and its entry points run on
CUDA unless the caller asks for the CPU."""

import dataclasses
import json
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.models.config import ModelConfig as TModelConfig  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")
PKG = os.path.join(SRC, "repro_torch")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_model_config_fields_match_reference():
    assert [f.name for f in dataclasses.fields(TModelConfig)] == [
        f.name for f in dataclasses.fields(JModelConfig)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_matches_reference(arch):
    want, got = j_config(arch), t_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("resolved_head_dim", "padded_vocab", "mlp_gated", "is_moe",
                 "hybrid_blocks", "approx_params"):
        a, b = getattr(got, prop), getattr(want, prop)
        assert (a() if callable(a) else a) == (b() if callable(b) else b), prop
    assert dataclasses.asdict(t_smoke(arch)) == dataclasses.asdict(j_smoke(arch))


# ---------------------------------------------------------------------------
# no JAX, no reference package
# ---------------------------------------------------------------------------

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(mods), bad)
sys.exit(1 if bad or len(mods) < 15 else 0)
"""


def test_importing_every_module_loads_no_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, ROOT]))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax|from\s+jax|import\s+repro(?!_torch)\b|"
    r"from\s+repro(?!_torch)\b)", re.M)


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_sources_import_no_jax_or_reference():
    files = list(_sources())
    assert len(files) >= 20
    offenders = [f for f in files if _FORBIDDEN.search(open(f).read())]
    assert offenders == []
    assert _FORBIDDEN.search("from repro.models import x\n")
    assert _FORBIDDEN.search("  import jax.numpy as jnp\n")
    assert not _FORBIDDEN.search("from repro_torch.models import x\n")


# ---------------------------------------------------------------------------
# entry points run on CUDA unless asked for the CPU
# ---------------------------------------------------------------------------


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA: the entry points would run there")


def test_resolve_device(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_model_defaults_to_cuda(no_cuda):
    from repro_torch.models.registry import build_model

    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(t_smoke("llama3.2-1b"))
    assert build_model(t_smoke("llama3.2-1b"), device="cpu").device.type == "cpu"


def test_live_entry_point_defaults_to_cuda(no_cuda):
    from repro_torch.serving import live

    with pytest.raises(RuntimeError, match="CUDA"):
        live.main(["--smoke"])


def test_chip_smoke_refuses_without_cuda(no_cuda):
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# ---------------------------------------------------------------------------
# the scenario engine
# ---------------------------------------------------------------------------

SCENARIO_MODULES = (
    "repro_torch.serving.torchengine.engine",
    "repro_torch.serving.torchengine.kernel",
    "repro_torch.serving.torchengine.recorded",
    "repro_torch.serving.torchengine.schedule",
    "repro_torch.workloads.arrivals",
    "repro_torch.serving.latency",
    "repro_torch.serving.result",
    "repro_torch.kernels.scenario_scan",
)


def test_scenario_engine_modules_fall_under_the_import_rule():
    """The scenario engine's modules are among those the two import tests
    above walk and scan."""
    import pkgutil

    import repro_torch

    walked = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                    "repro_torch.")}
    assert set(SCENARIO_MODULES) <= walked
    scanned = {os.path.relpath(f, SRC) for f in _sources()}
    for mod in SCENARIO_MODULES:
        assert mod.replace(".", os.sep) + ".py" in scanned, mod


def test_scenario_engine_defaults_to_cuda(no_cuda):
    from repro_torch.serving.torchengine import engine, recorded
    from repro_torch.serving.torchengine.kernel import run_group

    scheds = recorded.recorded_matrix(n_seeds=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.run_schedules(scheds)
    key, lanes, grid = engine.pack_group(scheds)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_group(key, lanes, *grid)
    with pytest.raises(ValueError, match="unsupported device"):
        run_group(key, lanes, *grid, device="meta")


# ---------------------------------------------------------------------------
# the front door: Service, the loader, the suite, the CLI
# ---------------------------------------------------------------------------

FRONT_DOOR_MODULES = (
    "repro_torch.service.spec",
    "repro_torch.service.loader",
    "repro_torch.service.builder",
    "repro_torch.service.service",
    "repro_torch.experiments.report",
    "repro_torch.experiments.suite",
    "repro_torch.launch.serve",
)


def test_front_door_modules_fall_under_the_import_rule():
    import pkgutil

    import repro_torch

    walked = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                    "repro_torch.")}
    assert set(FRONT_DOOR_MODULES) <= walked
    scanned = {os.path.relpath(f, SRC) for f in _sources()}
    for mod in FRONT_DOOR_MODULES:
        assert mod.replace(".", os.sep) + ".py" in scanned, mod


_JAX_SPEC = {
    "model": "llama3.2-1b", "trace": "aws-1",
    "resources": {"instance_type": "g5.48xlarge"},
    "autoscaler": {"kind": "constant", "target": 3},
    "sim": {"duration_hours": 1.0, "engine": "jax"},
}


def test_front_door_defaults_to_cuda(no_cuda):
    """``sim.engine: jax`` runs phase B on the card: with no CUDA the
    defaults raise before phase A, never run on the CPU."""
    from repro_torch.experiments import ScenarioSuite
    from repro_torch.service import Service

    svc = Service(_JAX_SPEC)
    with pytest.raises(RuntimeError, match="CUDA"):
        svc.run()
    assert svc.result is None and svc.status()["state"] == "declared"
    suite = ScenarioSuite.from_spec(
        dict(_JAX_SPEC, sweep={"policies": ["spothedge", "even_spread"]}))
    with pytest.raises(RuntimeError, match="CUDA"):
        suite.run()
    with pytest.raises(RuntimeError, match="CUDA"):
        suite.run(engine="jax")


# README.md's quickstart service: no sim.engine, so the reference's default
# (vector) stands in the spec
_QUICKSTART = {
    "name": "chatbot", "model": "command-r-35b", "trace": "aws-3",
    "resources": {"instance_type": "g5.48xlarge",
                  "any_of": [{"region": "us-east-1"}, {"region": "us-east-2"},
                             {"region": "us-west-2"}]},
    "replica_policy": {"name": "spothedge", "overprovision": 2,
                       "dynamic_fallback": True},
    "autoscaler": {"kind": "load", "target": 4, "qps_per_replica": 0.8},
    "workload": {"kind": "arena", "rate_per_s": 2.0},
    "sim": {"duration_hours": 1.0},
}


def test_front_door_defaults_to_cuda_whatever_the_spec_says(no_cuda):
    """A spec that names no engine (or ``vector``) still runs phase B on the
    card through the port's entry points: with no CUDA they raise, and the
    host engine is an explicit request that takes no device but the CPU."""
    from repro_torch.experiments import ScenarioSuite
    from repro_torch.service import Service

    for spec in (_QUICKSTART,
                 dict(_QUICKSTART, sim={"duration_hours": 1.0,
                                        "engine": "vector"})):
        svc = Service(spec)
        with pytest.raises(RuntimeError, match="CUDA"):
            svc.run()
        assert svc.result is None
        suite = ScenarioSuite.from_spec(
            dict(spec, sweep={"traces": ["aws-1", "aws-3"]}))
        with pytest.raises(RuntimeError, match="CUDA"):
            suite.run()
    with pytest.raises(ValueError, match="host engine"):
        Service(_QUICKSTART, engine="vector").run(device="cuda")
    with pytest.raises(ValueError, match="host engine"):
        ScenarioSuite.from_spec(_QUICKSTART).run(engine="vector",
                                                 device="cuda")


def test_serve_cli_defaults_to_cuda(no_cuda, tmp_path):
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main([])
    spec = tmp_path / "s.json"
    spec.write_text(json.dumps(dict(_JAX_SPEC, sweep={"seeds": [0, 1]})))
    for extra in ([], ["--sweep"], ["--status"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--spec", str(spec), *extra])
    host = tmp_path / "h.json"
    host.write_text(json.dumps(_QUICKSTART))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--spec", str(host)])
    with pytest.raises(SystemExit) as e:    # the host engine takes no card
        serve.main(["--spec", str(host), "--engine", "vector",
                    "--device", "cuda"])
    assert e.value.code == 2


# ---------------------------------------------------------------------------
# token-level serving, KV migration and the legacy engine
# ---------------------------------------------------------------------------

TOKEN_MODULES = (
    "repro_torch.serving.token.config",
    "repro_torch.serving.token.metrics",
    "repro_torch.serving.token.batch",
    "repro_torch.serving.token.replica",
    "repro_torch.serving.replica",
    "repro_torch.serving.load_balancer",
    "repro_torch.serving.sim",
    "repro_torch.migration.config",
    "repro_torch.migration.cost",
    "repro_torch.migration.planner",
    "repro_torch.migration.runtime",
)


def test_token_modules_fall_under_the_import_rule():
    import pkgutil

    import repro_torch

    walked = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                    "repro_torch.")}
    assert set(TOKEN_MODULES) <= walked
    scanned = {os.path.relpath(f, SRC) for f in _sources()}
    for mod in TOKEN_MODULES:
        assert mod.replace(".", os.sep) + ".py" in scanned, mod


OBS_MODULES = (
    "repro_torch.obs",
    "repro_torch.obs.__main__",
    "repro_torch.obs.attribution",
    "repro_torch.obs.events",
    "repro_torch.obs.export",
    "repro_torch.obs.recorder",
    "repro_torch.obs.registry",
    "repro_torch.obs.slo",
    "repro_torch.obs.spans",
    "repro_torch.serving.window",
)


def test_obs_modules_fall_under_the_import_rule():
    import pkgutil

    import repro_torch

    walked = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                    "repro_torch.")}
    assert set(OBS_MODULES) - {"repro_torch.obs"} <= walked
    scanned = {os.path.relpath(f, SRC) for f in _sources()}
    for mod in OBS_MODULES:
        path = mod.replace(".", os.sep)
        assert (path + ".py" in scanned
                or os.path.join(path, "__init__.py") in scanned), mod


# what the port refused by name until its forecast port, and now runs: the
# forecast section, the risk-aware policy, the Omniscient oracle and the
# forecasters axis
ONCE_REFUSED = [
    ({"forecast": {"name": "markov"}}, "forecast"),
    ({"replica_policy": {"name": "risk_spothedge"}}, "risk_spothedge"),
    ({"sweep": {"policies": ["omniscient"]}}, "omniscient"),
    ({"replica_policy": {"name": "risk_spothedge"},
      "sweep": {"forecasters": ["markov", "ewma"]}}, "sweep.forecasters"),
]

# what the port refused until its obs port, and now runs: observability at
# detail "full" and its burn monitor
NOW_PORTED = [
    ({"observability": {"detail": "full"}}, "observability.detail 'full'"),
    ({"observability": {"slo_burn": {"target": 0.9}}},
     "observability.slo_burn"),
]


@pytest.mark.parametrize("extra,name", ONCE_REFUSED,
                         ids=[r[1] for r in ONCE_REFUSED])
def test_once_refused_parts_run_as_the_reference(extra, name):
    """Each part runs through the port's suite with phase B on the CPU and
    equals the reference's vector engine, cell for cell."""
    from repro.experiments import ScenarioSuite as JScenarioSuite
    from repro_torch.experiments import ScenarioSuite

    d = {**_JAX_SPEC, **extra, "sim": {"duration_hours": 0.5}}
    got = ScenarioSuite.from_spec(d).run(device="cpu")
    want = JScenarioSuite.from_spec(d).run(engine="vector")
    assert [c.labels for c in got.cells] == [c.labels for c in want.cells]
    for a, b in zip(got.cells, want.cells):
        for k in ("n_requests", "n_completed", "n_failed", "n_preemptions",
                  "n_launch_failures"):
            assert getattr(a, k) == getattr(b, k), k
        for k in ("total_cost", "cost_vs_ondemand", "availability"):
            assert getattr(a, k) == pytest.approx(getattr(b, k), abs=1e-9), k
        for k in ("p50_s", "p99_s"):
            assert getattr(a, k) == pytest.approx(getattr(b, k), abs=1e-6), k
    assert got.oracle_reruns == []


@pytest.mark.parametrize("extra,name", NOW_PORTED,
                         ids=[r[1] for r in NOW_PORTED])
def test_ported_observability_sections_are_accepted_and_run(extra, name,
                                                            tmp_path):
    from repro_torch.service import Service, spec_from_dict

    obs = dict(extra["observability"], out_dir=str(tmp_path))
    spec = spec_from_dict({**_JAX_SPEC, "observability": obs,
                           "sim": {"duration_hours": 0.25, "engine": "jax"}})
    svc = Service(spec)
    res = svc.run(device="cpu")
    assert res.obs is not None and res.obs.events
    assert res.metrics is None or isinstance(res.metrics, dict)
    if spec.observability.detail == "full":
        assert set(svc.artifacts) == {"events", "spans", "trace"}
    else:
        assert svc.artifacts == {}
        assert res.obs.slo_burn.target == 0.9


def test_suite_workers_fan_out_on_the_host_only():
    """``workers`` fans host-engine cells out over processes (the report
    says how many); under the card engine the batch is the parallelism, the
    count is ignored and the report says 1, as the reference's does."""
    from repro_torch.experiments import ScenarioSuite
    from repro_torch.service import SpecError

    d = dict(_JAX_SPEC, sim={"duration_hours": 0.25},
             sweep={"seeds": [0, 1]})
    suite = ScenarioSuite.from_spec(d)
    host = suite.run(engine="vector", workers=2)
    card = suite.run(workers=2, device="cpu")
    assert (host.workers, card.workers) == (2, 1)
    assert [c.total_cost for c in host.cells] == pytest.approx(
        [c.total_cost for c in card.cells], abs=1e-9)
    with pytest.raises(SpecError, match="workers must be an int"):
        suite.run(engine="vector", workers=0)


def test_listing1_builds_whole():
    """``examples/service.yaml``, its forecast section and risk-aware
    policy included, builds on the port: the policy consults the Markov
    forecaster at the section's horizon and thresholds, and the token
    model, the migration section and observability at detail ``full``
    are wired as before."""
    yaml = pytest.importorskip("yaml")
    from repro_torch.service import build_service, spec_from_dict

    with open(os.path.join(ROOT, "examples", "service.yaml")) as f:
        d = yaml.safe_load(f)["service"]
    spec = spec_from_dict(d)
    assert spec.replica_policy.name == "risk_spothedge"
    assert spec.sim.replica_model == "token" and spec.migration.enabled
    assert spec.observability.detail == "full"
    resolved = build_service(spec)
    pol = resolved.policy
    assert (pol.name, pol.forecaster.name, pol.horizon_s, pol.risk_threshold,
            pol.calm_threshold, pol.n_extra) == (
        "risk_spothedge", "markov", 450.0, 0.6, 0.06, 2)
    sim = resolved.simulator
    assert sim.replica_model == "token" and sim._mig_rt is not None
    assert resolved.obs is sim.obs and sim._mig_rt.obs is sim.obs
    assert resolved.obs.detail == "full"


def test_legacy_engine_is_a_host_request(no_cuda, tmp_path):
    """``legacy`` runs on the host as ``vector`` does: it takes no device
    but the CPU; a token spec under the default engine still asks for the
    card."""
    from repro_torch.experiments import ScenarioSuite
    from repro_torch.launch import serve
    from repro_torch.service import Service

    with pytest.raises(ValueError, match="host engine"):
        Service(_QUICKSTART, engine="legacy").run(device="cuda")
    with pytest.raises(ValueError, match="host engine"):
        ScenarioSuite.from_spec(_QUICKSTART).run(engine="legacy",
                                                 device="cuda")
    host = tmp_path / "h.json"
    host.write_text(json.dumps(_QUICKSTART))
    with pytest.raises(SystemExit) as e:
        serve.main(["--spec", str(host), "--engine", "legacy", "--device",
                    "cuda"])
    assert e.value.code == 2
    token = dict(_JAX_SPEC, serving={"replica_model": "token"})
    with pytest.raises(RuntimeError, match="CUDA"):
        Service(token).run()
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--spec", str(host), "--replica-model", "token"])


# ---------------------------------------------------------------------------
# the train path: training, distributed, the train CLI, launch.steps
# ---------------------------------------------------------------------------

TRAIN_MODULES = (
    "repro_torch.training",
    "repro_torch.training.data",
    "repro_torch.training.optimizer",
    "repro_torch.training.train_loop",
    "repro_torch.distributed",
    "repro_torch.distributed.checkpoint",
    "repro_torch.distributed.compression",
    "repro_torch.launch.steps",
    "repro_torch.launch.train",
)


def test_train_modules_fall_under_the_import_rule():
    import pkgutil

    import repro_torch

    walked = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                    "repro_torch.")}
    assert set(TRAIN_MODULES) <= walked
    scanned = {os.path.relpath(f, SRC) for f in _sources()}
    for mod in TRAIN_MODULES:
        path = mod.replace(".", os.sep)
        assert (path + ".py" in scanned
                or os.path.join(path, "__init__.py") in scanned), mod


def test_train_entry_points_default_to_cuda(no_cuda):
    from repro_torch.launch import train
    from repro_torch.launch.steps import build_train_step
    from repro_torch.training import make_batch

    cfg = t_smoke("llama3.2-1b")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        build_train_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_batch(cfg, 1, 4)
    assert make_batch(cfg, 1, 4, device="cpu")["tokens"].device.type == "cpu"
