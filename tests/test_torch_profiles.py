"""The port's step-time profiles against the reference's contract.

The port keeps its own copy of the profile schema (``repro_torch.profiles``):
its fields are a superset of the reference's, with the same key format and
version gate, and a table written by either package loads in the other.
The main path closes here on the CPU: the port's profiler writes a
``llama3.2-1b|H100`` table (the kernels' plain versions, mode ``eager``), the
reference's ``make_latency_model`` turns it into a ``ProfiledLatencyModel``
with no roofline fallback, and that model prices a reference
``ServingSimulator`` run on the H100 instance, which serves its requests.
"""

import dataclasses
import json
import math

import pytest

torch = pytest.importorskip("torch")

from repro.cluster.catalog import Catalog, DEFAULT_INSTANCE_TYPES  # noqa: E402
from repro.cluster.catalog import InstanceType as JInstanceType  # noqa: E402
from repro.cluster.traces import synth_correlated_trace  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.core.autoscaler import ConstantTarget  # noqa: E402
from repro.core.policy import make_policy  # noqa: E402
from repro.obs.registry import MetricsRegistry, use_registry  # noqa: E402
from repro.profiles import schema as jschema  # noqa: E402
from repro.serving.latency import ProfiledLatencyModel, make_latency_model  # noqa: E402
from repro.serving.sim import ServingSimulator  # noqa: E402
from repro.workloads.arrivals import Request  # noqa: E402
from repro_torch.cluster.catalog import H100, InstanceType, instance_type  # noqa: E402
from repro_torch.profiles import run as profiles_run  # noqa: E402
from repro_torch.profiles import schema as tschema  # noqa: E402
from repro_torch.profiles import (  # noqa: E402
    ProfileEntry,
    ProfileSchemaError,
    ProfileTable,
    load_profiles,
    profile_model,
)

# small kernel shapes: the CPU runs the plain versions
SMALL = dict(prefill_tokens=32, cache_tokens=64, repeats=1, device="cpu")


def _names(cls):
    return [f.name for f in dataclasses.fields(cls)]


def _entry(cls=ProfileEntry, **extra):
    return cls(
        model="llama3.2-1b", accelerator="H100", backend="cuda",
        mode="compiled", prefill_tokens=256, prefill_flops=1e12,
        prefill_wall_s=0.01, decode_cache_tokens=512, decode_steps=4,
        decode_bytes=1e9, decode_wall_s=0.001, mfu_prefill=0.31,
        mbu_decode=0.55, **extra,
    )


# ---------------------------------------------------------------------------
# schema: a superset of the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pair", [(ProfileEntry, jschema.ProfileEntry),
                                  (ProfileTable, jschema.ProfileTable)],
                         ids=["entry", "table"])
def test_schema_fields_are_a_superset_of_the_reference(pair):
    port, ref = pair
    assert _names(port)[:len(_names(ref))] == _names(ref)
    assert set(_names(port)) - set(_names(ref)) == {"torch_version", "device"}
    added = {f.name: f.default for f in dataclasses.fields(port)}
    assert added["torch_version"] == added["device"] == ""


def test_schema_version_key_and_gate_match_the_reference(tmp_path):
    assert tschema.SCHEMA_VERSION == jschema.SCHEMA_VERSION == 1
    assert tschema.DEFAULT_PROFILE_DIR == jschema.DEFAULT_PROFILE_DIR
    assert _entry().key == _entry(jschema.ProfileEntry).key == "llama3.2-1b|H100"
    d = ProfileTable().to_dict()
    d["schema_version"] = 2
    path = tmp_path / "v2.json"
    path.write_text(json.dumps(d))
    with pytest.raises(ProfileSchemaError, match="schema_version"):
        ProfileTable.load(str(path))
    with pytest.raises(jschema.ProfileSchemaError, match="schema_version"):
        jschema.ProfileTable.load(str(path))


def test_port_table_loads_in_the_reference_and_back(tmp_path):
    table = ProfileTable(backend="cuda", mode="compiled",
                         torch_version="2.11.0+cu128",
                         device="NVIDIA H100 80GB HBM3, 700.00 W")
    table.add(_entry(torch_version="2.11.0+cu128",
                     device="NVIDIA H100 80GB HBM3, 700.00 W"))
    path = str(tmp_path / "port.json")
    table.save(path)
    ref = jschema.load_profiles(path)
    got = ref.lookup("llama3.2-1b", "H100")
    assert dataclasses.asdict(got) == {
        k: v for k, v in _entry().to_dict().items()
        if k not in ("torch_version", "device")}
    assert ProfileTable.load(path).lookup("llama3.2-1b", "H100") == \
        _entry(torch_version="2.11.0+cu128",
               device="NVIDIA H100 80GB HBM3, 700.00 W")


def test_reference_table_loads_in_the_port(tmp_path):
    table = jschema.ProfileTable(jax_version="0.4.37", backend="tpu",
                                 mode="compiled")
    table.add(_entry(jschema.ProfileEntry, jax_version="0.4.37"))
    path = str(tmp_path / "ref.json")
    table.save(path)
    got = ProfileTable.load(path)
    assert got.jax_version == "0.4.37" and got.torch_version == ""
    assert got.lookup("llama3.2-1b", "H100") == _entry(jax_version="0.4.37")
    # and through a directory, merged in file order as the reference does
    merged = load_profiles(str(tmp_path))
    assert merged.lookup("llama3.2-1b", "H100") == _entry(jax_version="0.4.37")


# ---------------------------------------------------------------------------
# the H100 instance type
# ---------------------------------------------------------------------------


def test_h100_instance_type_carries_the_published_peaks():
    assert instance_type("h100") is H100
    assert (H100.accelerator, H100.accel_count) == ("H100", 1)
    assert (H100.peak_bf16_tflops, H100.hbm_bytes_per_s) == (989.0, 3.35e12)
    assert H100.hbm_gib_per_accel == 80.0
    assert _names(InstanceType) == _names(JInstanceType)
    with pytest.raises(ValueError, match="hbm_bytes_per_s"):
        InstanceType("x", "gcp", "H9000", 1, 1.0, 0.3)
    # an instance type the port does not declare names the ones it has
    with pytest.raises(KeyError, match="h100"):
        instance_type("v9x-1024")


# ---------------------------------------------------------------------------
# profiler and CLI on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3.2-1b", "falcon-mamba-7b"])
def test_profiler_rows_on_the_cpu(arch):
    e = profile_model(arch, H100, **SMALL)
    assert (e.backend, e.mode, e.device) == ("cpu", "eager", "cpu")
    assert e.accelerator == "H100" and e.jax_version == ""
    assert e.torch_version == torch.__version__
    assert e.prefill_wall_s > 0 and e.decode_wall_s > 0
    assert 0 < e.mfu_prefill < 1 and 0 < e.mbu_decode < 1
    assert math.isclose(e.prefill_flops_per_s / (989e12), e.mfu_prefill)
    assert math.isclose(e.decode_bytes_per_s / 3.35e12, e.mbu_decode)
    cfg = j_config(arch)
    if cfg.num_heads:        # the reference's counts (profiler.py:79, 128)
        assert e.prefill_tokens == 32
        assert e.prefill_flops == 4.0 * cfg.num_heads * 32 * 32 \
            * cfg.resolved_head_dim * 0.5
        assert e.decode_bytes == 2.0 * cfg.num_kv_heads * 64 \
            * cfg.resolved_head_dim * 2
    else:                    # one scan chunk (profiler.py:93, 142)
        assert e.prefill_flops == 2.0 * 32 * cfg.d_inner * cfg.ssm_state
        assert e.decode_bytes == 4.0 * cfg.d_inner * cfg.ssm_state * 4


def test_profiler_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA: the profiler would run there")
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_model("llama3.2-1b", H100, prefill_tokens=32)


def test_run_cli_writes_and_merges(tmp_path, capsys):
    out = tmp_path / "t.json"
    args = ["--device", "cpu", "--prefill-tokens", "32", "--cache-tokens",
            "64", "--repeats", "1", "--out", str(out)]
    assert profiles_run.main(["--models", "llama3.2-1b", *args]) == 0
    assert profiles_run.main(["--models", "falcon-mamba-7b", *args]) == 0
    table = ProfileTable.load(str(out))
    assert sorted(table.entries) == ["falcon-mamba-7b|H100", "llama3.2-1b|H100"]
    assert (table.backend, table.mode, table.device) == ("cpu", "eager", "cpu")
    assert "wrote" in capsys.readouterr().out


def test_run_cli_refuses_to_clobber_unreadable_table(tmp_path, capsys):
    out = tmp_path / "t.json"
    out.write_text("{not json")
    rc = profiles_run.main([
        "--models", "llama3.2-1b", "--device", "cpu", "--prefill-tokens",
        "32", "--cache-tokens", "64", "--repeats", "1", "--out", str(out),
    ])
    assert rc == 1
    assert "cannot be merged" in capsys.readouterr().err
    assert out.read_text() == "{not json"   # untouched


def test_run_cli_compiled_needs_the_card():
    with pytest.raises(SystemExit):
        profiles_run.main(["--device", "cpu", "--compiled"])


# ---------------------------------------------------------------------------
# the main path: a port-written table prices a reference simulation
# ---------------------------------------------------------------------------


def test_port_profile_prices_a_reference_simulation_on_the_h100(tmp_path):
    path = str(tmp_path / "cpu-eager.json")
    assert profiles_run.main([
        "--models", "llama3.2-1b", "--itype", "h100", "--device", "cpu",
        "--prefill-tokens", "32", "--cache-tokens", "64", "--repeats", "1",
        "--out", path]) == 0
    port_row = ProfileTable.load(path).lookup("llama3.2-1b", "H100")

    # the reference's own InstanceType, built from the port's H100 figures
    itype = JInstanceType(**dataclasses.asdict(H100))
    assert itype.hbm_bytes_per_s == 3.35e12
    cfg = j_config("llama3.2-1b")
    registry = MetricsRegistry()
    with use_registry(registry):
        lm = make_latency_model(cfg, itype, model_id="llama3.2-1b",
                                source="profile", profile=path)
    assert isinstance(lm, ProfiledLatencyModel)
    assert (lm.mfu_prefill, lm.mbu_decode) == (port_row.mfu_prefill,
                                                port_row.mbu_decode)
    assert (lm.profile_backend, lm.profile_mode) == ("cpu", "eager")
    assert registry.counter("latency_profile_fallback", model="llama3.2-1b",
                            accelerator="H100") == 0

    # CPU efficiencies price a request at minutes of simulated time: few,
    # short requests and a timeout that lets them finish
    zones = ["us-central1-a", "us-central1-b", "us-west1-a"]
    trace = synth_correlated_trace(zones, {z: z[:-2] for z in zones},
                                   steps=240, dt=60.0, seed=21,
                                   max_capacity=4, name="mini")
    requests = [Request(arrival_s=600.0 + 900.0 * i, prompt_tokens=2,
                        output_tokens=2) for i in range(6)]
    catalog = Catalog(instance_types=DEFAULT_INSTANCE_TYPES + (itype,))
    sim = ServingSimulator(
        trace, make_policy("spothedge"), requests, cfg, itype="h100",
        catalog=catalog, autoscaler=ConstantTarget(2),
        timeout_s=4 * 3600.0, latency_model=lm, workload_name="h100",
    )
    assert sim.latency_model is lm and sim.itype is itype
    res = sim.run(4 * 3600.0)
    assert res.n_requests == len(requests)
    assert res.n_completed == len(requests)
