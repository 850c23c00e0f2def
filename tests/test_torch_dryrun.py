"""The port's dry-run contract (``launch.steps.build_step`` /
``input_specs``, ``launch.op_count``, ``launch.analysis``,
``launch.dryrun``, the kernel wrappers' ``meta`` routes and
``kernels.cost``) against the reference.

``input_specs`` is held against the reference's for all 40 arch × shape
cells, leaf for leaf: the port's per-layer parameters are stacked back
into the reference's blueprint layout for the comparison, its tokens and
labels are int64 (the reference's int32: every entry point of the port
takes int64 tokens), and whisper's cache holds the port's own cross mask
``cross_valid`` beside the reference's leaves.  Counting runs on ``meta``
tensors, on one device or on the (2, 4) node mesh over a ``"fake"``
process group that a fixture sets up and destroys.
"""

import math
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.launch import analysis as janalysis  # noqa: E402
from repro.launch.steps import input_specs as j_input_specs  # noqa: E402
from repro_torch.configs import SHAPES, ShapeSpec, get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import cost, ops  # noqa: E402
from repro_torch.launch import analysis, dryrun  # noqa: E402
from repro_torch.launch.op_count import OpCounter, count_step  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    build_mesh_prefill_step,
    build_mesh_serve_step,
    build_step,
    input_specs,
)

CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]


@pytest.fixture(scope="module")
def node_mesh():
    """A ``"fake"`` group of 16 ranks and the (2, 4) node mesh."""
    from repro_torch.launch.mesh import make_production_mesh

    dryrun.init_fake_group(16)
    yield make_production_mesh()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# input_specs against the reference
# ---------------------------------------------------------------------------


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


_STACKED = ("prelude", "blocks", "shared_attn")


def _restack(params):
    """The port's per-layer parameters by name -> {reference path: (shape,
    dtype)}: each index in a name is a stacked axis of the reference's
    blueprint (``layers.3.attn.wq`` -> ``decoder.attn.wq`` with a leading
    axis of the layer count)."""
    groups = {}
    for name, t in params.items():
        parts = name.split(".")
        idx = tuple(int(p) for p in parts if p.isdigit())
        key = [p for p in parts if not p.isdigit()]
        if key[0] == "layers":
            key[0] = "decoder"
        elif key[0] in _STACKED:
            key.insert(0, "decoder")
        g = groups.setdefault(tuple(key), [set(), tuple(t.shape), t.dtype])
        g[0].add(idx)
    out = {}
    for key, (idxs, shape, dtype) in groups.items():
        lead = tuple(max(i[d] for i in idxs) + 1 for d in range(len(next(iter(idxs)))))
        assert len(idxs) == math.prod(lead), key
        out[key] = (lead + shape, dtype)
    return out


_JDT = {"bfloat16": torch.bfloat16, "float32": torch.float32,
        "int32": torch.int32}
_INT64_LEAVES = {"tokens", "labels"}


def _jleaf(path, s):
    dt = _JDT[str(s.dtype)]
    if dt == torch.int32 and path and path[-1] in _INT64_LEAVES:
        dt = torch.int64      # the port's tokens
    return tuple(s.shape), dt


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_input_specs_match_reference(arch, shape_name):
    """Shapes and dtypes leaf for leaf, every leaf on meta."""
    got = input_specs(arch, shape_name, None)
    roles = build_step(arch, shape_name, None).arg_names
    want = j_input_specs(arch, shape_name, AbstractMesh((16, 16), ("data", "model")))
    assert len(got) == len(want) == len(roles)
    for path, t in _leaves(got):
        assert t.is_meta, path
    for role, g, w in zip(roles, got, want):
        if role == "params":
            assert _restack(g) == {p: _jleaf(p, s) for p, s in _leaves(w)}
        elif role == "opt_state":
            assert set(g) == set(w)
            for k in ("m", "v"):
                assert _restack(g[k]) == {p: _jleaf(p, s)
                                          for p, s in _leaves(w[k])}
            assert (tuple(g["step"].shape), g["step"].dtype) == _jleaf(
                (), w["step"])
        else:
            gl = {p: (tuple(t.shape), t.dtype) for p, t in _leaves(g)}
            wl = {p: _jleaf((role,) + p, s) for p, s in _leaves(w)}
            if role == "cache" and get_config(arch).is_encdec:
                cfg = get_config(arch)
                B = SHAPES[shape_name].global_batch
                assert gl.pop(("cross_valid",)) == ((B, cfg.frontend_seq),
                                                    torch.bool)
            assert gl == wl, (arch, shape_name, role)


# ---------------------------------------------------------------------------
# model FLOPs and the roofline
# ---------------------------------------------------------------------------


def test_model_flops_match_reference():
    from repro.configs import SHAPES as J_SHAPES

    for arch, shape_name in CELLS:
        assert analysis.model_flops_for(get_config(arch), SHAPES[shape_name]) \
            == janalysis.model_flops_for(j_config(arch), J_SHAPES[shape_name])


def test_model_flops_scaling():
    cfg = get_config("llama3.2-1b")
    ratio = (analysis.model_flops_for(cfg, SHAPES["train_4k"])
             / analysis.model_flops_for(cfg, SHAPES["decode_32k"]))
    assert ratio == pytest.approx(3 * 4096 * 256 / 128, rel=0.01)
    n_active = analysis.model_flops_for(get_config("qwen3-moe-30b"),
                                        SHAPES["decode_32k"]) / (2 * 128)
    assert 2e9 < n_active < 6e9


def test_roofline_terms_at_h100_constants():
    from repro_torch.cluster.catalog import H100

    assert analysis.PEAK_FLOPS_BF16 == 989e12 == H100.peak_bf16_tflops * 1e12
    assert analysis.HBM_BW == 3.35e12 == H100.hbm_bytes_per_s
    assert analysis.NVLINK_BW == 450e9
    r = analysis.Roofline(
        arch="a", shape="s", mesh_desc="m", chips=8,
        hlo_flops=989e12, hlo_bytes=3.35e12, collective_link_bytes=450e9,
        model_flops=989e12 * 8,
    )
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(1.0)
    assert r.collective_s == pytest.approx(1.0)
    assert r.step_time_s == pytest.approx(1.0)
    assert r.useful_flops_fraction == pytest.approx(1.0)
    assert r.mfu == pytest.approx(1.0)
    r2 = analysis.Roofline("a", "s", "m", 1, 1e9, 1e12, 0.0, 1e9)
    assert r2.bottleneck == "memory"
    assert set(r2.row()) == set(janalysis.Roofline(
        "a", "s", "m", 1, 1e9, 1e12, 0.0, 1e9).row())


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------


def test_chained_matmuls_counted_per_step():
    """Each of a loop's matmuls is counted (the counterpart of the
    reference's trip-count test): 4 × 2·8·64·64."""
    x = torch.empty(8, 64, device="meta")
    ws = torch.empty(4, 64, 64, device="meta")

    def step():
        y = x
        for w in ws:
            y = y @ w
        return y

    _, c = count_step(step)
    assert c.flops == 4 * 2 * 8 * 64 * 64
    # each matmul reads x and w and writes y (fp32); views are free
    assert c.bytes == 4 * 4 * (8 * 64 + 64 * 64 + 8 * 64)
    assert c.coll_counts == {} and c.peak_temp_bytes == 2 * 8 * 64 * 4


def test_mlp_counts_per_device(node_mesh):
    """x (16, 512) over data, w1 (512, 2048) column-parallel, w2 row-
    parallel on the (2, 4) mesh: one device's 8,388,608 FLOPs (x (8, 512)
    and a (512, 512) block each), not the global 67,108,864, and the one
    all-reduce the row-parallel product needs."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = node_mesh
    x = distribute_tensor(torch.empty(16, 512, device="meta"), mesh,
                          [Shard(0), Replicate()])
    w1 = distribute_tensor(torch.empty(512, 2048, device="meta"), mesh,
                           [Replicate(), Shard(1)])
    w2 = distribute_tensor(torch.empty(2048, 512, device="meta"), mesh,
                           [Replicate(), Shard(0)])

    def mlp():
        return (torch.relu(x @ w1) @ w2).redistribute(mesh, [Shard(0), Replicate()])

    y, c = count_step(mlp)
    assert c.flops == 8_388_608
    assert c.coll_counts == {"all-reduce": 1}
    assert c.coll_raw == 8 * 512 * 4 and c.coll_bytes == 2 * 8 * 512 * 4
    assert y.to_local().shape == (8, 512)
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as global_counter:
        mlp()
    assert global_counter.get_total_flops() == 67_108_864


# ---------------------------------------------------------------------------
# the kernel wrappers' meta routes and kernels.cost
# ---------------------------------------------------------------------------


def _pairs_brute(Sq, Skv, causal, window, prefix):
    q = np.arange(Sq)[:, None]
    k = np.arange(Skv)[None, :]
    m = np.ones((Sq, Skv), bool)
    if causal:
        m &= (q >= k) | (k < prefix)
    if window is not None:
        m &= q - k < window
    return int(m.sum())


@pytest.mark.parametrize("case", [
    (64, 64, True, None, 0), (64, 64, True, 9, 0), (64, 64, True, None, 12),
    (64, 64, True, 9, 12), (5, 77, False, None, 0), (40, 17, True, None, 0),
    (33, 33, False, 7, 0), (1, 1, True, None, 0)])
def test_attention_pairs_closed_form(case):
    assert cost.attention_pairs(*case) == _pairs_brute(*case)


def _kernel_cases():
    g = torch.Generator().manual_seed(0)
    r = lambda *s, dt=torch.float32: torch.randn(*s, generator=g).to(dt)  # noqa: E731
    q, k, v = r(2, 24, 4, 64, dt=torch.bfloat16), r(2, 24, 2, 64, dt=torch.bfloat16), \
        r(2, 24, 2, 64, dt=torch.bfloat16)
    valid = torch.ones(2, 24, dtype=torch.int8)
    a, b, h0 = torch.rand(1, 8, 6, 4), r(1, 8, 6, 4), r(1, 6, 4)
    x, w = r(4, 5, 16), r(4, 16, 12)
    return {
        "flash_attention": (ops.flash_attention, (q, k, v), dict(causal=True, window=7),
                            cost.flash_attention_work(2, 4, 2, 24, 24, 64, 2,
                                                      causal=True, window=7)),
        "flash_decode": (ops.flash_decode, (q[:, :1], k, v), dict(kv_valid=valid),
                         cost.flash_decode_work(2, 4, 2, 24, 64, 2)),
        "selective_scan": (ops.selective_scan, (a, b, h0), {},
                           cost.selective_scan_work(1, 8, 6, 4)),
        "moe_gmm": (ops.moe_gmm, (x, w), {}, cost.moe_gmm_work(4, 5, 16, 12, 4)),
    }


@pytest.mark.parametrize("name", ["flash_attention", "flash_decode",
                                  "selective_scan", "moe_gmm"])
def test_meta_route(name):
    """The meta output has the CPU plain output's shape and dtype; the
    call adds the formula's operations and bytes to the active counter and
    counts a meta call, not a launch."""
    fn, args, kw, work = _kernel_cases()[name]
    want = fn(*args, **kw)
    meta_args = [t.to("meta") for t in args]
    meta_kw = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
               for k, v in kw.items()}
    ops.reset_launch_counts()
    ops.reset_meta_calls()
    with OpCounter() as c:
        got = fn(*meta_args, **meta_kw)
    assert got.is_meta and got.shape == want.shape and got.dtype == want.dtype
    assert c.counts.kernel_calls == {name: 1}
    assert (c.counts.kernel_flops, c.counts.kernel_bytes) == (work.flops, work.bytes)
    assert c.counts.flops == work.flops and c.counts.bytes == work.bytes
    assert fn.meta_calls == 1 and fn.launches == 0
    with pytest.raises(ValueError, match="need all CPU, all CUDA or all meta"):
        fn(*([meta_args[0]] + list(args[1:])), **kw)


def test_scenario_scan_meta_route():
    L, N, R, NREG, W, E, G = 3, 10, 2, 2, 4, 5, 7
    f64, i64 = torch.float64, torch.int64
    m = lambda *s, dt=f64: torch.empty(*s, dtype=dt, device="meta")  # noqa: E731
    args = (m(L, N), m(L, N), m(L, N, dt=i64), m(L, R, NREG),
            m(L, W, R, dt=torch.bool), m(L, E, dt=i64), m(L, E, dt=i64), m(L),
            m(G), m(G, dt=i64), m(G, dt=i64))
    with OpCounter() as c:
        out = ops.scenario_scan(*args, Q=4, C=2, amax=3, lb_rr=False,
                                expire_on=True, trace_on=True)
    assert {k: (tuple(v.shape), v.dtype) for k, v in out.items()} == {
        "status": ((L, N), torch.int8), "e2e": ((L, N), f64), "a_ptr": ((L,), i64),
        "run_n": ((L, R), i64), "q_cnt": ((L, R), i64), "n_retried": ((L,), i64),
        "overflow": ((L,), torch.bool), "disp_t": ((L, N), f64),
        "start_t": ((L, N), f64), "fin_t": ((L, N), f64), "rep": ((L, N), i64)}
    work = cost.scenario_scan_work(L, N, R, NREG, W, E, G, True)
    assert c.counts.kernel_calls == {"scenario_scan": 1}
    assert c.counts.kernel_bytes == work.bytes


def test_kernel_impl_counts_one_call_per_layer():
    """A smoke llama's serve and prefill steps on one device with
    impl="kernel": one flash_decode per layer and decode step, one
    flash_attention per layer and prefill; the argument bytes are the
    parameters', the tokens' and the cache's."""
    cfg = get_smoke_config("llama3.2-1b")
    shape = ShapeSpec("s", 32, 2, "decode")
    built = build_mesh_serve_step(cfg, None, shape, impl="kernel")
    _, c = count_step(built.run)
    assert c.kernel_calls == {"flash_decode": cfg.num_layers}
    model = built.model
    assert built.arg_bytes()["params"] == sum(
        p.nbytes for p in model.parameters())
    assert built.arg_bytes()["cache"] == sum(
        t.nbytes for t in (model.init_cache(2, 32)["kv"].values())) + 4
    built = build_mesh_prefill_step(cfg, None, ShapeSpec("s", 32, 2, "prefill"),
                                    impl="kernel")
    _, c = count_step(built.run)
    assert c.kernel_calls == {"flash_attention": cfg.num_layers}


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


def _split_bytes(shape, spec, mesh_sizes, itemsize):
    """One device's bytes of a tensor under a reference spec."""
    n = 1
    for d, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        div = 1
        for a in ((ax,) if isinstance(ax, str) else (ax or ())):
            div *= mesh_sizes[a]
        n *= d // div
    return n * itemsize


def test_run_cell_decode_argument_bytes(node_mesh, tmp_path, monkeypatch):
    """llama3.2-1b decode_32k on the (2, 4) mesh: one device's argument
    bytes equal the reference's abstract arguments split by its specs
    (the tokens at the port's int64); the record has the reference's
    fields with fits_hbm_80gib."""
    from repro.launch.steps import build_step as j_build_step

    monkeypatch.chdir(tmp_path)
    rec = dryrun.run_cell("llama3.2-1b", "decode_32k", multi_pod=False,
                          verbose=False)
    jb = j_build_step("llama3.2-1b", "decode_32k",
                      AbstractMesh((2, 4), ("data", "model")))
    sizes = {"data": 2, "model": 4}
    want = {}
    for name, arg, shard in zip(("params", "tokens", "cache"), jb.abstract_args,
                                jb.in_shardings):
        specs = dict(_leaves(shard))
        want[name] = sum(
            _split_bytes(s.shape, specs[p].spec, sizes,
                         8 if name == "tokens" else s.dtype.itemsize)
            for p, s in _leaves(arg))
    got = rec["memory_analysis"]["argument_bytes_by_name"]
    assert got == want
    assert rec["memory_analysis"]["argument_size_in_bytes"] == sum(want.values())
    assert rec["status"] == "run" and rec["chips"] == 8
    assert rec["mesh_desc"] == "2x4:data,model"
    assert rec["fits_hbm_80gib"] is True and "fits_hbm_16gib" not in rec
    assert rec["hlo_counts"]["flops"] > 0 and rec["roofline"]["bottleneck"]
    path = dryrun.save_record(rec)
    assert path.startswith(os.path.join("artifacts", "dryrun_h100"))


def test_cli_records_the_reference_skip(node_mesh, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "long_500k",
                        "--mesh", "single"]) == 0
    out = capsys.readouterr().out
    assert "skip: quadratic full attention" in out
    assert re.search(r"all 1 cells OK", out)
    assert os.path.exists(os.path.join(
        "artifacts", "dryrun_h100", "llama3.2-1b__long_500k__single.json"))
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "long_500k",
                        "--skip-existing"]) == 0
    assert "skip existing" in capsys.readouterr().out


def test_refused_call_runs_replicated(node_mesh):
    """A call DTensor refuses (unbinding a sharded dimension) runs on the
    inputs gathered whole and is counted; a dunder is not taken for an
    in-place call; the collectives of the gathering are counted too."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from repro_torch.launch.steps import ReplicateOnRefusal

    x = distribute_tensor(torch.empty(4, 1, 8, 6, device="meta"), node_mesh,
                          [Shard(0), Replicate()])
    fallback = ReplicateOnRefusal()
    with OpCounter() as c, fallback:
        parts = list(x)
        y = x[..., None]
    assert fallback.refused == {"unbind": 1} and "unbind" in fallback.errors[
        "unbind"]
    assert len(parts) == 4 and all(isinstance(p, DTensor) for p in parts)
    assert parts[0].shape == (1, 8, 6)
    assert y.shape == (4, 1, 8, 6, 1) and tuple(x.shape) == (4, 1, 8, 6)
    assert c.counts.coll_counts.get("all-gather", 0) >= 1


@pytest.mark.parametrize("kind", ["decode", "prefill", "train"])
def test_scaled_counts_equal_the_whole_run(kind):
    """Counting at 1 and 2 layers (and a train step at 2 and 3
    microbatches) and extrapolating gives what running every layer and
    microbatch counts: a 4-layer llama, 4 microbatches."""
    import dataclasses

    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), num_layers=4)
    shape = ShapeSpec("s", 64, 8 if kind == "train" else 2, kind)
    kw = {"microbatches": 4} if kind == "train" else {"impl": "kernel"}
    scaled, _, _, how = dryrun.count_cell(cfg, shape, None, **kw)
    whole, _, _, _ = dryrun.count_cell(cfg, shape, None, scale=False, **kw)
    assert how["scaled"] and how["full_units"] == 4
    for f in ("flops", "bytes", "kernel_flops", "kernel_bytes", "kernel_calls",
              "ops", "out_bytes"):
        assert getattr(scaled, f) == pytest.approx(getattr(whole, f)), f
