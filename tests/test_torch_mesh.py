"""The port's mesh (``repro_torch.distributed.{sharding,elastic}``,
``launch.mesh``, ``configs.shapes``) against the reference.

Placements are held against the reference's ``logical_to_pspec`` for every
parameter and cache leaf of all ten architectures at full width, on meshes
(1, 1), (2, 4), (2, 2, 4), (16, 16) and (2, 16, 16): abstract shapes only,
nothing allocated.  The reference's side is built on
``jax.sharding.AbstractMesh``, the port's on ``DeviceMesh``es over a
``"fake"`` process group of 512 ranks (a module fixture sets it up and
destroys it).  The multi-rank test runs 4 gloo processes on the CPU.
"""

import math
import os
import socket

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import cells_for as j_cells_for  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.distributed import elastic as jel  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch.steps import _cache_pspec_tree  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import abstract_params as j_abstract_params  # noqa: E402
from repro.models import logical_axes as j_logical_axes  # noqa: E402
from repro.obs import registry as jreg  # noqa: E402
from repro_torch import migration as tmig  # noqa: E402
from repro_torch.configs import SHAPES, ShapeSpec, cells_for, get_config  # noqa: E402
from repro_torch.distributed import elastic as tel  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.steps import cache_logical  # noqa: E402
from repro_torch.migration.cost import plan_reshard  # noqa: E402
from repro_torch.models.base import abstract_params, logical_axes  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.obs import registry as treg  # noqa: E402

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "2x2x4": ((2, 2, 4), ("pod", "data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


@pytest.fixture(scope="module")
def fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    yield
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def meshes(fake_group):
    return {k: tmesh.make_mesh(shape, axes) for k, (shape, axes) in MESHES.items()}


# ---------------------------------------------------------------------------
# shapes and rules
# ---------------------------------------------------------------------------


def test_shapes_match_reference():
    assert {k: (v.name, v.seq_len, v.global_batch, v.kind)
            for k, v in SHAPES.items()} == {
        k: (v.name, v.seq_len, v.global_batch, v.kind)
        for k, v in J_SHAPES.items()}
    assert ShapeSpec("x", 1, 2, "decode") == ShapeSpec("x", 1, 2, "decode")
    for arch in ARCH_IDS:
        assert cells_for(get_config(arch)) == j_cells_for(j_config(arch))


def test_rules_match_reference():
    assert tsh.RULESETS == jsh.RULESETS
    for name in tsh.RULESETS:
        assert tsh.make_rules(name, {"seq": "data"}) == jsh.make_rules(
            name, {"seq": "data"})


# ---------------------------------------------------------------------------
# placements against the reference's specs
# ---------------------------------------------------------------------------


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _serving_caches(arch):
    """(port cache on meta, reference abstract cache) at each shape's
    serving size."""
    cfg, jcfg = get_config(arch), j_config(arch)
    model = build_model(cfg, device="meta", dtype=torch.bfloat16)
    jmodel = j_build(jcfg)
    for shape in SHAPES.values():
        n = shape.seq_len + (cfg.frontend_seq if cfg.frontend and not
                             cfg.is_encdec else 0)
        yield (model.init_cache(shape.global_batch, n),
               jmodel.abstract_cache(shape.global_batch, n))


def _spec(ps):
    return tuple(ps)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_placements_match_reference(mesh_name, meshes):
    """Every parameter and cache leaf of all ten archs at full width: the
    port's placements, written as a spec, equal the reference's spec, and
    the fallbacks counted on the two registries are equal."""
    shape, axes = MESHES[mesh_name]
    tm, jm = meshes[mesh_name], AbstractMesh(shape, axes)
    assert tuple(tm.mesh_dim_names) == tuple(jm.axis_names)
    assert tuple(tm.shape) == tuple(jm.shape[a] for a in jm.axis_names)
    n_leaves = 0
    with treg.use_registry(treg.MetricsRegistry()) as treg_run, \
            jreg.use_registry(jreg.MetricsRegistry()) as jreg_run:
        for arch in ARCH_IDS:
            rules = tsh.make_rules("tp")
            bp = build_model(get_config(arch), device="meta").blueprint()
            jbp = j_build(j_config(arch)).blueprint()
            t_ab, t_lg = abstract_params(bp, torch.bfloat16), dict(
                _leaves(logical_axes(bp)))
            j_ab = dict(_leaves(j_abstract_params(jbp)))
            j_lg = dict(_leaves(j_logical_axes(jbp)))
            for path, t in _leaves(t_ab):
                lg = t_lg[path]
                got = tsh.pspec_of(tsh.logical_to_placements(
                    lg, t.shape, tm, rules), t.dim(), tm)
                want = jsh.logical_to_pspec(j_lg[path], j_ab[path].shape,
                                            jm, jsh.make_rules("tp"))
                assert got == _spec(want), (arch, path)
                n_leaves += 1
            crules = tsh.make_rules("decode_cp")
            for cache, jcache in _serving_caches(arch):
                jspecs = dict(_leaves(_cache_pspec_tree(
                    jcache, jm, jsh.make_rules("decode_cp"))))
                clg = dict(_leaves(cache_logical(cache)))
                for path, t in _leaves(cache):
                    if path == ("cross_valid",):
                        continue    # the port's own cross mask
                    got = tsh.pspec_of(tsh.logical_to_placements(
                        clg[path], t.shape, tm, crules), t.dim(), tm)
                    assert got == _spec(jspecs[path]), (arch, path)
                    n_leaves += 1
        assert treg_run.snapshot() == jreg_run.snapshot()
    assert n_leaves == 308         # 10 archs: stacked parameter leaves + 4 caches
    if mesh_name == "2x4":
        # paligemma's one KV head on the 4-way model axis
        fell = treg_run.snapshot()["counters"]
        assert any("kv_heads" in k and "size=4" in k for k in fell)


def test_pspec_of_and_tuple_axis(meshes):
    tm = meshes["2x2x4"]
    pl = tsh.logical_to_placements(("batch", "seq", "heads", "head_dim"),
                                   (8, 16, 32, 64), tm, tsh.RULESETS["tp"])
    from torch.distributed.tensor import Replicate, Shard

    assert pl == (Shard(0), Shard(0), Shard(2))
    assert tsh.pspec_of(pl, 4, tm) == (("pod", "data"), None, "model")
    assert tsh.pspec_of((Replicate(),) * 3, 2, tm) == ()
    # the 'pod' axis is dropped on one node
    tm1 = meshes["2x4"]
    assert tsh.pspec_of(tsh.logical_to_placements(
        ("batch",), (8,), tm1, tsh.RULESETS["tp"]), 1, tm1) == ("data",)


def test_fallback_counted_every_time_logged_once(meshes, caplog):
    tm = meshes["2x4"]
    with treg.use_registry(treg.MetricsRegistry()) as reg:
        with caplog.at_level("INFO", logger="repro_torch.distributed.sharding"):
            tsh._warned.discard(("kv_heads", "model", 1, 4))
            for _ in range(3):
                pl = tsh.logical_to_placements(("embed", "kv_heads"), (16, 1),
                                               tm, tsh.RULESETS["tp"])
        assert tsh.pspec_of(pl, 2, tm) == ()
        assert reg.counter("sharding_replication_fallback", axis="kv_heads",
                           mesh_axis="model", dim=1, size=4) == 3
    assert sum("sharding fallback" in r.message for r in caplog.records) == 1


def test_constrain_and_distribute(meshes):
    x = torch.ones(4, 8)
    assert tsh.constrain(x, "batch", "act_embed") is x
    tm = meshes["2x4"]
    from torch.distributed.tensor import Replicate, Shard

    dt = tsh.distribute_params({"w": torch.empty(8, 16, device="meta")},
                               {"w": ("embed", "mlp")}, tm,
                               tsh.RULESETS["tp"])["w"]
    assert tuple(dt.placements) == (Replicate(), Shard(1))
    assert dt.to_local().shape == (8, 4) and dt.to_local().is_meta
    y = tsh.constrain(dt, "embed", None)
    assert tuple(y.placements) == (Replicate(), Replicate())


# ---------------------------------------------------------------------------
# elastic re-mesh
# ---------------------------------------------------------------------------

REMESH_GRID = [
    ((16, 16), ("data", "model")),
    ((2, 16, 16), ("pod", "data", "model")),
    ((2, 4), ("data", "model")),
    ((2, 2, 4), ("pod", "data", "model")),
    ((8, 1), ("data", "model")),
]


def _plan_or_error(mod, mesh, n, **kw):
    try:
        p = mod.plan_remesh(mesh, n, **kw)
    except ValueError as e:
        return ("error", str(e))
    return (p.old_shape, p.new_shape, p.axis_names, p.dropped_chips,
            p.new_chip_count)


@pytest.mark.parametrize("shape,axes", REMESH_GRID)
def test_plan_remesh_matches_reference(shape, axes):
    jm = AbstractMesh(shape, axes)
    tm = type("M", (), {"mesh_dim_names": axes, "shape": shape})()
    chips = math.prod(shape)
    for n in sorted({0, 1, 2, 3, chips // 4, chips // 2 + 1, chips - 1,
                     chips, chips + 5}):
        for axis in ("data", "model", "pod"):
            want = _plan_or_error(jel, jm, n, shrink_axis=axis)
            got = _plan_or_error(tel, tm, n, shrink_axis=axis)
            assert got == want, (n, axis)
            cost = plan_reshard(shape, axes, n, bandwidth_bytes_per_s=1e9,
                                shrink_axis=axis) if axis in axes else None
            if got[0] == "error":
                assert cost is None
            else:
                p = tel.plan_remesh(tm, n, shrink_axis=axis)
                assert cost.to_remesh_plan() == p
                assert cost.new_chip_count == p.new_chip_count


def test_remesh_plan_lives_in_elastic():
    assert tmig.RemeshPlan is tel.RemeshPlan
    from repro_torch.migration import cost

    assert cost.RemeshPlan is tel.RemeshPlan
    p = tel.RemeshPlan((4, 2), (2, 2), ("data", "model"), 4)
    assert p.new_chip_count == 4
    src = open(cost.__file__).read()
    assert "try:" not in src.split("RemeshPlan")[0]


# ---------------------------------------------------------------------------
# mesh builders
# ---------------------------------------------------------------------------


def test_mesh_builders(fake_group):
    single = tmesh.make_production_mesh()
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert (tuple(single.shape), single.mesh_dim_names) == ((2, 4), ("data", "model"))
    assert (tuple(multi.shape), multi.mesh_dim_names) == (
        (2, 2, 4), ("pod", "data", "model"))
    assert single.device_type == "cpu"
    assert tmesh.mesh_chip_count(single) == 8 and tmesh.mesh_chip_count(multi) == 16
    assert tmesh.data_axis_size(single) == 2 and tmesh.data_axis_size(multi) == 4
    host = tmesh.make_host_mesh()
    assert tuple(host.shape) == (1, 1) and tmesh.mesh_chip_count(host) == 1
    with pytest.raises(ValueError, match="needs 1024 ranks"):
        tmesh.make_mesh((32, 32), ("data", "model"))
    plan = tel.plan_remesh(single, 5)
    assert plan.new_shape == (1, 4)
    assert tuple(tel.build_mesh(plan).shape) == (1, 4)


# ---------------------------------------------------------------------------
# four gloo ranks: a smoke llama sharded by tp on (2, 2), then re-meshed
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        from repro_torch.configs import get_smoke_config
        from repro_torch.distributed import elastic, sharding
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.registry import build_model

        cfg = get_smoke_config("llama3.2-1b")
        model = build_model(cfg, device="cpu", impl="plain",
                            generator=torch.Generator().manual_seed(3))
        full = {k: p.detach().clone() for k, p in model.named_parameters()}
        logical = sharding.model_logical(model)
        mesh = make_mesh((2, 2), ("data", "model"))
        rules = sharding.make_rules("tp")
        placed = sharding.distribute_params(full, logical, mesh, rules)
        coord = mesh.get_coordinate()
        sharded = 0
        for k, dt in placed.items():
            want = full[k]
            for i, p in enumerate(dt.placements):
                if isinstance(p, Shard):
                    want = want.chunk(mesh.shape[i], p.dim)[coord[i]]
                    sharded += 1
            assert torch.equal(dt.to_local(), want), k
        assert sharded > 0
        plan = elastic.plan_remesh(mesh, 2)
        assert plan.new_shape == (1, 2) and plan.dropped_chips == 2
        new_mesh = elastic.build_mesh(plan)
        moved = elastic.reshard(placed, logical, new_mesh, rules)
        if new_mesh.get_coordinate() is not None:
            for k, dt in moved.items():
                assert torch.equal(dt.full_tensor(), full[k]), k
        # a cache sharded over its slots, written context-parallel, and
        # logits sharded over the vocabulary, picked vocabulary-parallel:
        # both equal their plain forms
        from torch.distributed.tensor import Replicate, distribute_tensor

        from repro_torch.models.attention import write_slot
        from repro_torch.models.lm import label_logits

        g = torch.Generator().manual_seed(5)
        cache = torch.randn(2, 8, 2, 4, generator=g)
        new = torch.randn(2, 1, 2, 4, generator=g)
        for at in (0, 3, 5, 7):
            slot = torch.tensor([at])
            dc = distribute_tensor(cache.clone(), mesh, [Replicate(), Shard(1)])
            write_slot(dc, distribute_tensor(slot, mesh, [Replicate()] * 2),
                       distribute_tensor(new, mesh, [Replicate()] * 2))
            want = cache.clone()
            want.index_copy_(1, slot, new)
            assert torch.equal(dc.full_tensor(), want), at
        logits = torch.randn(2, 3, 16, generator=g)
        labels = torch.randint(0, 16, (2, 3), generator=g)
        dl = distribute_tensor(logits, mesh, [Shard(0), Shard(2)])
        got = label_logits(dl, distribute_tensor(labels, mesh, [Shard(0), Replicate()]))
        assert torch.equal(got.full_tensor(), label_logits(logits, labels))
        with open(os.path.join(out_dir, f"rank{rank}.ok"), "w") as f:
            f.write(f"{sharded}")
    finally:
        dist.destroy_process_group()


def test_four_gloo_ranks_shard_and_reshard(tmp_path):
    import torch.multiprocessing as mp

    mp.start_processes(_rank_main, args=(4, _free_port(), str(tmp_path)),
                       nprocs=4, join=True, start_method="spawn")
    assert sorted(os.listdir(tmp_path)) == [f"rank{r}.ok" for r in range(4)]


# ---------------------------------------------------------------------------
# the new modules fall under the port's import rule
# ---------------------------------------------------------------------------

MESH_MODULES = (
    "repro_torch.configs.shapes",
    "repro_torch.distributed.elastic",
    "repro_torch.distributed.sharding",
    "repro_torch.kernels.cost",
    "repro_torch.launch.analysis",
    "repro_torch.launch.dryrun",
    "repro_torch.launch.mesh",
    "repro_torch.launch.op_count",
)


def test_mesh_modules_fall_under_the_import_rule():
    import pkgutil

    import repro_torch
    from test_torch_package import SRC, _sources

    walked = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                    "repro_torch.")}
    assert set(MESH_MODULES) <= walked
    scanned = {os.path.relpath(f, SRC) for f in _sources()}
    for mod in MESH_MODULES:
        assert mod.replace(".", os.sep) + ".py" in scanned, mod


def test_models_take_meta_where_asked():
    from repro_torch import resolve_device

    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    assert resolve_device("meta", allow_meta=True).type == "meta"
    model = build_model(get_config("zamba2-7b"), device="meta",
                        dtype=torch.bfloat16)
    assert all(p.is_meta for p in model.parameters())
    assert model.num_params() == sum(p.numel() for p in model.parameters())
