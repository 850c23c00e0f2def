"""Context-parallel decode: flash_decode's log-sum-exp, the merge of slot
shards, and a cache sharded over its slots attended where it lies
(``kernels.ops.slot_parallel_decode``), against the reference.

* The plain version's log-sum-exp against NumPy's, its output against the
  reference's ``decode_attention`` and ``flash_decode_bhd`` (Pallas,
  interpret mode), at the reference's 2e-5 (float32) and 2e-2 (bfloat16).
* ``merge_decode_partials`` over 1, 2, 4 and 8 slot shards (shards with no
  valid slot, a sliding window's ring, no valid slot anywhere) against the
  whole cache.
* The dry run's link bytes of a smoke llama's decode step under
  ``decode_cp`` on the ``"fake"`` (2, 4) mesh do not grow with the cache
  (the cache was gathered to every device each layer and step before);
  full-width llama3.2-1b at ``decode_32k`` is bound by reading its own
  slots; a 14-layer zamba2's decode step gathers the new Mamba-2 states'
  heads into the cache exactly as many bytes as the reference's
  partitioner does on the same (2, 4) mesh.
* Four gloo ranks on a (2, 2) mesh under ``tp`` + ``decode_cp`` decode a
  smoke llama (the reference's weights) for 8 steps: the reference's
  greedy tokens, its logits within tolerance, each rank's cache shard the
  whole cache's slice.

The card's own checks of the kernel's log-sum-exp and of a slot split on
one card are in ``test_torch_cuda.py``.
"""

import functools
import os
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.kernels.flash_decode import flash_decode_bhd  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models.attention import decode_attention as j_decode_attention  # noqa: E402
from repro_torch.configs import ShapeSpec, get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import cost, ops  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.launch import dryrun, op_count  # noqa: E402
from repro_torch.launch.op_count import OpCounter  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.registry import build_model as t_build  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
NEG_INF = -1e30


def _pair(rng, shape, dtype_name):
    jdt, tdt, _ = DTYPES[dtype_name]
    x = rng.standard_normal(shape, dtype=np.float32)
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _mask(kind, B, S):
    """(B, S) bool: "prefix" (occupancy, a row each), "ring" (a sliding
    window's live slots wrapping past the end), "one" (one valid slot),
    "empty beside prefix" (a row with none beside a partial one), "none"."""
    pos = np.arange(S)[None, :].repeat(B, 0)
    if kind == "prefix":
        valid = pos < np.array([[S // 5], [S - 3]])[:B]
    elif kind == "ring":
        valid = (pos - (S - S // 8)) % S < S // 3
    elif kind == "one":
        valid = pos == np.array([[S // 2 + 1], [S - 1]])[:B]
    elif kind == "empty beside prefix":
        valid = pos < np.array([[0], [S // 3]])[:B]
    elif kind == "none":
        valid = np.zeros((B, S), bool)
    else:
        raise ValueError(kind)
    return valid


def _lse_numpy(q, k, valid):
    """log-sum-exp of each row's scaled, masked scores, float64: q (B, H,
    D), k (B, S, Kv, D) as float32 arrays, valid (B, S)."""
    B, H, D = q.shape
    Kv = k.shape[2]
    qg = q.reshape(B, Kv, H // Kv, D).astype(np.float64)
    s = np.einsum("bkgd,bmkd->bkgm", qg, k.astype(np.float64)) / np.sqrt(D)
    s = np.where(valid[:, None, None, :], s, NEG_INF)
    m = s.max(-1, keepdims=True)
    return (m[..., 0] + np.log(np.exp(s - m).sum(-1))).reshape(B, H)


MASKS = ["prefix", "ring", "one", "empty beside prefix", "none"]


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_lse_and_output_match_reference(kind, dtype):
    """The plain version's log-sum-exp equals NumPy's; with it the output
    comes in fp32 and equals the reference's ``decode_attention`` and the
    Pallas kernel; ``ops.flash_decode`` and the model's
    ``decode_attention`` give the same partial on the CPU."""
    B, H, Kv, S, D = 2, 8, 2, 256, 64
    tol = DTYPES[dtype][2]
    rng = np.random.default_rng(MASKS.index(kind))
    jq, tq = _pair(rng, (B, 1, H, D), dtype)
    jk, tk = _pair(rng, (B, S, Kv, D), dtype)
    jv, tv = _pair(rng, (B, S, Kv, D), dtype)
    valid = _mask(kind, B, S)
    tvalid = torch.from_numpy(valid)
    out, lse = tfd.plain(tq, tk, tv, tvalid, return_lse=True)
    assert out.dtype == torch.float32 and out.shape == (B, 1, H, D)
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    want_lse = _lse_numpy(_np(tq)[:, 0], _np(tk), valid)
    np.testing.assert_allclose(lse.double().numpy(), want_lse, rtol=2e-5,
                               atol=2e-5)
    assert torch.isfinite(lse).all()
    empty = torch.from_numpy(~valid.any(-1))
    assert (lse[empty] == NEG_INF).all()     # finite: weighs 0 in a merge
    oracle = j_decode_attention(jq, jk, jv, kv_valid=jnp.asarray(valid))
    pallas = flash_decode_bhd(jq[:, 0], jnp.swapaxes(jk, 1, 2),
                              jnp.swapaxes(jv, 1, 2),
                              jnp.asarray(valid.astype(np.int8)),
                              block_kv=128, interpret=True)
    np.testing.assert_allclose(_np(out), _np(oracle), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(out)[:, 0], _np(pallas), atol=tol, rtol=tol)
    # without the log-sum-exp: q's dtype, as before
    assert torch.equal(tfd.plain(tq, tk, tv, tvalid), out.to(tq.dtype))
    o2, l2 = ops.flash_decode(tq, tk, tv, kv_valid=tvalid, return_lse=True)
    assert torch.equal(o2, out) and torch.equal(l2, lse)
    o3, l3 = tattn.decode_attention(tq, tk, tv, kv_valid=tvalid,
                                    return_lse=True)
    torch.testing.assert_close(o3, out, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(l3, lse, atol=1e-5, rtol=1e-6)


SPLIT_MASKS = ["prefix", "ring", "one", "empty beside prefix", "none"]


@pytest.mark.parametrize("kind", SPLIT_MASKS)
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_of_slot_shards_is_the_whole_cache(kind, shards, dtype):
    """A cache cut into equal slot shards, each through the plain version
    with its log-sum-exp, merged: the whole cache's output (the plain
    version's and the reference's) at the reference's tolerances.  Shards
    with no valid slot weigh nothing; where no slot is valid at all the
    merged row is the mean of the shards' means, the whole cache's mean
    over every slot."""
    B, H, Kv, S, D = 2, 8, 2, 512, 64
    _, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(40 + SPLIT_MASKS.index(kind))
    jq, tq = _pair(rng, (B, 1, H, D), dtype)
    jk, tk = _pair(rng, (B, S, Kv, D), dtype)
    jv, tv = _pair(rng, (B, S, Kv, D), dtype)
    valid = torch.from_numpy(_mask(kind, B, S))
    n = S // shards
    parts = [tfd.plain(tq, tk[:, i * n:(i + 1) * n], tv[:, i * n:(i + 1) * n],
                       valid[:, i * n:(i + 1) * n], return_lse=True)
             for i in range(shards)]
    got = tfd.merge_decode_partials([o for o, _ in parts],
                                    [lse for _, lse in parts], dtype=tdt)
    assert got.dtype == tdt and got.shape == (B, 1, H, D)
    whole = tfd.plain(tq, tk, tv, valid)
    oracle = j_decode_attention(jq, jk, jv, kv_valid=jnp.asarray(valid.numpy()))
    np.testing.assert_allclose(_np(got), _np(whole), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol, rtol=tol)
    if kind == "none":      # the mean over every slot, shard by shard
        mean = tv.float().mean(1).repeat_interleave(H // Kv, 1)[:, None]
        np.testing.assert_allclose(_np(got), _np(mean), atol=tol, rtol=tol)


def test_meta_route_returns_the_partial_and_counts_it():
    """With ``return_lse`` the meta route returns an fp32 output and a
    (B, H) log-sum-exp and records the partial's work: the output written
    in fp32 and the log-sum-exp beside it."""
    q = torch.empty(2, 1, 8, 64, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 96, 2, 64, dtype=torch.bfloat16, device="meta")
    valid = torch.empty(2, 96, dtype=torch.bool, device="meta")
    with OpCounter() as c:
        out, lse = ops.flash_decode(q, k, k, kv_valid=valid, return_lse=True)
    assert (out.shape, out.dtype) == ((2, 1, 8, 64), torch.float32)
    assert (lse.shape, lse.dtype) == ((2, 8), torch.float32)
    work = cost.flash_decode_work(2, 8, 2, 96, 64, 2, lse=True)
    plain = cost.flash_decode_work(2, 8, 2, 96, 64, 2)
    assert work.bytes - plain.bytes == 2 * 8 * (64 * 2 + 4)
    assert (c.counts.kernel_flops, c.counts.kernel_bytes) == (work.flops, work.bytes)


def test_indexed_ops_count_the_rows_they_touch():
    """A one-slot write into a cache and a one-slot read count the slot's
    bytes, not the cache's; a gather that repeats rows reads its source at
    most once (``launch.op_count``)."""
    cache = torch.empty(4, 1024, 8, 64, device="meta")
    new = torch.empty(4, 1, 8, 64, device="meta")
    at = torch.empty(1, dtype=torch.long, device="meta")
    with OpCounter() as c:
        cache.index_copy_(1, at, new)
    assert c.counts.bytes == 8 + 2 * new.nbytes
    with OpCounter() as c:
        cache.index_select(1, at)
    assert c.counts.bytes == 8 + 2 * new.nbytes
    table = torch.empty(16, 32, device="meta")
    rows = torch.empty(64, dtype=torch.long, device="meta")
    with OpCounter() as c:
        out = table[rows]
    assert c.counts.bytes == rows.nbytes + out.nbytes + table.nbytes


# ---------------------------------------------------------------------------
# the dry run: a cache sharded over its slots stays where it lies
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def node_mesh():
    """A ``"fake"`` group of 16 ranks and the (2, 4) node mesh."""
    from repro_torch.launch.mesh import make_production_mesh

    dryrun.init_fake_group(16)
    yield make_production_mesh()
    dist.destroy_process_group()


@pytest.mark.parametrize("impl", ["blockwise", "kernel"])
def test_link_bytes_do_not_grow_with_the_cache(node_mesh, impl):
    """A smoke llama's decode step (``build_mesh_serve_step``, the cache
    under ``decode_cp``) on the (2, 4) mesh at S and 4 S slots: one
    device's link bytes equal within 1 %, and below one layer's K cache,
    which gathering the cache would move each layer and step."""
    cfg = get_smoke_config("llama3.2-1b")
    counts = {}
    for S in (1024, 4096):
        shape = ShapeSpec("decode", S, 4, "decode")
        counts[S], refused, _, _ = dryrun.count_cell(cfg, shape, node_mesh,
                                                     impl=impl, scale=False)
        assert refused == {}
        if impl == "kernel":
            assert counts[S].kernel_calls == {"flash_decode": cfg.num_layers}
    small, big = counts[1024].coll_bytes, counts[4096].coll_bytes
    assert 0 < small and abs(big - small) <= 0.01 * small, (small, big)
    layer_k = 4 * 4096 * cfg.num_kv_heads * cfg.resolved_head_dim * 2
    assert big < layer_k


def test_llama_decode_32k_reads_its_own_slots(node_mesh, tmp_path, monkeypatch):
    """Full-width llama3.2-1b at ``decode_32k`` on the (2, 4) mesh: at most
    1e9 link bytes a device (6.93e10 when each layer gathered the cache),
    bound by memory in at most 10 ms (reading the local cache's 17.2 GB
    takes about 5 ms at 3.35e12 B/s), at most 1.5 GiB of temporaries, the
    FLOPs of the whole cache over 8 devices, and the argument bytes of the
    placed parameters, tokens and cache."""
    monkeypatch.chdir(tmp_path)
    rec = dryrun.run_cell("llama3.2-1b", "decode_32k", multi_pod=False,
                          verbose=False)
    h, rl, ma = rec["hlo_counts"], rec["roofline"], rec["memory_analysis"]
    assert h["collective_link_bytes"] <= 1e9
    assert rl["bottleneck"] == "memory"
    assert max(rl["compute_s"], rl["memory_s"], rl["collective_s"]) <= 10e-3
    assert ma["temp_size_in_bytes"] <= 1.5 * 2**30
    assert h["flops"] == pytest.approx(1.08e11, rel=0.05)
    assert round(ma["argument_size_in_bytes"] / 2**30, 3) == 16.576
    assert h["kernel_calls"] == {"flash_decode": 16}
    assert rec["refused_ops"] == {}


# the reference's zamba2 decode step lowered on a (2, 4) host mesh (its own
# build_serve_step, tp weights, decode_cp cache), in a process of 8 host
# devices: the all-gathers of the Mamba-2 state (float32, trailing dims
# (ssm_head_dim, ssm_state)) and of everything, in result bytes
_REF_ZAMBA_GATHERS = r"""
import json, re
import jax
from repro.configs import ShapeSpec, get_config
from repro.launch.hlo_count import analyze_hlo
from repro.launch.steps import build_serve_step

cfg = get_config("zamba2-7b").scaled(num_layers=14)
mesh = jax.make_mesh((2, 4), ("data", "model"))
built = build_serve_step(cfg, mesh, ShapeSpec("decode", 1024, 4, "decode"))
with mesh:
    hlo = built.jitted().lower(*built.abstract_args).compile().as_text()
state = 0
tail = [cfg.ssm_head_dim, cfg.ssm_state]
for m in re.finditer(r"= f32\[([0-9,]+)\]\S* all-gather\(", hlo):
    dims = [int(d) for d in m.group(1).split(",")]
    if dims[-2:] == tail:
        state += 4 * int(__import__("math").prod(dims))
print(json.dumps({"state": state, "link": analyze_hlo(hlo).coll_bytes}))
"""


@functools.lru_cache(maxsize=None)
def _reference_zamba_gathers():
    """The reference's counts of its 14-layer zamba2 decode step on the
    (2, 4) host mesh (``_REF_ZAMBA_GATHERS``): the state's all-gather bytes
    and every collective's link bytes, a device."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", _REF_ZAMBA_GATHERS], env=env,
                         capture_output=True, text=True, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _zamba_decode_collectives(mesh, monkeypatch):
    """The port's 14-layer zamba2 decode step (batch 4, 1024 slots,
    ``build_mesh_serve_step``) counted on ``mesh`` after a warm-up run:
    (its counts, the functions DTensor refused, each collective's kind,
    result shape and dtype and result bytes)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import op_count

    cfg = get_config("zamba2-7b").scaled(num_layers=14)
    seen = []
    dispatch = op_count.OpCounter.__torch_dispatch__

    def recording(self, func, types, args=(), kwargs=None):
        out = dispatch(self, func, types, args, kwargs)
        name = func._overloadpacket.__name__
        if (out is not NotImplemented and func.namespace == "_c10d_functional"
                and name in op_count._COLLECTIVES):
            seen.append((op_count._COLLECTIVES[name], tuple(out.shape),
                         out.dtype, out.nbytes))
        return out

    monkeypatch.setattr(op_count.OpCounter, "__torch_dispatch__", recording)
    shape = ShapeSpec("decode", 1024, 4, "decode")
    dryrun._count(cfg, shape, mesh, {"impl": "blockwise"})   # warm-up
    seen.clear()
    counts, refused, _ = dryrun._count(cfg, shape, mesh, {"impl": "blockwise"})
    return cfg, counts, refused, list(seen)


def test_zamba2_decode_gathers_its_states_as_the_reference(node_mesh,
                                                           monkeypatch):
    """The new Mamba-2 state leaves the ``tp`` projections with its heads
    sharded, and the ``decode_cp`` cache keeps them replicated (the
    reference's rule): both the reference's partitioner and the port gather
    the heads to write the cache.  A 14-layer zamba2 (2 prelude layers, 2
    super-blocks, d_model 128) at batch 4 and 1024 slots: the state's
    all-gather bytes a device are equal (the reference gathers the stacked
    states once a step, the port each layer's)."""
    ref = _reference_zamba_gathers()
    cfg, _, refused, seen = _zamba_decode_collectives(node_mesh, monkeypatch)
    tail = (cfg.ssm_head_dim, cfg.ssm_state)
    gathered = [n for kind, shape, dtype, n in seen
                if kind == "all-gather" and dtype == torch.float32
                and shape[-2:] == tail]
    assert refused == {}
    n_mamba = cfg.hybrid_prelude + cfg.hybrid_blocks * (cfg.hybrid_attn_every - 1)
    assert len(gathered) == n_mamba
    assert ref["state"] > 0 and sum(gathered) == ref["state"]


def test_zamba2_decode_link_bytes_are_the_references(node_mesh, monkeypatch):
    """The same step's link bytes a device are within 10 % of the
    reference's HLO count (its partitioner keeps every weight where it
    lies): the shared block's MLP reads its ``model``-sharded weights
    with the residual stream whole on each device (Megatron's layout,
    restored after the attention's row-parallel sum), the embedding is
    looked up in each device's vocabulary shard and summed, and the greedy
    pick reduces each device's shard of the logits to a value and an
    index a row.  So no all-gather has the shape of a weight of the shared
    block's MLP, of the embedding table, or of a row of logits.  The parent
    counted 1.25e6 B against the reference's 4.81e5."""
    ref = _reference_zamba_gathers()
    cfg, counts, refused, seen = _zamba_decode_collectives(node_mesh,
                                                           monkeypatch)
    assert refused == {}
    assert abs(counts.coll_bytes - ref["link"]) <= 0.1 * ref["link"], (
        counts.coll_bytes, ref["link"])
    d, f, V = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    weights = {(d, f), (f, d), (V, d), (d, V)}
    for kind, shape, dtype, n in seen:
        if kind != "all-gather":
            continue
        assert shape[-2:] not in weights, (shape, n)
        assert shape[-1] != V, (shape, n)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "paligemma-3b",
                                  "command-r-35b", "whisper-medium",
                                  "falcon-mamba-7b"])
def test_decode_step_gathers_no_weight_table_or_logits(node_mesh, monkeypatch,
                                                       arch):
    """Every decoder's greedy step on the (2, 4) mesh (smoke widths, batch 4,
    1024 slots, ``build_mesh_serve_step``): the embedding is looked up in
    each device's vocabulary shard, the projections read their sharded
    weights with the residual stream whole (Megatron's layout), and the
    greedy pick reduces each device's logits to a value and an index a
    row, as the reference's partitioner does.  So no all-gather has the
    shape of a weight matrix (the embedding or unembedding table, an MLP
    matrix) or of a row of logits; before, the table and the (B, V)
    logits were gathered to every device each step."""
    cfg = get_smoke_config(arch)
    seen = []
    dispatch = op_count.OpCounter.__torch_dispatch__

    def recording(self, func, types, args=(), kwargs=None):
        out = dispatch(self, func, types, args, kwargs)
        if (out is not NotImplemented and func.namespace == "_c10d_functional"
                and func._overloadpacket.__name__ == "all_gather_into_tensor"):
            seen.append(tuple(out.shape))
        return out

    monkeypatch.setattr(op_count.OpCounter, "__torch_dispatch__", recording)
    shape = ShapeSpec("decode", 1024, 4, "decode")
    dryrun._count(cfg, shape, node_mesh, {"impl": "kernel"})   # warm-up
    seen.clear()
    _, refused, _ = dryrun._count(cfg, shape, node_mesh, {"impl": "kernel"})
    assert refused == {}
    d, V = cfg.d_model, cfg.padded_vocab
    weights = {(V, d), (d, V)}
    if cfg.d_ff:
        weights |= {(d, cfg.d_ff), (cfg.d_ff, d)}
    for gathered in seen:
        assert gathered[-2:] not in weights and gathered[-1] != V, gathered


# ---------------------------------------------------------------------------
# four gloo ranks: a smoke llama decoded with its cache sharded over slots
# ---------------------------------------------------------------------------

B, PROMPT, SLOTS, STEPS = 2, 12, 32, 8
TOL = 2e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cp_rank(rank: int, world: int, port: int, data_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor
        from torch.distributed.tensor.experimental import implicit_replication

        from repro_torch.configs import get_smoke_config
        from repro_torch.distributed import sharding
        from repro_torch.kernels import ops
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.steps import (
            ReplicateOnRefusal,
            batch_placements,
            cache_logical,
        )
        from repro_torch.models.registry import build_model

        mesh = make_mesh((2, 2), ("data", "model"))
        # the shared offset helper against DTensor's own shards (11 slots:
        # uneven chunks)
        full = torch.arange(4 * 11 * 3).reshape(4, 11, 3)
        for pl in ([Replicate(), Shard(1)], [Shard(1), Shard(1)],
                   [Shard(0), Shard(1)], [Shard(1), Replicate()],
                   [Shard(0), Shard(0)]):
            d = distribute_tensor(full, mesh, pl)
            loc = d.to_local()
            b0, s0 = ops.shard_offset(d, 0), ops.shard_offset(d, 1)
            assert torch.equal(
                full[b0:b0 + loc.shape[0], s0:s0 + loc.shape[1]], loc), pl

        cfg = get_smoke_config("llama3.2-1b")
        state = torch.load(os.path.join(data_dir, "state.pt"))
        prompt = torch.load(os.path.join(data_dir, "prompt.pt"))
        results = {}
        for impl in ("kernel", "blockwise"):
            model = build_model(cfg, device="cpu", impl=impl)
            model.load_state_dict(state)
            cache = model.init_cache(B, SLOTS, dtype=torch.float32)
            with torch.no_grad():
                logits, cache = model.prefill(prompt, cache,
                                              dtype=torch.float32)
            tok = logits.argmax(-1)
            sharding.distribute_module_params(model, mesh,
                                              sharding.make_rules("tp"))
            cache = sharding.distribute_params(
                cache, cache_logical(cache), mesh,
                sharding.make_rules("decode_cp"))
            assert cache["kv"]["k"].placements == (Shard(1), Shard(2))
            fallback = ReplicateOnRefusal()
            toks, logs = [], []
            with torch.no_grad(), implicit_replication(), fallback:
                for _ in range(STEPS):
                    t = distribute_tensor(tok, mesh, batch_placements(mesh, B))
                    lg, cache = model.decode_step(t, cache,
                                                  dtype=torch.float32)
                    lg = lg.full_tensor()
                    tok = lg.argmax(-1)
                    toks.append(tok.clone())
                    logs.append(lg.clone())
            kv = cache["kv"]["k"]
            results[impl] = {
                "tokens": torch.stack(toks), "logits": torch.stack(logs),
                "k": kv.to_local().clone(),
                "v": cache["kv"]["v"].to_local().clone(),
                "b0": ops.shard_offset(kv, 1), "s0": ops.shard_offset(kv, 2),
                "refused": dict(fallback.refused),
            }
        torch.save(results, os.path.join(data_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _reference_run():
    """The reference's smoke llama (its ``init_params``), prefilled with a
    seeded prompt and decoded greedily for STEPS steps in float32: its
    weights as the port's state dict, the prompt, the tokens and logits of
    every step, and the single-device port's run from the same weights
    (tokens, logits, the final cache)."""
    jcfg, tcfg = j_smoke("llama3.2-1b"), get_smoke_config("llama3.2-1b")
    jmodel = j_build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), params)
    state = params_from_jax(tree)
    prompt = np.random.default_rng(7).integers(0, jcfg.vocab_size, (B, PROMPT))
    prefill = jax.jit(functools.partial(jmodel.prefill, dtype=jnp.float32))
    decode = jax.jit(functools.partial(jmodel.decode_step, dtype=jnp.float32))
    jlog, jcache = prefill(params, jnp.asarray(prompt),
                           jmodel.init_cache(B, SLOTS, jnp.float32))
    jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
    jtoks, jlogs = [], []
    for _ in range(STEPS):
        jlog, jcache = decode(params, jtok, jcache)
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        jtoks.append(np.asarray(jtok))
        jlogs.append(np.asarray(jlog))
    model = t_build(tcfg, device="cpu")
    model.load_state_dict(state)
    cache = model.init_cache(B, SLOTS, dtype=torch.float32)
    tprompt = torch.from_numpy(prompt)
    with torch.no_grad():
        log, cache = model.prefill(tprompt, cache, dtype=torch.float32)
        tok = log.argmax(-1)
        ttoks, tlogs = [], []
        for _ in range(STEPS):
            log, cache = model.decode_step(tok, cache, dtype=torch.float32)
            tok = log.argmax(-1)
            ttoks.append(tok.numpy())
            tlogs.append(log.numpy())
    return (state, tprompt, np.stack(jtoks), np.stack(jlogs),
            np.stack(ttoks), np.stack(tlogs), cache)


ZAMBA_B, ZAMBA_PROMPT, ZAMBA_SLOTS, ZAMBA_STEPS = 2, 10, 32, 6


def _zamba_config():
    from repro_torch.configs import get_config

    return get_config("zamba2-7b").scaled(num_layers=14)


def _zamba_rank(rank: int, world: int, port: int, data_dir: str) -> None:
    """One rank of the sharded zamba2 decode: ``tp`` weights and a
    ``decode_cp`` cache on a (2, 2) mesh of gloo ranks, the serve step's
    greedy pick (``launch.steps.greedy_tokens``) on the vocabulary-sharded
    logits."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        from torch.distributed.tensor import DTensor, Shard, distribute_tensor
        from torch.distributed.tensor.experimental import implicit_replication

        from repro_torch.distributed import sharding
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.steps import (
            ReplicateOnRefusal,
            batch_placements,
            cache_logical,
            greedy_tokens,
        )
        from repro_torch.models.registry import build_model

        mesh = make_mesh((2, 2), ("data", "model"))
        # ties across the vocabulary shards go to the lowest index, as
        # argmax picks: a row whose maximum is in every shard, one whose
        # maximum is in the last shard only
        tied = torch.zeros(ZAMBA_B, 1, 512)
        tied[0, 0, [3, 200, 300, 511]] = 1.0
        tied[1, 0, 400] = 2.0
        placed = distribute_tensor(tied, mesh, [Shard(0), Shard(2)])
        assert torch.equal(greedy_tokens(placed).full_tensor(),
                           tied.argmax(-1))
        model = build_model(_zamba_config(), device="cpu")
        model.load_state_dict(torch.load(os.path.join(data_dir, "state.pt")))
        prompt = torch.load(os.path.join(data_dir, "prompt.pt"))
        cache = model.init_cache(ZAMBA_B, ZAMBA_SLOTS, dtype=torch.float32)
        with torch.no_grad():
            logits, cache = model.prefill(prompt, cache, dtype=torch.float32)
        tok = logits.argmax(-1)
        sharding.distribute_module_params(model, mesh,
                                          sharding.make_rules("tp"))
        cache = sharding.distribute_params(cache, cache_logical(cache), mesh,
                                           sharding.make_rules("decode_cp"))
        fallback = ReplicateOnRefusal()
        toks, vocab_sharded = [], []
        with torch.no_grad(), implicit_replication(), fallback:
            for _ in range(ZAMBA_STEPS):
                t = distribute_tensor(tok, mesh,
                                      batch_placements(mesh, ZAMBA_B))
                lg, cache = model.decode_step(t, cache, dtype=torch.float32)
                vocab_sharded.append(any(p.is_shard(2) for p in lg.placements))
                nxt = greedy_tokens(lg)
                assert isinstance(nxt, DTensor)
                tok = nxt.full_tensor()
                toks.append(tok.clone())
        torch.save({"tokens": torch.stack(toks), "refused": dict(fallback.refused),
                    "vocab_sharded": vocab_sharded},
                   os.path.join(data_dir, f"zamba_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_four_gloo_ranks_decode_zamba2_as_one_device(tmp_path):
    """The 14-layer zamba2 (seeded weights, float32) decoded for 6 greedy
    steps on a (2, 2) mesh of gloo ranks under ``tp`` weights and a
    ``decode_cp`` cache, with the residual stream whole before the shared
    block's MLP, the vocabulary-parallel embedding lookup and the greedy
    pick reduced where the logits lie: every rank's tokens equal the
    single-device step's, with no call refused."""
    import torch.multiprocessing as mp

    from repro_torch.models.registry import build_model

    model = build_model(_zamba_config(), device="cpu",
                        generator=torch.Generator().manual_seed(5))
    prompt = torch.from_numpy(np.random.default_rng(8).integers(
        0, model.cfg.vocab_size, (ZAMBA_B, ZAMBA_PROMPT)))
    cache = model.init_cache(ZAMBA_B, ZAMBA_SLOTS, dtype=torch.float32)
    with torch.no_grad():
        logits, cache = model.prefill(prompt, cache, dtype=torch.float32)
        tok = logits.argmax(-1)
        want = []
        for _ in range(ZAMBA_STEPS):
            logits, cache = model.decode_step(tok, cache, dtype=torch.float32)
            tok = logits.argmax(-1)
            want.append(tok)
    want = torch.stack(want)
    torch.save(model.state_dict(), tmp_path / "state.pt")
    torch.save(prompt, tmp_path / "prompt.pt")
    mp.start_processes(_zamba_rank, args=(4, _free_port(), str(tmp_path)),
                       nprocs=4, join=True, start_method="spawn")
    for rank in range(4):
        got = torch.load(tmp_path / f"zamba_rank{rank}.pt")
        assert got["refused"] == {}, rank
        assert all(got["vocab_sharded"]), rank
        assert torch.equal(got["tokens"], want), (rank, got["tokens"], want)


def test_four_gloo_ranks_decode_with_a_slot_sharded_cache(tmp_path):
    """(2, 2) mesh, ``tp`` weights and a ``decode_cp`` cache (batch over
    data, slots over model): 8 greedy steps under ``impl="kernel"`` (the
    wrapper's plain partial on each rank's shards) and ``"blockwise"``
    (``decode_attention``'s), merged across the model ranks.  The second
    slot shard holds no valid slot for the first steps.  Tokens equal the
    single-device port's and the reference's, logits within 2e-5, and each
    rank's cache shard equals the single-device cache's slice."""
    import torch.multiprocessing as mp

    state, prompt, jtoks, jlogs, ttoks, tlogs, tcache = _reference_run()
    torch.save(state, tmp_path / "state.pt")
    torch.save(prompt, tmp_path / "prompt.pt")
    assert np.array_equal(ttoks, jtoks)
    np.testing.assert_allclose(tlogs, jlogs, atol=TOL, rtol=TOL)
    mp.start_processes(_cp_rank, args=(4, _free_port(), str(tmp_path)),
                       nprocs=4, join=True, start_method="spawn")
    for rank in range(4):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        for impl, r in got.items():
            where = f"rank {rank} {impl}"
            assert r["refused"] == {}, where
            assert np.array_equal(r["tokens"].numpy(), jtoks), where
            np.testing.assert_allclose(r["logits"].numpy(), jlogs, atol=TOL,
                                       rtol=TOL, err_msg=where)
            np.testing.assert_allclose(r["logits"].numpy(), tlogs, atol=TOL,
                                       rtol=TOL, err_msg=where)
            b0, s0 = r["b0"], r["s0"]
            for name in ("k", "v"):
                local = r[name]
                want = tcache["kv"][name][:, b0:b0 + local.shape[1],
                                          s0:s0 + local.shape[2]]
                assert local.shape == (2, 1, SLOTS // 2, 1, 32), where
                np.testing.assert_allclose(local.numpy(), want.numpy(),
                                           atol=TOL, rtol=TOL, err_msg=where)
