"""Dry run: every (architecture × input shape) cell on the H100 node meshes,
without a card and without allocating, with its memory, counts and
roofline recorded (counterpart of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape decode_32k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch A B --shape S T

``--arch`` and ``--shape`` take one name (the reference's CLI) or several.

The reference lowers and compiles each cell with XLA on 512 forced host
devices.  The port runs the cell's step itself (``launch.steps.build_step``)
on ``meta`` tensors: on a mesh every tensor is a DTensor whose local shard
is a meta tensor of one device's shape, under a process group of the
``"fake"`` backend with one rank per device of the mesh
(``torch.testing._internal.distributed.fake_pg``: collectives return at
once and move nothing).  A process has one default group, so each process
initialises its own, as the reference's must set its device count before
importing jax.  ``launch.op_count`` counts one device's FLOPs, bytes,
collectives and peak temporaries as the step runs; ``launch.analysis``
prices them at an H100's published rates.  Meshes: ``single`` one 8×H100
node, ("data", "model") = (2, 4); ``multi`` two nodes, ("pod", "data",
"model") = (2, 2, 4) (``launch.mesh``).

Records land in ``artifacts/dryrun_h100/<arch>__<shape>__<mesh>.json``.
Each holds the reference's fields, with ``fits_hbm_80gib`` (an H100's 80
GiB) in place of ``fits_hbm_16gib``; ``memory_analysis`` is one device's
argument, output and peak temporary bytes, ``hlo_counts`` its counts
(named as the reference's), ``lower_s`` the seconds to build the cell and
``compile_s`` the seconds its counted run took (there is no compile).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

ARTIFACT_DIR = os.path.join("artifacts", "dryrun_h100")
HBM_BYTES = 80 * 2**30          # one H100's HBM3


def _mesh_desc(mesh) -> str:
    return "x".join(str(s) for s in tuple(mesh.shape)) + ":" + \
        ",".join(mesh.mesh_dim_names)


def init_fake_group(world_size: int) -> None:
    """This process's default group: the ``"fake"`` backend over
    ``world_size`` ranks, this one rank 0 (kept if one of that size is
    already up)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() >= world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def depth_units(cfg) -> int:
    """The repeating units of ``cfg``'s stack: layers; zamba2's super-blocks
    (each one application of the shared attention block and its Mamba-2
    layers, after a fixed prelude); whisper's encoder-and-decoder layer
    pairs."""
    if cfg.hybrid_attn_every:
        return cfg.hybrid_blocks
    if cfg.is_encdec:
        if cfg.encoder_layers != cfg.num_layers:
            raise ValueError(f"{cfg.name}: {cfg.encoder_layers} encoder and "
                             f"{cfg.num_layers} decoder layers")
        return cfg.num_layers
    return cfg.num_layers


def with_depth(cfg, units: int):
    """``cfg`` cut to ``units`` repeating units, its widths untouched."""
    if cfg.hybrid_attn_every:
        return dataclasses.replace(
            cfg, num_layers=cfg.hybrid_prelude + units * cfg.hybrid_attn_every)
    if cfg.is_encdec:
        return dataclasses.replace(cfg, num_layers=units, encoder_layers=units)
    return dataclasses.replace(cfg, num_layers=units)


def _combine(terms):
    """sum(c * counts) over (c, Counts) terms, field by field."""
    from repro_torch.launch.op_count import Counts

    out = Counts()
    for c, k in terms:
        for f in dataclasses.fields(Counts):
            v = getattr(k, f.name)
            if isinstance(v, dict):
                d = getattr(out, f.name)
                for key, x in v.items():
                    d[key] = d.get(key, 0) + c * x
            else:
                setattr(out, f.name, getattr(out, f.name) + c * v)
    for f in dataclasses.fields(Counts):     # whole counts stay whole
        v = getattr(out, f.name)
        if isinstance(v, dict):
            setattr(out, f.name, {k: round(x) for k, x in v.items()})
        elif f.name in ("ops", "peak_temp_bytes", "out_bytes"):
            setattr(out, f.name, round(v))
    return out


def _count(cfg, shape, mesh, kind_kwargs):
    """Build ``cfg`` × ``shape`` on ``mesh`` and count one run: (counts,
    the functions DTensor refused, their first errors)."""
    from repro_torch.launch import steps
    from repro_torch.launch.op_count import count_step

    builder = {"train": steps.build_mesh_train_step,
               "prefill": steps.build_mesh_prefill_step,
               "decode": steps.build_mesh_serve_step}[shape.kind]
    built = builder(cfg, mesh, shape, **kind_kwargs)
    result, counts = count_step(built.run)
    # the results that are not donated arguments updated in place: the
    # next tokens or the logits, or the train step's metrics
    counts.out_bytes = steps.local_nbytes(result) - sum(
        built.arg_bytes()[built.arg_names[i]] for i in built.donate)
    return counts, built.refused, built.refusal_errors


def count_cell(cfg, shape, mesh, *, impl: str = "kernel",
               scale: bool = True, microbatches: int = 16):
    """One device's counts of ``cfg`` × ``shape`` on ``mesh`` (None: one
    device).  With ``scale`` the step runs at 1 and 2 depth units (and a
    train step at 2 and 3 microbatches of its microbatch size) and the
    counts are extrapolated linearly to the full depth (and bilinearly to
    ``microbatches``): every unit and microbatch runs the same ops on the
    same shapes, as the reference's ``hlo_count`` scales a loop body by its
    trip count.  Returns (counts, refused functions, their errors, how it
    was counted)."""
    from repro_torch.configs import ShapeSpec

    refused: Dict[str, int] = {}
    errors: Dict[str, str] = {}

    def count(c, sh, **kw):
        k, r, e = _count(c, sh, mesh, kw)
        for name, n in r.items():
            refused[name] = refused.get(name, 0) + n
        errors.update(e)
        return k

    train = shape.kind == "train"
    kw = {"microbatches": microbatches} if train else {"impl": impl}
    if mesh is not None:
        # DTensor's first dispatch of each op signature runs extra local
        # ops (its sharding propagation, uncached): one uncounted warm-up
        # run at the smallest depth dispatches every signature once
        sh = shape if not train else ShapeSpec(
            shape.name, shape.seq_len, 2 * shape.global_batch // microbatches,
            "train")
        _count(with_depth(cfg, 1), sh, mesh,
               dict(kw, microbatches=2) if train else kw)
    if not scale:
        return count(cfg, shape, **kw), refused, errors, {"scaled": False}
    U = depth_units(cfg)
    how = {"scaled": True, "units": [1, 2], "full_units": U}
    if not train:
        c1 = count(with_depth(cfg, 1), shape, **kw)
        c2 = count(with_depth(cfg, 2), shape, **kw)
        return (_combine([(1.0, c1), (U - 1.0, c2), (1.0 - U, c1)]),
                refused, errors, how)
    if shape.global_batch % microbatches:
        raise ValueError(f"batch {shape.global_batch} not divisible by "
                         f"{microbatches} microbatches")
    per = shape.global_batch // microbatches
    c = {}
    for u in (1, 2):
        for n in (2, 3):
            sh = ShapeSpec(shape.name, shape.seq_len, per * n, "train")
            c[u, n] = count(with_depth(cfg, u), sh, microbatches=n)
    a, b = U - 1.0, microbatches - 2.0
    how.update(microbatches=[2, 3], full_microbatches=microbatches)
    return (_combine([(1.0, c[1, 2]), (a, c[2, 2]), (-a, c[1, 2]),
                      (b, c[1, 3]), (-b, c[1, 2]),
                      (a * b, c[2, 3]), (-a * b, c[2, 2]),
                      (-a * b, c[1, 3]), (a * b, c[1, 2])]),
            refused, errors, how)


def run_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool,
    verbose: bool = True,
    step_kwargs: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Build and count one cell on meta tensors; return the analysis
    record.  The caller's process group (``init_fake_group``) must hold
    the mesh.  A serving cell runs the port's serving path (``impl=
    "kernel"``, each kernel's meta route on one device's shards; the
    builders' default is the reference's ``"blockwise"``); a train cell
    runs ``"blockwise"``, the train path.  The counts are scaled from two
    depths (``count_cell``)."""
    from repro_torch.configs import SHAPES, cells_for, get_config
    from repro_torch.launch.analysis import Roofline, model_flops_for
    from repro_torch.launch.mesh import make_production_mesh, mesh_chip_count
    from repro_torch.launch.steps import build_step

    cfg = get_config(arch)
    status = dict(cells_for(cfg)).get(shape_name, "run")
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "multi" if multi_pod else "single"
    record: Dict[str, Any] = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "mesh_desc": _mesh_desc(mesh),
        "chips": mesh_chip_count(mesh),
        "status": status,
    }
    if status != "run":
        if verbose:
            print(f"[dryrun] {arch} × {shape_name} × {mesh_name}: {status}")
        return record

    shape = SHAPES[shape_name]
    kw = dict(step_kwargs or {})
    if shape.kind != "train":
        kw.setdefault("impl", "kernel")
    t0 = time.perf_counter()
    built = build_step(arch, shape_name, mesh, **kw)
    args_bytes = built.arg_bytes()
    del built
    t_build = time.perf_counter() - t0
    counts, refused, errors, how = count_cell(
        cfg, shape, mesh, impl=kw.get("impl", "kernel"),
        **({"microbatches": kw["microbatches"]} if "microbatches" in kw
           else {}))
    t_run = time.perf_counter() - t0 - t_build

    roof = Roofline(
        arch=arch,
        shape=shape_name,
        mesh_desc=record["mesh_desc"],
        chips=record["chips"],
        hlo_flops=counts.flops,
        hlo_bytes=counts.bytes,
        collective_link_bytes=counts.coll_bytes,
        model_flops=model_flops_for(cfg, shape),
    )
    record.update(
        {
            "desc": f"{shape.kind} {cfg.name} seq={shape.seq_len} "
                    f"gb={shape.global_batch}",
            "lower_s": round(t_build, 2),
            "compile_s": round(t_run, 2),
            "counted": how,
            "refused_ops": refused,
            "refusal_errors": errors,
            "memory_analysis": {
                "argument_size_in_bytes": sum(args_bytes.values()),
                "output_size_in_bytes": counts.out_bytes,
                "temp_size_in_bytes": counts.peak_temp_bytes,
                "argument_bytes_by_name": args_bytes,
            },
            "hlo_counts": {          # one device's counts (launch.op_count)
                "flops": counts.flops,
                "bytes_traffic_model": counts.bytes,
                "collective_link_bytes": counts.coll_bytes,
                "collective_raw_bytes": counts.coll_raw,
                "collective_counts": counts.coll_counts,
                "kernel_flops": counts.kernel_flops,
                "kernel_bytes": counts.kernel_bytes,
                "kernel_calls": counts.kernel_calls,
                "ops": counts.ops,
            },
            "roofline": roof.row(),
        }
    )
    ma = record["memory_analysis"]
    hbm_need = ma["argument_size_in_bytes"] + ma["temp_size_in_bytes"]
    record["hbm_bytes_per_chip"] = hbm_need
    record["fits_hbm_80gib"] = bool(hbm_need <= HBM_BYTES)
    if verbose:
        print(
            f"[dryrun] {arch} × {shape_name} × {mesh_name}: OK "
            f"build={t_build:.1f}s run={t_run:.1f}s "
            f"args={ma['argument_size_in_bytes'] / 2**30:.2f}GiB "
            f"temp={ma['temp_size_in_bytes'] / 2**30:.2f}GiB "
            f"fits={record['fits_hbm_80gib']} flops={counts.flops:.3e} "
            f"coll={counts.coll_bytes:.3e}B "
            f"bound={1e3 * roof.step_time_s:.3f}ms "
            f"bottleneck={roof.bottleneck}"
            + (f" refused={json.dumps(refused)}" if refused else "")
        )
    return record


def save_record(record: Dict[str, Any]) -> str:
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    path = os.path.join(
        ARTIFACT_DIR,
        f"{record['arch']}__{record['shape']}__{record['mesh']}.json",
    )
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return path


def main(argv=None) -> int:
    from repro_torch.configs import ARCH_IDS, SHAPES
    from repro_torch.launch.mesh import TWO_NODE_SHAPE, NODE_SHAPE

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS, nargs="+",
                    help="one architecture, or several")
    ap.add_argument("--shape", choices=sorted(SHAPES), nargs="+",
                    help="one shape, or several (every arch x shape runs)")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch × shape) cell")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in ARCH_IDS:
            for shape_name in SHAPES:
                cells.append((arch, shape_name))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required (or --all)")
        cells = [(a, sh) for a in args.arch for sh in args.shape]

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    init_fake_group(max(math.prod(TWO_NODE_SHAPE if m else NODE_SHAPE)
                        for m in meshes))

    failures = []
    for arch, shape_name in cells:
        for multi in meshes:
            mesh_name = "multi" if multi else "single"
            out = os.path.join(
                ARTIFACT_DIR, f"{arch}__{shape_name}__{mesh_name}.json"
            )
            if args.skip_existing and os.path.exists(out):
                print(f"[dryrun] skip existing {out}")
                continue
            try:
                record = run_cell(arch, shape_name, multi_pod=multi)
                save_record(record)
            except Exception as e:  # noqa: BLE001 - recorded and reported
                traceback.print_exc()
                failures.append((arch, shape_name, mesh_name, repr(e)))
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:")
        for f in failures:
            print("   ", f)
        return 1
    print(f"[dryrun] all {len(cells) * len(meshes)} cells OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
