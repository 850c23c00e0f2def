"""The service CLI: the port's own copy of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch command-r-35b \\
        --trace aws-3 --policy spothedge --hours 4

    # a declarative service file (JSON, or YAML where PyYAML is present):
    PYTHONPATH=src python -m repro_torch.launch.serve --spec service.json

    # a spec's sweep: section as a scenario matrix (report JSON under
    # artifacts/bench/), on the card or on the host engine in 4 processes:
    PYTHONPATH=src python -m repro_torch.launch.serve --spec sweep.json --sweep
    PYTHONPATH=src python -m repro_torch.launch.serve --spec sweep.json \
        --sweep --engine vector --workers 4

Every run is a ``ServiceSpec``; the flags build one.  ``--engine`` picks
the engine, whatever the spec's ``sim.engine`` says, and defaults to
``jax``: the data plane runs on the card (``--device``, default ``cuda``)
unless the caller asks for a host engine (``--engine vector``, or
``legacy`` for the per-request ``ServingSimulator``; neither takes a
``--device`` but ``cpu``) or for ``--device cpu``, the kernel's plain
version.  ``--replica-model token`` runs the continuous-batching model (on
the host engine under ``jax`` too, as in the reference).  Without CUDA the
default exits non-zero before anything runs.  A malformed spec exits 2 with
one ``error: ...`` line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS
from repro_torch.core.policy import registered_policies
from repro_torch.service import Service, SpecError, load_spec


def spec_from_args(args: argparse.Namespace) -> dict:
    """The flags, expressed as a spec dict."""
    return {
        "name": f"serve-{args.arch}",
        "model": args.arch,
        "trace": args.trace,
        "resources": {"instance_type": args.itype},
        "replica_policy": {"name": args.policy},
        "autoscaler": {
            "kind": "load",
            "target": 4,
            "qps_per_replica": args.qps_per_replica,
            "min_replicas": 2,
            "max_replicas": 12,
            "upscale_delay_s": 60.0,
            "downscale_delay_s": 600.0,
        },
        "workload": {"kind": args.workload, "rate_per_s": args.rate,
                     "seed": 11},
        "sim": {
            "duration_hours": args.hours,
            "control_interval_s": 15.0,
            "timeout_s": args.timeout,
            "concurrency": 4,
        },
    }


def _run_sweep(spec, args: argparse.Namespace) -> int:
    """Expand spec.sweep into a ScenarioSuite, run it, save the report."""
    from repro_torch.experiments import ScenarioSuite

    suite = ScenarioSuite.from_spec(spec)
    print(f"[serve] sweep {spec.name!r}: {len(suite)} scenarios "
          f"({spec.sweep.size if spec.sweep else 1} grid cells)")
    out_dir = os.path.join("artifacts", "bench")
    report = suite.run(engine=args.engine, workers=args.workers,
                       save_to=out_dir, progress=True, device=args.device)
    print(report.summary())
    print(f"[serve] report: {out_dir}/scenario_{suite.name}.json")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spec", default=None, metavar="FILE",
                    help="run a service spec file (.json, or .yaml with "
                    "PyYAML); the model / traffic flags are ignored")
    ap.add_argument("--arch", choices=ARCH_IDS, default="command-r-35b")
    ap.add_argument("--trace", default="aws-3")
    ap.add_argument("--policy", default="spothedge",
                    choices=registered_policies())
    ap.add_argument("--workload", default="arena",
                    choices=["poisson", "arena", "maf"])
    ap.add_argument("--itype", default="g5.48xlarge")
    ap.add_argument("--hours", type=float, default=4.0)
    ap.add_argument("--rate", type=float, default=2.0)
    ap.add_argument("--qps-per-replica", type=float, default=0.8)
    ap.add_argument("--timeout", type=float, default=100.0)
    ap.add_argument("--status", action="store_true",
                    help="print the resolved service status as JSON")
    ap.add_argument("--sweep", action="store_true",
                    help="expand the spec's sweep: grid into a scenario "
                    "suite and run every cell")
    ap.add_argument("--workers", default=None, metavar="N|auto",
                    help="with --sweep: run the cells in N worker "
                    "processes ('auto' = one per CPU) on a host engine; "
                    "default serial (--engine jax batches instead)")
    ap.add_argument("--engine", default="jax",
                    choices=["vector", "legacy", "jax"],
                    help="the engine for this run, over the spec's "
                    "sim.engine: jax (default) runs the data plane on "
                    "--device, vector and legacy on the host")
    ap.add_argument("--replica-model", default=None,
                    choices=["request", "token"],
                    help="override sim.replica_model for this run (token = "
                    "continuous batching with TTFT / TPOT / goodput)")
    ap.add_argument("--device", default=None,
                    help="phase B's device under --engine jax (default "
                    "cuda; cpu runs the kernel's plain version); the host "
                    "engines take only cpu")
    args = ap.parse_args(argv)

    if args.engine == "jax":
        resolve_device(args.device)       # no CUDA: fail before any work
    elif args.device not in (None, "cpu"):
        ap.error(f"--device {args.device} needs --engine jax: the "
                 f"{args.engine} engine runs on the host")
    try:
        spec = load_spec(args.spec if args.spec else spec_from_args(args))
        if args.replica_model and args.replica_model != spec.sim.replica_model:
            spec = load_spec(dataclasses.replace(spec, sim=dataclasses.replace(
                spec.sim, replica_model=args.replica_model)))
        if args.sweep:
            return _run_sweep(spec, args)
        if args.workers is not None:
            print("error: --workers requires --sweep (a single service run "
                  "is one cell)", file=sys.stderr)
            return 2
        svc = Service(spec, engine=args.engine)
        resolved = svc.resolve()
        print(f"[serve] {spec.replica_policy.name} serving "
              f"{resolved.model_config.name} on "
              f"{spec.resources.instance_type}: {len(resolved.requests)} "
              f"requests / {spec.sim.duration_hours:g}h over trace "
              f"{resolved.trace.name} ({len(resolved.zones)} zones), engine "
              f"{svc.spec.sim.engine}")
        res = svc.run(device=args.device)
    except SpecError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(res.summary())
    if args.status:
        print(json.dumps(svc.status(), indent=1, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
