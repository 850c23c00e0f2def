"""CLI: generate step-time profile artifacts on the H100 (counterpart of
``repro.profiles.run``).

    PYTHONPATH=src python -m repro_torch.profiles.run \
        --models llama3.2-1b --itype h100 --out PATH
    PYTHONPATH=src python -m repro_torch.profiles.run --device cpu

With ``--out`` pointing at an existing table the new entries merge in
(re-profiles supersede old rows; other rows survive), so one artifact can
accumulate the full model × accelerator matrix across runs.  The default
output name encodes provenance: ``artifacts/profiles/<backend>-<mode>.json``
(``cuda-compiled.json`` on the card, ``cpu-eager.json`` with
``--device cpu``, whose rows are not silicon numbers).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from repro_torch.cluster.catalog import INSTANCE_TYPES, instance_type
from repro_torch.configs import ARCH_IDS
from repro_torch.profiles.profiler import profile_models
from repro_torch.profiles.schema import (
    DEFAULT_PROFILE_DIR,
    ProfileSchemaError,
    ProfileTable,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.profiles.run", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument(
        "--models", nargs="+", default=["llama3.2-1b"],
        help=f"arch ids to profile, or 'all' (available: {ARCH_IDS})",
    )
    ap.add_argument(
        "--itype", default="h100",
        help="instance type whose peaks normalize mfu/mbu "
        f"(the port has {sorted(INSTANCE_TYPES)})",
    )
    ap.add_argument("--out", default=None,
                    help="output JSON path (merged if it exists); "
                    f"default {DEFAULT_PROFILE_DIR}/<backend>-<mode>.json")
    ap.add_argument("--prefill-tokens", type=int, default=256)
    ap.add_argument("--cache-tokens", type=int, default=512)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, mode compiled) or cpu (their "
                    "plain versions, mode eager)")
    ap.add_argument(
        "--compiled", action="store_true",
        help="insist on the compiled CUDA kernels: refuse --device cpu",
    )
    args = ap.parse_args(argv)

    models = list(args.models)
    if models == ["all"]:
        models = list(ARCH_IDS)
    unknown = [m for m in models if m not in ARCH_IDS]
    if unknown:
        ap.error(f"unknown models {unknown}; available: {ARCH_IDS}")
    if args.compiled and torch.device(args.device).type != "cuda":
        ap.error("--compiled needs --device cuda")
    try:
        itype = instance_type(args.itype)
    except KeyError as e:
        ap.error(str(e))

    table = profile_models(
        models, itype,
        prefill_tokens=args.prefill_tokens,
        cache_tokens=args.cache_tokens,
        batch=args.batch,
        repeats=args.repeats,
        device=args.device,
    )

    out = args.out
    if out is None:
        out = os.path.join(
            DEFAULT_PROFILE_DIR, f"{table.backend}-{table.mode}.json"
        )
    if os.path.exists(out):
        try:
            prior = ProfileTable.load(out)
        except ProfileSchemaError as e:
            # never clobber rows we cannot read — measurements are not
            # reproducible for free on another machine
            print(
                f"error: existing table {out} cannot be merged ({e}); "
                "pass a fresh --out path or fix/remove the file",
                file=sys.stderr,
            )
            return 1
        prior.merge(table)
        table.entries = prior.entries
    table.save(out)

    for key, e in sorted(table.entries.items()):
        print(
            f"{key:40s} prefill {e.prefill_flops_per_s:10.3e} FLOP/s "
            f"(mfu {e.mfu_prefill:8.2e})  decode "
            f"{e.decode_bytes_per_s:10.3e} B/s (mbu {e.mbu_decode:8.2e})"
        )
    print(f"wrote {out} ({len(table.entries)} entries, "
          f"{table.backend}/{table.mode}, {table.device})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
