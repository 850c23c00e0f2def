"""CLI: summarize / diff / attribute / convert observability logs.

::

    python -m repro_torch.obs summarize artifacts/obs/run.jsonl
    python -m repro_torch.obs diff a.jsonl b.jsonl
    python -m repro_torch.obs attribute run.jsonl --top 5
    python -m repro_torch.obs trace run.jsonl -o run.trace.json
    python -m repro_torch.obs request run.spans.jsonl 0
    python -m repro_torch.obs slo run.jsonl

``summarize``/``diff``/``attribute`` print human-readable text by
default and structured JSON with ``--json``; ``trace`` writes a
Perfetto-loadable Chrome-trace file.  ``request`` renders one sampled
request's span as a waterfall (pass the ``.spans.jsonl`` artifact);
``slo`` renders the run's SLO burn-rate windows as a table.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List

from repro_torch.obs.attribution import attribution_report
from repro_torch.obs.export import (
    diff_summaries,
    read_jsonl,
    summarize,
    write_chrome_trace,
)


def _print_kv(d: Dict[str, Any], indent: str = "  ") -> None:
    for k, v in d.items():
        if isinstance(v, dict):
            print(f"{indent}{k}:")
            _print_kv(v, indent + "  ")
        else:
            print(f"{indent}{k}: {v}")


def _cmd_summarize(args: argparse.Namespace) -> int:
    s = summarize(read_jsonl(args.log))
    if args.json:
        print(json.dumps(s, indent=1, sort_keys=True))
    else:
        print(f"run summary: {args.log}")
        _print_kv(s)
    return 0


def _cmd_diff(args: argparse.Namespace) -> int:
    d = diff_summaries(read_jsonl(args.a), read_jsonl(args.b))
    if args.json:
        print(json.dumps(d, indent=1, sort_keys=True))
    else:
        print(f"diff (b − a): a={args.a} b={args.b}")
        _print_kv(d)
    return 0 if d["identical"] else 1


def _cmd_attribute(args: argparse.Namespace) -> int:
    rep = attribution_report(
        read_jsonl(args.log),
        top=args.top,
        spans=read_jsonl(args.spans) if args.spans else None,
    )
    if args.json:
        print(json.dumps(rep, indent=1, sort_keys=True))
        return 0
    print(f"decision attribution: {args.log}")
    print(f"  total cost: ${rep['total_cost_usd']:.4f} over "
          f"{rep['n_replicas']} replicas / {rep['n_decisions']} decisions "
          f"({rep['horizon_s']:.0f}s horizon)")
    print("  cost by action:")
    for action, agg in rep["cost_by_action"].items():
        print(f"    {action:<18} ${agg['cost_usd']:>10.4f}  "
              f"({agg['n_replicas']} replicas)")
    print(f"  top {len(rep['top_decisions'])} decisions by cost:")
    for d in rep["top_decisions"]:
        reason = ""
        if d["reason"]:
            reason = "  " + ",".join(
                f"{k}={v}" for k, v in sorted(d["reason"].items())
            )
        print(f"    t={d['t']:>9.1f}s {d['action']:<16} "
              f"zone={d['zone']} inst={d['instance_id']} "
              f"${d['cost_usd']:.4f} "
              f"({d['replica_lifetime_s']:.0f}s){reason}")
    fr = rep["failed_requests"]
    if fr["by_cause"] is not None:
        print(f"  failed requests ({fr['total']}):")
        for cause, n in sorted(fr["by_cause"].items()):
            print(f"    {cause:<16} {n}")
    elif fr["note"]:
        print(f"  failed requests: {fr['note']}")
    rs = rep.get("request_spans")
    if rs:
        print(f"  sampled request spans ({rs['n_spans']}): "
              f"{rs['n_retried']} retried, {rs['n_migrated']} migrated")
        for name, sec in rs["seconds_by_segment"].items():
            print(f"    {name:<10} {sec:>12.3f}s")
    return 0


def _cmd_request(args: argparse.Namespace) -> int:
    rec = next(
        (r for r in read_jsonl(args.log)
         if r.get("event") == "span"
         and int(r.get("ordinal", -1)) == args.ordinal),
        None,
    )
    if rec is None:
        print(f"no span record for ordinal {args.ordinal} "
              f"in {args.log} (is trace_sample high enough?)")
        return 1
    if args.json:
        print(json.dumps(rec, indent=1, sort_keys=True))
        return 0
    segs = rec.get("segments") or []
    t0 = float(rec["arrival_s"])
    t1 = max((float(s["t1_s"]) for s in segs), default=t0)
    span = max(t1 - t0, 1e-9)
    width = 40
    print(f"request #{rec['ordinal']}: outcome={rec['outcome']} "
          f"attempts={rec['attempts']} arrival={t0:.3f}s"
          + (f" e2e={rec['e2e_s']:.3f}s" if "e2e_s" in rec else ""))
    for s in segs:
        a, b = float(s["t0_s"]), float(s["t1_s"])
        lo = int((a - t0) / span * width)
        hi = max(int((b - t0) / span * width), lo + 1)
        bar = " " * lo + "#" * (hi - lo)
        extra = ",".join(
            f"{k}={v}" for k, v in sorted(s.items())
            if k not in ("name", "t0_s", "t1_s")
        )
        print(f"  {s['name']:<9} |{bar:<{width}}| "
              f"{a:11.3f}s -> {b:11.3f}s ({b - a:8.3f}s)"
              + (f"  {extra}" if extra else ""))
    return 0


def _cmd_slo(args: argparse.Namespace) -> int:
    from repro_torch.obs.slo import burn_summary, burn_table

    records = read_jsonl(args.log)
    if args.json:
        print(json.dumps(
            {"summary": burn_summary(records)}, indent=1, sort_keys=True
        ))
        return 0
    print(burn_table(records))
    s = burn_summary(records)
    if s is not None:
        print(f"alerting {s['alert_windows']}/{s['windows']} windows "
              f"({s['alert_minutes']:.1f} min)")
    return 0


def _cmd_trace(args: argparse.Namespace) -> int:
    out = args.out or (args.log.rsplit(".", 1)[0] + ".trace.json")
    path = write_chrome_trace(read_jsonl(args.log), out)
    print(f"wrote {path} (load it at https://ui.perfetto.dev)")
    return 0


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="inspect repro_torch.obs event logs",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("summarize", help="summarize one event log")
    p.add_argument("log")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_summarize)

    p = sub.add_parser("diff", help="diff two event logs (b − a)")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_diff)

    p = sub.add_parser(
        "attribute", help="decision-attribution report for one log"
    )
    p.add_argument("log")
    p.add_argument("--top", type=int, default=10)
    p.add_argument("--spans", default=None,
                   help="span log (.spans.jsonl) to extend the ledger")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_attribute)

    p = sub.add_parser(
        "trace", help="convert a log to a Chrome/Perfetto trace"
    )
    p.add_argument("log")
    p.add_argument("-o", "--out", default=None)
    p.set_defaults(fn=_cmd_trace)

    p = sub.add_parser(
        "request",
        help="waterfall of one sampled request (span log + ordinal)",
    )
    p.add_argument("log")
    p.add_argument("ordinal", type=int)
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_request)

    p = sub.add_parser(
        "slo", help="SLO burn-rate windows of one event log"
    )
    p.add_argument("log")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_slo)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
