"""CLI: ``python -m repro_torch.analysis [--format json|text] [--rules ...]``.

Exit codes: 0 — clean (every finding exempted, no stale exemptions);
1 — active findings or stale exemptions; 2 — configuration error
(unknown rule, malformed exemption file).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.analysis.core import RULES, rule_ids
from repro_torch.analysis.exemptions import DEFAULT_EXEMPTIONS_FILE, ExemptionError
from repro_torch.analysis.report import DEFAULT_REPORT_PATH
from repro_torch.analysis.runner import run_analysis


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Repo-aware static invariant checker: engine-parity, "
                    "determinism, tracing-hazard, silent-fallback, "
                    "spec-drift.",
    )
    parser.add_argument(
        "--root", default=".",
        help="repository root to analyze (default: cwd)",
    )
    parser.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="stdout format (default: text)",
    )
    parser.add_argument(
        "--rules", nargs="+", metavar="RULE",
        help=f"subset of rules to run (default: all of {rule_ids()})",
    )
    parser.add_argument(
        "--exemptions", default=None, metavar="PATH",
        help="exemption file, repo-relative (default: "
             f"{DEFAULT_EXEMPTIONS_FILE} if present)",
    )
    parser.add_argument(
        "--out", default=DEFAULT_REPORT_PATH, metavar="PATH",
        help=f"where to write the JSON report (default: "
             f"{DEFAULT_REPORT_PATH}); use '-' to skip writing",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print registered rules and exit",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for rid in rule_ids():
            print(f"{rid}: {RULES[rid].description}")
        return 0

    try:
        report = run_analysis(
            args.root, rules=args.rules, exemptions_path=args.exemptions
        )
    except (KeyError, ExemptionError) as e:
        print(f"repro_torch.analysis: configuration error: {e}", file=sys.stderr)
        return 2

    if args.out != "-":
        import os

        path = args.out
        if not os.path.isabs(path):
            path = os.path.join(args.root, path)
        report.save(path)

    if args.format == "json":
        print(json.dumps(report.to_dict(), indent=1))
    else:
        print(report.format_text())

    return 0 if report.ok and not report.unused_exemptions else 1


if __name__ == "__main__":
    sys.exit(main())
