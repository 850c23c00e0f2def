"""Run selected passes over a repository and assemble the report."""

from __future__ import annotations

from typing import List, Optional, Sequence

import repro_torch.analysis.passes  # noqa: F401  (registers all rules)
from repro_torch.analysis.core import RULES, Finding, RepoContext, rule_ids
from repro_torch.analysis.exemptions import Exemption, load_exemptions, match
from repro_torch.analysis.report import AnalysisReport, ReportedFinding

__all__ = ["run_analysis"]

PARSE_ERROR_RULE = "parse-error"


def run_analysis(
    root: str,
    rules: Optional[Sequence[str]] = None,
    exemptions_path: Optional[str] = None,
) -> AnalysisReport:
    """Run ``rules`` (default: all registered) against the tree at
    ``root`` and return the exemption-annotated report.

    Unknown rule ids raise ``KeyError`` — a CI job asking for a rule
    that does not exist must fail loudly, not silently check nothing.
    """
    selected = list(rules) if rules is not None else rule_ids()
    unknown = [r for r in selected if r not in RULES]
    if unknown:
        raise KeyError(
            f"unknown rule(s) {unknown}; registered: {rule_ids()}"
        )

    ctx = RepoContext(root)
    exemptions = load_exemptions(
        ctx, exemptions_path,
        known_rules=list(RULES) + [PARSE_ERROR_RULE],
    )

    findings: List[Finding] = []
    for rid in selected:
        findings.extend(RULES[rid].run(ctx))
    # files that failed to parse shrank every pass's scope: surface them
    for path, (line, msg) in sorted(ctx.parse_errors.items()):
        findings.append(Finding(
            rule=PARSE_ERROR_RULE, path=path, line=line,
            message=f"file failed to parse ({msg}); every pass skipped it",
            hint="fix the syntax error",
        ))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.symbol,
                                 f.message))

    covered = match(findings, exemptions)
    reported = [
        ReportedFinding(
            finding=f,
            exempted=i in covered,
            justification=covered[i].justification if i in covered else "",
        )
        for i, f in enumerate(findings)
    ]
    used = {id(covered[i]) for i in covered}
    unused = [e for e in exemptions if id(e) not in used]

    n_scanned = len(
        {p for p, s in ctx._source.items() if s is not None}
    )
    return AnalysisReport(
        rules=selected,
        n_files_scanned=n_scanned,
        findings=reported,
        unused_exemptions=unused,
    )
