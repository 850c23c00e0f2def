"""Versioned JSON report of one analysis run (schema v1).

The artifact lands at ``artifacts/analysis_torch/report.json`` and is consumed
by CI (fail on ``n_active > 0``) and by humans reading a build.  The
report is deliberately timestamp-free and machine-independent: two runs
over the same tree produce byte-identical JSON — the checker holds
itself to its own determinism rule.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

from repro_torch.analysis.core import Finding
from repro_torch.analysis.exemptions import Exemption

__all__ = ["AnalysisReport", "ReportedFinding", "SCHEMA_VERSION"]

SCHEMA_VERSION = 1
DEFAULT_REPORT_PATH = os.path.join("artifacts", "analysis_torch", "report.json")


@dataclasses.dataclass(frozen=True)
class ReportedFinding:
    """A finding plus its exemption status at report time."""

    finding: Finding
    exempted: bool = False
    justification: str = ""

    def to_dict(self) -> Dict[str, object]:
        out = self.finding.to_dict()
        out["exempted"] = self.exempted
        if self.exempted:
            out["justification"] = self.justification
        return out

    @staticmethod
    def from_dict(d: Dict[str, object]) -> "ReportedFinding":
        return ReportedFinding(
            finding=Finding.from_dict(d),
            exempted=bool(d.get("exempted", False)),
            justification=str(d.get("justification", "")),
        )


@dataclasses.dataclass(frozen=True)
class AnalysisReport:
    rules: List[str]
    n_files_scanned: int
    findings: List[ReportedFinding]
    unused_exemptions: List[Exemption] = dataclasses.field(
        default_factory=list
    )

    # -- derived ----------------------------------------------------------
    @property
    def active(self) -> List[ReportedFinding]:
        return [f for f in self.findings if not f.exempted]

    @property
    def n_active(self) -> int:
        return len(self.active)

    @property
    def n_exempted(self) -> int:
        return len(self.findings) - self.n_active

    @property
    def ok(self) -> bool:
        return self.n_active == 0

    def by_rule(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.finding.rule] = out.get(f.finding.rule, 0) + 1
        return dict(sorted(out.items()))

    # -- (de)serialization ------------------------------------------------
    def to_dict(self) -> Dict[str, object]:
        return {
            "schema": SCHEMA_VERSION,
            "tool": "repro_torch.analysis",
            "rules": list(self.rules),
            "n_files_scanned": self.n_files_scanned,
            "n_findings": len(self.findings),
            "n_active": self.n_active,
            "n_exempted": self.n_exempted,
            "findings_by_rule": self.by_rule(),
            "findings": [f.to_dict() for f in self.findings],
            "unused_exemptions": [
                e.to_dict() for e in self.unused_exemptions
            ],
        }

    @staticmethod
    def from_dict(d: Dict[str, object]) -> "AnalysisReport":
        if d.get("schema") != SCHEMA_VERSION:
            raise ValueError(
                f"unsupported analysis report schema {d.get('schema')!r}; "
                f"this reader understands {SCHEMA_VERSION}"
            )
        return AnalysisReport(
            rules=[str(r) for r in d.get("rules", [])],
            n_files_scanned=int(d.get("n_files_scanned", 0)),  # type: ignore
            findings=[
                ReportedFinding.from_dict(f)
                for f in d.get("findings", [])  # type: ignore[union-attr]
            ],
            unused_exemptions=[
                Exemption(
                    rule=str(e["rule"]), path=str(e["path"]),
                    justification=str(e["justification"]),
                    symbol=str(e.get("symbol", "")),
                )
                for e in d.get("unused_exemptions", [])  # type: ignore
            ],
        )

    def save(self, path: str = DEFAULT_REPORT_PATH) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=False)
            f.write("\n")
        return path

    @staticmethod
    def load(path: str) -> "AnalysisReport":
        with open(path, encoding="utf-8") as f:
            return AnalysisReport.from_dict(json.load(f))

    # -- display ----------------------------------------------------------
    def format_text(self) -> str:
        lines: List[str] = []
        for f in self.findings:
            tag = "EXEMPT" if f.exempted else "FAIL"
            lines.append(
                f"[{tag}] {f.finding.rule}: {f.finding.location()} "
                f"{('(' + f.finding.symbol + ') ') if f.finding.symbol else ''}"
                f"{f.finding.message}"
            )
            if f.exempted:
                lines.append(f"         exempted: {f.justification}")
            elif f.finding.hint:
                lines.append(f"         hint: {f.finding.hint}")
        for e in self.unused_exemptions:
            lines.append(
                f"[STALE] exemption matched nothing: {e.rule} @ {e.path}"
                f"{(' (' + e.symbol + ')') if e.symbol else ''}"
            )
        counts = ", ".join(
            f"{r}={n}" for r, n in self.by_rule().items()
        ) or "none"
        lines.append(
            f"{self.n_files_scanned} files scanned, rules "
            f"[{', '.join(self.rules)}]: {len(self.findings)} findings "
            f"({self.n_active} active, {self.n_exempted} exempted) "
            f"[{counts}]"
        )
        lines.append("analysis: " + ("OK" if self.ok else "FAILED"))
        return "\n".join(lines)
