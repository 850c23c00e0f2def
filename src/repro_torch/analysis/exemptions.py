"""Exemption file: the only sanctioned way to silence a finding.

The port's file is ``analysis_exemptions_torch.json`` at the repository
root, beside the reference's ``analysis_exemptions.json``, whose checker
fails on an entry it cannot match; the format is the reference's.

An exemption is a JSON entry that names the rule, the file, optionally
the symbol, and — mandatorily — a one-line justification.  The checker
refuses malformed files loudly: an exemption naming an unknown rule or a
path that does not exist is itself an error (stale exemptions must not
outlive the code they excused), and an empty justification is rejected
(the justification IS the review artifact).

    {
      "schema": 1,
      "exemptions": [
        {
          "rule": "determinism",
          "path": "src/repro_torch/experiments/suite.py",
          "symbol": "_prune_worker_tapes",
          "justification": "set difference drives cache eviction only; "
                           "iteration order never reaches any output"
        }
      ]
    }

``symbol`` empty/omitted matches every finding of that rule in that
file; prefer a symbol so unrelated regressions in the same file still
fail the gate.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.core import Finding, RepoContext

__all__ = ["Exemption", "ExemptionError", "load_exemptions", "match"]

DEFAULT_EXEMPTIONS_FILE = "analysis_exemptions_torch.json"
EXEMPTIONS_SCHEMA = 1


class ExemptionError(ValueError):
    """The exemption file is malformed; the message names the entry."""


@dataclasses.dataclass(frozen=True)
class Exemption:
    rule: str
    path: str
    justification: str
    symbol: str = ""

    def matches(self, f: Finding) -> bool:
        return (
            f.rule == self.rule
            and f.path == self.path
            and (not self.symbol or f.symbol == self.symbol)
        )

    def to_dict(self) -> Dict[str, str]:
        out = {
            "rule": self.rule,
            "path": self.path,
            "justification": self.justification,
        }
        if self.symbol:
            out["symbol"] = self.symbol
        return out


def _entry_error(i: int, msg: str) -> ExemptionError:
    return ExemptionError(f"exemption entry #{i}: {msg}")


def load_exemptions(
    ctx: RepoContext, path: Optional[str] = None,
    known_rules: Optional[Sequence[str]] = None,
) -> List[Exemption]:
    """Load + validate the exemption file (missing file -> no exemptions).

    Validation is strict by design: unknown rule ids, paths that do not
    exist in the repo, and missing/empty justifications all raise
    :class:`ExemptionError` — an invalid exemption silently matching
    nothing would defeat the gate.
    """
    rel = path or DEFAULT_EXEMPTIONS_FILE
    src = ctx.source(rel)
    if src is None:
        if path is not None:
            raise ExemptionError(f"exemption file {rel!r} not found")
        return []
    try:
        doc = json.loads(src)
    except json.JSONDecodeError as e:
        raise ExemptionError(f"invalid JSON in {rel!r}: {e}") from e
    if not isinstance(doc, dict) or doc.get("schema") != EXEMPTIONS_SCHEMA:
        raise ExemptionError(
            f"{rel!r} must be an object with \"schema\": "
            f"{EXEMPTIONS_SCHEMA}"
        )
    entries = doc.get("exemptions", [])
    if not isinstance(entries, list):
        raise ExemptionError(f"{rel!r}: \"exemptions\" must be a list")
    rules = set(known_rules) if known_rules is not None else None
    out: List[Exemption] = []
    for i, e in enumerate(entries):
        if not isinstance(e, dict):
            raise _entry_error(i, f"must be an object, got {type(e).__name__}")
        unknown = set(e) - {"rule", "path", "symbol", "justification"}
        if unknown:
            raise _entry_error(i, f"unknown keys {sorted(unknown)}")
        rule = e.get("rule")
        if not isinstance(rule, str) or not rule:
            raise _entry_error(i, "\"rule\" must be a non-empty string")
        if rules is not None and rule not in rules:
            raise _entry_error(
                i, f"unknown rule {rule!r}; known rules: {sorted(rules)}"
            )
        p = e.get("path")
        if not isinstance(p, str) or not p:
            raise _entry_error(i, "\"path\" must be a non-empty string")
        if not ctx.exists(p):
            raise _entry_error(
                i, f"path {p!r} does not exist in the repository "
                "(stale exemption? remove or update it)"
            )
        just = e.get("justification")
        if not isinstance(just, str) or not just.strip():
            raise _entry_error(
                i, "\"justification\" is mandatory and must be a "
                "non-empty string"
            )
        symbol = e.get("symbol", "")
        if not isinstance(symbol, str):
            raise _entry_error(i, "\"symbol\" must be a string")
        out.append(
            Exemption(rule=rule, path=p, justification=just.strip(),
                      symbol=symbol)
        )
    return out


def match(
    findings: Sequence[Finding], exemptions: Sequence[Exemption]
) -> Dict[int, Exemption]:
    """Map finding index -> the exemption that covers it (first match)."""
    out: Dict[int, Exemption] = {}
    for i, f in enumerate(findings):
        for ex in exemptions:
            if ex.matches(f):
                out[i] = ex
                break
    return out
