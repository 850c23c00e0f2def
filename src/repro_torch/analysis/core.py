"""Core of the repo-aware static invariant checker.

This module defines the three primitives every lint pass is built on:

* :class:`Finding` — one violation, anchored to ``file:line`` with a rule
  id, a human message, a fix hint, and a stable ``symbol`` the exemption
  file can match on (e.g. ``"SimSpec.timeout_s"``);
* :class:`RepoContext` — a lazy, cached view of the repository (source
  text + parsed ASTs keyed by repo-relative posix paths), so a pass can
  run identically against the real tree or a tiny fixture tree in tests;
* the rule registry — each pass registers a ``(rule id, description,
  run(ctx) -> findings)`` triple via :func:`register_rule`; the runner
  and the CLI discover passes only through the registry, so disabling a
  rule is dropping its id from the selection.

Passes are pure functions of the AST/source — nothing here imports the
modules under analysis, so a syntax error in the repo is a finding
(``parse-error``), never a crash of the checker itself.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Callable, Dict, List, Optional

__all__ = [
    "Finding",
    "RepoContext",
    "Rule",
    "RULES",
    "register_rule",
    "rule_ids",
]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint violation.

    ``symbol`` is the stable anchor exemptions match on (a dotted name
    like ``SimSpec.concurrency`` or a function name); it stays valid
    across unrelated line churn, unlike ``line``.
    """

    rule: str
    path: str          # repo-relative, posix separators
    line: int
    message: str
    hint: str = ""
    symbol: str = ""

    def to_dict(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "symbol": self.symbol,
            "message": self.message,
            "hint": self.hint,
        }

    @staticmethod
    def from_dict(d: Dict[str, object]) -> "Finding":
        return Finding(
            rule=str(d["rule"]),
            path=str(d["path"]),
            line=int(d["line"]),          # type: ignore[arg-type]
            message=str(d["message"]),
            hint=str(d.get("hint", "")),
            symbol=str(d.get("symbol", "")),
        )

    def location(self) -> str:
        return f"{self.path}:{self.line}"


class RepoContext:
    """Cached source/AST access rooted at a repository checkout.

    All paths in and out are repo-relative with ``/`` separators; a pass
    never touches the filesystem directly, which is what lets the test
    suite point the same pass at a synthetic fixture tree.
    """

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        self._source: Dict[str, Optional[str]] = {}
        self._tree: Dict[str, Optional[ast.AST]] = {}
        #: files that failed to parse: rel path -> (lineno, message)
        self.parse_errors: Dict[str, tuple] = {}

    # -- path helpers ---------------------------------------------------
    def abspath(self, rel: str) -> str:
        return os.path.join(self.root, *rel.split("/"))

    def exists(self, rel: str) -> bool:
        return os.path.isfile(self.abspath(rel))

    def py_files(self, rel_dir: str) -> List[str]:
        """Sorted repo-relative paths of every ``.py`` under ``rel_dir``."""
        base = self.abspath(rel_dir)
        out: List[str] = []
        if not os.path.isdir(base):
            return out
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames.sort()
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    full = os.path.join(dirpath, fn)
                    rel = os.path.relpath(full, self.root)
                    out.append(rel.replace(os.sep, "/"))
        return out

    def files(self, rel_dir: str, suffixes: tuple) -> List[str]:
        """Sorted repo-relative non-Python files (e.g. example YAMLs)."""
        base = self.abspath(rel_dir)
        out: List[str] = []
        if not os.path.isdir(base):
            return out
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames.sort()
            for fn in sorted(filenames):
                if fn.endswith(suffixes):
                    full = os.path.join(dirpath, fn)
                    rel = os.path.relpath(full, self.root)
                    out.append(rel.replace(os.sep, "/"))
        return out

    # -- content access -------------------------------------------------
    def source(self, rel: str) -> Optional[str]:
        if rel not in self._source:
            try:
                with open(self.abspath(rel), encoding="utf-8") as f:
                    self._source[rel] = f.read()
            except OSError:
                self._source[rel] = None
        return self._source[rel]

    def tree(self, rel: str) -> Optional[ast.AST]:
        """Parsed AST, or ``None`` (missing file / syntax error).

        A syntax error is recorded in :attr:`parse_errors`; the runner
        turns those into ``parse-error`` findings so a broken file fails
        the gate instead of silently shrinking every pass's scope.
        """
        if rel not in self._tree:
            src = self.source(rel)
            if src is None:
                self._tree[rel] = None
            else:
                try:
                    self._tree[rel] = ast.parse(src, filename=rel)
                except SyntaxError as e:
                    self._tree[rel] = None
                    self.parse_errors[rel] = (e.lineno or 1, e.msg or "")
        return self._tree[rel]


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    description: str
    run: Callable[[RepoContext], List[Finding]]


RULES: Dict[str, Rule] = {}


def register_rule(
    rule_id: str, description: str
) -> Callable[[Callable[[RepoContext], List[Finding]]],
              Callable[[RepoContext], List[Finding]]]:
    """Decorator: register ``fn(ctx) -> [Finding]`` under ``rule_id``."""

    def wrap(fn: Callable[[RepoContext], List[Finding]]):
        if rule_id in RULES:
            raise ValueError(f"duplicate rule id {rule_id!r}")
        RULES[rule_id] = Rule(id=rule_id, description=description, run=fn)
        return fn

    return wrap


def rule_ids() -> List[str]:
    return sorted(RULES)
