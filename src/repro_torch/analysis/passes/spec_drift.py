"""spec-drift: a spec field nobody loads or demonstrates is drift.

Every field on the spec dataclasses is user-facing surface: it appears
in YAML, flows through ``service/loader.py``, and is compiled by
``service/builder.py``.  A field that the loader/builder never mention
is dead config — it parses, validates, and then changes nothing, which
is worse than an error.  A field no example demonstrates is invisible
surface — users discover it only by reading the dataclass.

Checked for every ``@dataclass`` in ``src/repro_torch/service/spec.py`` and
``src/repro_torch/migration/config.py``:

* **handled** — the field name appears in ``service/loader.py`` or
  ``service/builder.py`` source (substring match on the identifier; the
  loader's generic ``_pick`` walks dataclass fields reflectively, so
  explicit mentions in either file count, as do f-string references
  like ``"sim.duration_hours"``).  For ``MigrationSpec`` the loader is
  ``migration/config.py`` itself (``from_mapping``).
* **demonstrated** — the field name appears as a YAML/JSON key in some
  file under ``examples/`` (``^\\s*#?\\s*name\\s*:`` per line, so a
  commented ``# bandwidth_gbps: 10.0`` showing the knob counts).

A field failing either check is a finding anchored at its declaration;
fields that are internal-only by design get an exemption entry whose
justification says where they are exercised instead.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Tuple

from repro_torch.analysis.astutil import dataclass_fields, is_dataclass_def
from repro_torch.analysis.core import Finding, RepoContext, register_rule

RULE = "spec-drift"

#: spec module -> the loader/builder sources that must mention its fields
SPEC_SOURCES: Dict[str, Tuple[str, ...]] = {
    "src/repro_torch/service/spec.py": (
        "src/repro_torch/service/loader.py",
        "src/repro_torch/service/builder.py",
    ),
    "src/repro_torch/migration/config.py": (
        "src/repro_torch/migration/config.py",
        "src/repro_torch/service/builder.py",
    ),
}

EXAMPLES_DIR = "examples"
_EXAMPLE_SUFFIXES = (".yaml", ".yml", ".json")


def _example_keys(ctx: RepoContext) -> set:
    """Every key-looking token in the example files, commented or not."""
    keys: set = set()
    key_re = re.compile(r"^\s*#?\s*(?:-\s+)?([A-Za-z_][A-Za-z0-9_]*)\s*:")
    for path in ctx.files(EXAMPLES_DIR, _EXAMPLE_SUFFIXES):
        src = ctx.source(path)
        if src is None:
            continue
        for line in src.splitlines():
            m = key_re.match(line)
            if m:
                keys.add(m.group(1))
        # JSON keys: "name": ...
        for m in re.finditer(r'"([A-Za-z_][A-Za-z0-9_]*)"\s*:', src):
            keys.add(m.group(1))
    return keys


def _ident_mentioned(name: str, sources: List[str]) -> bool:
    pat = re.compile(rf"\b{re.escape(name)}\b")
    return any(pat.search(s) for s in sources)


@register_rule(
    RULE,
    "every spec dataclass field must be handled by the loader/builder "
    "and demonstrated (possibly commented) in an example file",
)
def run(ctx: RepoContext) -> List[Finding]:
    example_keys = _example_keys(ctx)
    has_examples = bool(ctx.files(EXAMPLES_DIR, _EXAMPLE_SUFFIXES))
    findings: List[Finding] = []
    for spec_path, handler_paths in SPEC_SOURCES.items():
        tree = ctx.tree(spec_path)
        if tree is None:
            continue
        handler_srcs = [
            s for p in handler_paths
            for s in [ctx.source(p)] if s is not None
        ]
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            if not is_dataclass_def(node):
                continue
            for field in dataclass_fields(node):
                name = field.target.id  # type: ignore[union-attr]
                if name.startswith("_"):
                    continue
                symbol = f"{node.name}.{name}"
                if handler_srcs and not _ident_mentioned(
                    name, handler_srcs
                ):
                    findings.append(Finding(
                        rule=RULE, path=spec_path, line=field.lineno,
                        symbol=symbol,
                        message=f"{symbol} is declared but never "
                                "mentioned by its loader/builder — dead "
                                "config that parses and then changes "
                                "nothing",
                        hint="wire the field through the loader/builder "
                             "or delete it",
                    ))
                if has_examples and name not in example_keys:
                    findings.append(Finding(
                        rule=RULE, path=spec_path, line=field.lineno,
                        symbol=symbol,
                        message=f"{symbol} never appears as a key in any "
                                "examples/ file — undemonstrated user "
                                "surface",
                        hint="add the knob (a commented line with its "
                             "default is enough) to an example YAML, or "
                             "exempt it with a pointer to where it is "
                             "exercised",
                    ))
    findings.sort(key=lambda f: (f.path, f.line, f.symbol, f.message))
    return findings
