"""silent-fallback: a degraded path must leave a measurable trace.

Encodes the dropped-futures bug class: ``Suite`` submitted sweep
cells to a pool and iterated ``as_completed`` over a *filtered* subset —
cells that raised were simply absent from the results, and nothing
counted them.  The pattern generalizes: the repo is full of deliberate
fallbacks (an overflowed scenario lane -> the host oracle, calibrated
latency -> roofline), and each one is fine *only if* the degraded run is
observable afterwards.

Flagged:

* an ``except`` handler that warns/logs and then falls through to a
  degraded return/assignment without touching any counter, metrics
  object, or structured record (heuristic: the handler body contains a
  ``warn``/``warning``/``log`` call but no assignment/aug-assignment/
  method call whose target name smells like telemetry — ``*count*``,
  ``*stats*``, ``*metric*``, ``*record*``, ``*fallback*``, ``*event*``,
  ``*registry*`` — the run-scoped ``repro_torch.obs.registry`` counters
  qualify);
* a bare ``except:`` or ``except Exception:`` whose body is only
  ``pass``/``continue``/``return <const>`` — the error is swallowed with
  no trace at all (``raise`` / logging / telemetry in the body clears
  it);
* a log/warn call whose message literally announces a fallback
  (``"falling back to ..."``) inside a function that touches no
  telemetry name — announced degradations are exactly the ones sweeps
  must be able to count afterwards;
* ``concurrent.futures`` result collection that filters the future set
  before ``as_completed`` without a completeness check (an explicit
  ``raise`` or ``assert`` mentioning the expected count in the same
  function clears it).
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional, Tuple

from repro_torch.analysis.astutil import call_name, walk_calls
from repro_torch.analysis.core import Finding, RepoContext, register_rule

RULE = "silent-fallback"

SCAN_DIRS: Tuple[str, ...] = (
    "src/repro_torch",
)

_LOG_CALL = re.compile(r"(^|\.)((warn(ing)?)|log|error|info|debug)$")
_TELEMETRY = re.compile(
    r"(count|stats|metric|record|fallback|event|telemetry|registry)", re.I
)
_FALLBACK_MSG = re.compile(r"fall(ing|s|en)?[\s_-]*back", re.I)


def _is_log_call(call: ast.Call) -> bool:
    name = call_name(call) or ""
    return bool(_LOG_CALL.search(name))


def _mentions_telemetry(node: ast.AST) -> bool:
    """Does any statement in the handler touch a telemetry-ish name?"""
    for sub in ast.walk(node):
        if isinstance(sub, (ast.Name, ast.Attribute)):
            name = sub.attr if isinstance(sub, ast.Attribute) else sub.id
            if _TELEMETRY.search(name):
                return True
        elif isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            # structured record payloads often carry the marker as a key
            if _TELEMETRY.search(sub.value):
                return True
    return False


def _reraises(handler: ast.ExceptHandler) -> bool:
    for sub in ast.walk(handler):
        if isinstance(sub, ast.Raise):
            return True
    return False


def _handler_findings(path: str, tree: ast.AST) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        for handler in node.handlers:
            if _reraises(handler):
                continue
            body = handler.body
            warns = any(
                _is_log_call(c)
                for stmt in body for c in walk_calls(stmt)
            )
            # swallowed entirely: pass/continue/constant return, no log
            trivially_swallowed = (
                not warns
                and all(
                    isinstance(s, (ast.Pass, ast.Continue))
                    or (
                        isinstance(s, ast.Return)
                        and (
                            s.value is None
                            or isinstance(s.value, (ast.Constant, ast.Name))
                        )
                    )
                    for s in body
                )
            )
            if trivially_swallowed:
                out.append(Finding(
                    rule=RULE, path=path, line=handler.lineno,
                    symbol="swallowed-except",
                    message="exception swallowed with no log, counter, or "
                            "re-raise — a degraded path nobody can "
                            "observe",
                    hint="log the failure AND bump a fallback counter (or "
                         "append a structured record) before degrading",
                ))
                continue
            if warns and not _mentions_telemetry(handler):
                out.append(Finding(
                    rule=RULE, path=path, line=handler.lineno,
                    symbol="warn-only-fallback",
                    message="handler warns and falls back but records no "
                            "counter or structured event — warnings "
                            "scroll away; sweeps need a measurable "
                            "fallback signal",
                    hint="bump a run-scoped counter alongside the warning "
                         "(repro_torch.obs.registry: get_registry().inc(...)) "
                         "or append a structured record",
                ))
    return out


def _warn_fallback_findings(path: str, tree: ast.AST) -> List[Finding]:
    """Announced fallbacks ('falling back to ...') with no counter."""
    out: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        # attribute nodes to the innermost function: walk skipping
        # nested defs
        own: List[ast.AST] = []

        def collect(n: ast.AST) -> None:
            for child in ast.iter_child_nodes(n):
                if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    continue
                own.append(child)
                collect(child)
        collect(node)

        fallback_warns = []
        warn_node_ids = set()
        for sub in own:
            if not isinstance(sub, ast.Call) or not _is_log_call(sub):
                continue
            announces = any(
                isinstance(c, ast.Constant) and isinstance(c.value, str)
                and _FALLBACK_MSG.search(c.value)
                for c in ast.walk(sub)
            )
            if announces:
                fallback_warns.append(sub)
                warn_node_ids.update(id(s) for s in ast.walk(sub))
        if not fallback_warns:
            continue
        has_telemetry = any(
            isinstance(sub, (ast.Name, ast.Attribute))
            and id(sub) not in warn_node_ids
            and _TELEMETRY.search(
                sub.attr if isinstance(sub, ast.Attribute) else sub.id
            )
            for sub in own
        )
        if has_telemetry:
            continue
        for call in fallback_warns:
            out.append(Finding(
                rule=RULE, path=path, line=call.lineno,
                symbol=node.name,
                message=f"{node.name!r} announces a fallback in a warning "
                        "but records no counter or structured event — the "
                        "degraded run is invisible to sweeps and CI",
                hint="bump a run-scoped fallback counter next to the "
                     "warning (repro_torch.obs.registry: "
                     "get_registry().inc(...))",
            ))
    return out


def _futures_findings(path: str, tree: ast.AST) -> List[Finding]:
    """Filtered as_completed without a completeness check."""
    src_has_futures = False
    out: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for call in walk_calls(node):
            name = call_name(call) or ""
            if name.split(".")[-1] != "as_completed" or not call.args:
                continue
            src_has_futures = True
            arg = call.args[0]
            filtered = isinstance(arg, (ast.ListComp, ast.GeneratorExp)) \
                and any(gen.ifs for gen in arg.generators)
            if not filtered:
                continue
            guarded = any(
                isinstance(sub, (ast.Raise, ast.Assert))
                for sub in ast.walk(node)
            )
            if not guarded:
                out.append(Finding(
                    rule=RULE, path=path, line=call.lineno,
                    symbol=node.name,
                    message="as_completed over a filtered future set with "
                            "no completeness check — futures dropped by "
                            "the filter vanish without an error",
                    hint="after collection, compare len(results) to the "
                         "submitted count and raise on mismatch",
                ))
    del src_has_futures
    return out


@register_rule(
    RULE,
    "every warn-and-degrade path must emit a counter or structured "
    "record; no swallowed exceptions or silently dropped futures",
)
def run(ctx: RepoContext) -> List[Finding]:
    findings: List[Finding] = []
    for d in SCAN_DIRS:
        for path in ctx.py_files(d):
            if path.startswith("src/repro_torch/analysis/"):
                continue  # the checker does not lint itself
            tree = ctx.tree(path)
            if tree is None:
                continue
            findings += _handler_findings(path, tree)
            findings += _warn_fallback_findings(path, tree)
            findings += _futures_findings(path, tree)
    findings.sort(key=lambda f: (f.path, f.line, f.symbol))
    return findings
