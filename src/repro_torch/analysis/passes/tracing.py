"""tracing-hazard: host-side effects inside bodies captured as CUDA graphs.

The reference's pass (``repro.analysis.passes.tracing``) encodes the
backend-detection bug class: calling ``jax.default_backend()``
inside a jitted function returns the backend captured at *trace* time and
silently bakes it into the compiled artifact.  The port has no
``jax.jit``, ``pallas_call`` or ``lax.scan``; its trace boundary is
CUDA-graph capture.  ``with torch.cuda.graph(g): body()`` runs ``body``
once and records the kernels it launches; every replay re-issues those
kernels and runs no Python at all.  So the reference's hazards translate:

* a device query — ``torch.cuda.is_available()`` / ``device_count()`` /
  ``current_device()`` / ``get_device_capability()`` /
  ``get_device_properties()`` — is answered once, at capture, and its
  answer is frozen into the graph: the counterpart of
  ``jax.default_backend()`` under jit.  Hoist it to the uncaptured caller;
* a host sync — ``x.item()`` / ``x.tolist()`` / ``x.cpu()`` /
  ``x.numpy()`` / ``torch.cuda.synchronize()``, and ``bool(x)`` /
  ``float(x)`` / ``int(x)`` on non-literal operands — is an error under
  capture, met only on the card: the CPU tests run the same body eagerly,
  where it passes.  The counterpart of ``ConcretizationTypeError`` on the
  first real trace.

The reference's third family, ``np.float64`` / ``np.int64`` literals that
JAX silently down-casts without ``enable_x64``, has no counterpart and is
dropped: torch keeps a 64-bit dtype as it is asked for, and the scenario
engine's ``scenario_scan`` runs in float64 on purpose.

Scope: ``src/repro_torch/kernels/``, ``src/repro_torch/serving/
torchengine/`` and ``src/repro_torch/launch/`` (where the serve and
prefill steps are captured).  Captured bodies are discovered
syntactically:

* the statements of a ``with torch.cuda.graph(...)`` block, and every
  callable called there: a plain ``f()`` names ``def f``, and
  ``self.f()`` (or ``cls.f()``) every ``def f`` in the module;
* the first argument of ``torch.cuda.make_graphed_callables``;
* plus the reference's fix-point closure over module-local helpers called
  from any captured body (a hazard two calls deep still runs at capture),
  with ``self.f()`` resolved as above.

Unlike the reference's, the function table keeps every definition of a
name: the steps' capture calls ``self._step()``, whose base definition is
abstract and whose real bodies are the subclasses' overrides, so keeping
only the first definition would check nothing that is captured.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Set, Tuple

from repro_torch.analysis.astutil import FuncDef, call_name, walk_calls
from repro_torch.analysis.core import Finding, RepoContext, register_rule

RULE = "tracing-hazard"

SCAN_DIRS: Tuple[str, ...] = (
    "src/repro_torch/kernels",
    "src/repro_torch/serving/torchengine",
    "src/repro_torch/launch",
)

_CAPTURE_NAMES = {"torch.cuda.graph", "cuda.graph"}
_GRAPHED_CALLABLES = {
    "torch.cuda.make_graphed_callables", "cuda.make_graphed_callables",
    "make_graphed_callables",
}
_DEVICE_QUERIES = {
    f"{prefix}{name}"
    for prefix in ("torch.cuda.", "cuda.")
    for name in ("is_available", "device_count", "current_device",
                 "get_device_capability", "get_device_properties")
}
_SYNC_CALLS = {"torch.cuda.synchronize", "cuda.synchronize"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_SELF_NAMES = {"self", "cls"}


def _local_name(name: str) -> str:
    """The module-local function a called name refers to, or ``""``:
    ``f`` -> ``f``, ``self.f`` / ``cls.f`` -> ``f``, anything else (a
    method of another object, a function of another module) -> ``""``."""
    parts = name.split(".")
    if len(parts) == 1:
        return name
    if len(parts) == 2 and parts[0] in _SELF_NAMES:
        return parts[1]
    return ""


def _callable_refs(node: ast.expr) -> List[str]:
    """Local function names referenced by an argument expression: plain
    names and ``self.f`` attributes, anywhere inside it (a tuple of
    callables too)."""
    out: List[str] = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.append(sub.id)
        elif isinstance(sub, ast.Attribute) and isinstance(
            sub.value, ast.Name
        ) and sub.value.id in _SELF_NAMES:
            out.append(sub.attr)
    return out


def _is_capture(item: ast.withitem) -> bool:
    ctx = item.context_expr
    return isinstance(ctx, ast.Call) and call_name(ctx) in _CAPTURE_NAMES


def _capture_blocks(tree: ast.AST) -> List[Tuple[ast.With, str]]:
    """Every ``with torch.cuda.graph(...)`` block, with the name of the
    function it sits in (``"<module>"`` at module level)."""
    out: List[Tuple[ast.With, str]] = []

    def visit(node: ast.AST, owner: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, child.name)
                continue
            if isinstance(child, (ast.With, ast.AsyncWith)) and any(
                _is_capture(i) for i in child.items
            ):
                out.append((child, owner))  # type: ignore[arg-type]
            visit(child, owner)

    visit(tree, "<module>")
    return out


def _collect_traced_roots(tree: ast.AST) -> Set[str]:
    """Names of the functions whose bodies run under capture."""
    roots: Set[str] = set()
    for block, _ in _capture_blocks(tree):
        for stmt in block.body:
            for call in walk_calls(stmt):
                name = _local_name(call_name(call) or "")
                if name:
                    roots.add(name)
    for call in walk_calls(tree):
        if call_name(call) in _GRAPHED_CALLABLES and call.args:
            roots.update(_callable_refs(call.args[0]))
    return roots


def _function_table(tree: ast.AST) -> Dict[str, List[FuncDef]]:
    """Every definition of each name in the module, in source order: an
    override is captured wherever its base's name is."""
    out: Dict[str, List[FuncDef]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, []).append(node)
    for defs in out.values():
        defs.sort(key=lambda fn: fn.lineno)
    return out


def _closure(roots: Set[str], table: Dict[str, List[FuncDef]]) -> Set[str]:
    """Fix-point: helpers called from captured bodies are captured too."""
    traced = set(roots)
    changed = True
    while changed:
        changed = False
        for name in list(traced):
            for fn in table.get(name, ()):
                for call in walk_calls(fn):
                    cname = _local_name(call_name(call) or "")
                    if cname and cname in table and cname not in traced:
                        traced.add(cname)
                        changed = True
    return traced


def _is_literal(node: ast.expr) -> bool:
    try:
        ast.literal_eval(node)
        return True
    except (ValueError, SyntaxError, TypeError):
        return False


def _own_nodes(body: List[ast.stmt]) -> Iterator[ast.AST]:
    """The nodes of ``body``, skipping nested function definitions (they
    have their own entry in the captured set when they are called)."""
    stack: List[ast.AST] = list(reversed(body))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(reversed(list(ast.iter_child_nodes(node))))


def _body_findings(
    path: str, symbol: str, body: List[ast.stmt], where: str
) -> List[Finding]:
    out: List[Finding] = []
    for node in _own_nodes(body):
        if not isinstance(node, ast.Call):
            continue
        cname = call_name(node) or ""
        if cname in _DEVICE_QUERIES:
            out.append(Finding(
                rule=RULE, path=path, line=node.lineno, symbol=symbol,
                message=f"{cname}() inside {where} is answered once, at "
                        "capture, and frozen into the CUDA graph",
                hint="query the device in the uncaptured caller and pass "
                     "the answer in",
            ))
        elif cname in _SYNC_CALLS:
            out.append(Finding(
                rule=RULE, path=path, line=node.lineno, symbol=symbol,
                message=f"{cname}() inside {where} synchronizes the "
                        "device — an error under CUDA-graph capture, met "
                        "only on the card",
                hint="synchronize outside the captured region",
            ))
        elif cname in {"bool", "float", "int"} and node.args and not (
            _is_literal(node.args[0])
        ):
            out.append(Finding(
                rule=RULE, path=path, line=node.lineno, symbol=symbol,
                message=f"{cname}() on a tensor inside {where} reads it "
                        "back to the host — an error under CUDA-graph "
                        "capture, met only on the card",
                hint="keep the value on the device (torch.where) or "
                     "compute it before capture",
            ))
        elif (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _SYNC_METHODS
            and not node.args
        ):
            out.append(Finding(
                rule=RULE, path=path, line=node.lineno, symbol=symbol,
                message=f".{node.func.attr}() inside {where} copies a "
                        "tensor to the host — a device sync, an error "
                        "under CUDA-graph capture, met only on the card",
                hint="return the tensor and read it after the replay",
            ))
    return out


@register_rule(
    RULE,
    "no device queries or host syncs inside bodies captured as CUDA "
    "graphs in kernels/, serving/torchengine/ and launch/",
)
def run(ctx: RepoContext) -> List[Finding]:
    findings: List[Finding] = []
    for d in SCAN_DIRS:
        for path in ctx.py_files(d):
            tree = ctx.tree(path)
            if tree is None:
                continue
            for block, owner in _capture_blocks(tree):
                findings += _body_findings(
                    path, owner, block.body,
                    f"the torch.cuda.graph block of {owner!r}")
            table = _function_table(tree)
            traced = _closure(_collect_traced_roots(tree), table)
            for name in sorted(traced):
                for fn in table.get(name, ()):
                    findings += _body_findings(
                        path, fn.name, fn.body,
                        f"captured function {fn.name!r}")
    findings.sort(key=lambda f: (f.path, f.line, f.symbol))
    return findings
