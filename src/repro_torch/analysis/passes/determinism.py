"""determinism: keep nondeterminism out of persisted keys and decisions.

Encodes the tape-key bug class: ``json.dumps(..., default=repr)``
leaked ``<object at 0x7f...>`` addresses into resume-tape keys, so a
restarted sweep never matched its own tape.  The checkable residue:

* ``repr()`` / ``id()`` / ``hash()`` / ``default=repr`` feeding
  ``json.dumps`` or key-building helpers — flagged anywhere in the
  scanned packages (addresses and PYTHONHASHSEED-salted hashes are
  process-local by construction);
* iterating a ``set`` (or set difference/union) directly in a ``for``
  or comprehension — order is hash-salted per process;
* unseeded RNG construction: ``np.random.default_rng()`` with no
  argument, bare ``random.random()``/``random.randint``/etc. module
  calls, ``np.random.<dist>`` module-level draws;
* wall-clock (``time.time``, ``datetime.now``, ``datetime.utcnow``,
  ``time.time_ns``) inside the deterministic core packages — replay and
  goldens require simulated clocks there.  ``perf_counter`` is fine: it
  measures, it never decides.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Tuple

from repro_torch.analysis.astutil import call_name, dotted, walk_calls
from repro_torch.analysis.core import Finding, RepoContext, register_rule

RULE = "determinism"

#: packages that must stay deterministic end to end
SCAN_DIRS: Tuple[str, ...] = (
    "src/repro_torch/serving",
    "src/repro_torch/cluster",
    "src/repro_torch/experiments",
    "src/repro_torch/core",
    "src/repro_torch/migration",
)

_WALL_CLOCK = {
    "time.time",
    "time.time_ns",
    "datetime.now",
    "datetime.utcnow",
    "datetime.datetime.now",
    "datetime.datetime.utcnow",
}

_UNSEEDED_RANDOM = {
    "random.random", "random.randint", "random.uniform", "random.choice",
    "random.shuffle", "random.sample", "random.gauss", "random.randrange",
}

_NP_MODULE_DRAWS = {
    "np.random.rand", "np.random.randn", "np.random.randint",
    "np.random.random", "np.random.uniform", "np.random.choice",
    "np.random.permutation", "np.random.shuffle", "np.random.normal",
    "numpy.random.rand", "numpy.random.randn", "numpy.random.randint",
    "numpy.random.random", "numpy.random.uniform", "numpy.random.choice",
    "numpy.random.permutation", "numpy.random.shuffle",
    "numpy.random.normal",
}


def _is_set_expr(node: ast.AST) -> bool:
    """Syntactically a set: literal, ``set(...)`` call, or an operation
    over such (``set(a) - set(b)``, ``a | b`` where a side is a set)."""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and call_name(node) in {
        "set", "frozenset"
    }:
        return True
    if isinstance(node, ast.BinOp) and isinstance(
        node.op, (ast.Sub, ast.BitOr, ast.BitAnd, ast.BitXor)
    ):
        return _is_set_expr(node.left) or _is_set_expr(node.right)
    return False


def _rng_findings(path: str, tree: ast.AST) -> List[Finding]:
    out: List[Finding] = []
    for call in walk_calls(tree):
        name = call_name(call) or ""
        if name in {"np.random.default_rng", "numpy.random.default_rng"}:
            if not call.args and not call.keywords:
                out.append(Finding(
                    rule=RULE, path=path, line=call.lineno,
                    symbol="default_rng",
                    message="np.random.default_rng() without a seed draws "
                            "from OS entropy — every run differs",
                    hint="thread an explicit seed (spec.seed) into the "
                         "generator",
                ))
        elif name in _UNSEEDED_RANDOM or name in _NP_MODULE_DRAWS:
            out.append(Finding(
                rule=RULE, path=path, line=call.lineno,
                symbol=name.split(".")[-1],
                message=f"{name}() uses the shared global RNG whose state "
                        "no spec seed controls",
                hint="use a seeded np.random.Generator / random.Random "
                     "instance owned by the component",
            ))
    return out


def _clock_findings(path: str, tree: ast.AST) -> List[Finding]:
    out: List[Finding] = []
    for call in walk_calls(tree):
        name = call_name(call) or ""
        if name in _WALL_CLOCK:
            out.append(Finding(
                rule=RULE, path=path, line=call.lineno,
                symbol=name,
                message=f"{name}() reads the wall clock inside the "
                        "deterministic core — replay and goldens need "
                        "simulated time",
                hint="take the current time from the simulation clock, or "
                     "use time.perf_counter() if this only measures "
                     "elapsed durations",
            ))
    return out


def _repr_findings(path: str, tree: ast.AST) -> List[Finding]:
    out: List[Finding] = []
    for call in walk_calls(tree):
        name = call_name(call) or ""
        if name.endswith("json.dumps") or name == "dumps" or (
            name.split(".")[-1] == "dumps"
        ):
            for kw in call.keywords:
                if kw.arg == "default" and dotted(kw.value) in {
                    "repr", "str(repr)", "id", "hash"
                }:
                    out.append(Finding(
                        rule=RULE, path=path, line=call.lineno,
                        symbol="json.dumps",
                        message="json.dumps(default=repr) leaks object "
                                "addresses into serialized output — keys "
                                "built from it never match across "
                                "processes",
                        hint="serialize an explicit stable projection of "
                             "the object instead of repr()",
                    ))
    # id()/hash()/repr() embedded in f-strings (persisted-key smell)
    for node in ast.walk(tree):
        if isinstance(node, ast.JoinedStr):
            for v in node.values:
                if isinstance(v, ast.FormattedValue):
                    for call in walk_calls(v.value):
                        if call_name(call) in {"id", "repr", "hash"}:
                            out.append(Finding(
                                rule=RULE, path=path, line=node.lineno,
                                symbol=call_name(call) or "",
                                message=f"{call_name(call)}() interpolated "
                                        "into a string — object addresses "
                                        "and salted hashes are "
                                        "process-local, so any key or "
                                        "artifact built from this string "
                                        "is nondeterministic",
                                hint="build the key from stable fields "
                                     "(names, indices, spec values)",
                            ))
    return out


def _set_iter_findings(path: str, tree: ast.AST) -> List[Finding]:
    out: List[Finding] = []

    def flag(node: ast.AST, line: int) -> None:
        out.append(Finding(
            rule=RULE, path=path, line=line, symbol="set-iteration",
            message="iterating a set directly — element order is "
                    "hash-salted per process, so anything order-sensitive "
                    "downstream (lists, JSON, tapes) diverges between "
                    "runs",
            hint="wrap in sorted(...) or iterate the original ordered "
                 "container",
        ))

    for node in ast.walk(tree):
        if isinstance(node, ast.For) and _is_set_expr(node.iter):
            flag(node.iter, node.lineno)
        elif isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.SetComp,
                               ast.DictComp)):
            for gen in node.generators:
                if _is_set_expr(gen.iter):
                    flag(gen.iter, node.lineno)
    return out


@register_rule(
    RULE,
    "no repr()/id()/hash()-derived keys, unseeded RNGs, wall-clock reads, "
    "or raw set iteration in the deterministic core packages",
)
def run(ctx: RepoContext) -> List[Finding]:
    findings: List[Finding] = []
    for d in SCAN_DIRS:
        for path in ctx.py_files(d):
            tree = ctx.tree(path)
            if tree is None:
                continue
            findings += _repr_findings(path, tree)
            findings += _set_iter_findings(path, tree)
            findings += _rng_findings(path, tree)
            findings += _clock_findings(path, tree)
    findings.sort(key=lambda f: (f.path, f.line, f.symbol))
    return findings
