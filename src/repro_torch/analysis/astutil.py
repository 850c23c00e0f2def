"""Small AST helpers shared by the lint passes."""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Union

FuncDef = Union[ast.FunctionDef, ast.AsyncFunctionDef]

__all__ = [
    "FuncDef",
    "dotted",
    "call_name",
    "walk_calls",
    "func_defs",
    "dataclass_fields",
    "consumed_names",
]


def dotted(node: ast.AST) -> Optional[str]:
    """Dotted name of a Name/Attribute chain, else ``None``.

    ``np.random.default_rng`` -> ``"np.random.default_rng"``;
    chains rooted in calls/subscripts return ``None`` (not a plain name).
    """
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    return dotted(call.func)


def walk_calls(node: ast.AST) -> Iterator[ast.Call]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            yield sub


def func_defs(tree: ast.AST) -> Iterator[FuncDef]:
    """All function definitions, including nested ones and methods."""
    for sub in ast.walk(tree):
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield sub


def dataclass_fields(cls: ast.ClassDef) -> List[ast.AnnAssign]:
    """Annotated class-body assignments — the dataclass field set."""
    out: List[ast.AnnAssign] = []
    for stmt in cls.body:
        if isinstance(stmt, ast.AnnAssign) and isinstance(
            stmt.target, ast.Name
        ):
            out.append(stmt)
    return out


def is_dataclass_def(cls: ast.ClassDef) -> bool:
    """True when the class carries a ``dataclass`` decorator."""
    for dec in cls.decorator_list:
        node = dec.func if isinstance(dec, ast.Call) else dec
        name = dotted(node) or ""
        if name.split(".")[-1] == "dataclass":
            return True
    return False


def consumed_names(tree: ast.AST) -> Set[str]:
    """Names a module plausibly *consumes* as configuration:

    attribute reads (``self.timeout_s``, ``spec.concurrency``), keyword
    arguments (``timeout_s=...``) and function parameters.  This is the
    name-level consumption signal the engine-parity pass compares across
    engines — deliberately syntactic, so it works on any engine style
    (object per request, NumPy arrays, kernel wrappers) without
    importing the modules.
    """
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            out.add(node.attr)
        elif isinstance(node, ast.keyword) and node.arg is not None:
            out.add(node.arg)
        elif isinstance(node, ast.arg):
            out.add(node.arg)
    return out
