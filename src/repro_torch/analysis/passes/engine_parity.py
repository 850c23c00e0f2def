"""engine-parity: a spec field one engine honors, every engine must honor.

The RTT-timeout bug class: ``ServingSimulator`` applied the
client-RTT term to timeout expiry while ``VectorizedServingEngine``
initially did not — both "supported" ``SimSpec.timeout_s`` yet made
different decisions from the same spec.  The cheap, statically checkable
proxy for that invariant: every ``SimSpec`` / ``ServingSpec`` /
``MigrationSpec`` field *consumed* (attribute read, keyword, parameter)
by one engine's file set must be consumed by all three, or the field
must be exempted with a justification naming the fallback contract.

File sets (the port's counterparts of the reference's):

* ``legacy`` — ``serving/sim.py`` + ``serving/replica.py``;
* ``vector`` — ``serving/engine.py``;
* ``jax`` — ``serving/torchengine/{engine,kernel,schedule}.py``, the
  engine a spec selects with ``sim.engine: jax`` (the key stays the
  spec's value).  It *inherits* the vector set (``TorchServingEngine``
  subclasses ``VectorizedServingEngine``, so everything the vector engine
  consumes is consumed on its path).  ``torchengine/recorded.py`` is not
  engine code: it holds the reference benchmark's recorded matrix (the
  counterpart of ``benchmarks/jax_engine.py``'s spec, not of a module of
  ``serving/jaxengine``), and its ``seed=`` keyword, the sweep's seeds
  handed to ``make_workload``, would read as the engine consuming
  ``SimSpec.seed``, which the builder resolves for every engine;
* shared data-plane/migration modules (``serving/token/*``,
  ``migration/planner|runtime``) count for every engine — both engines
  drive the same token batches and migration runtime, and the scenario
  engine delegates token cells to the vector path.

Fields consumed by *no* engine are builder-resolved (horizon, seeds,
engine selection) and are the spec-drift pass's problem, not parity's.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from repro_torch.analysis.astutil import (
    consumed_names,
    dataclass_fields,
)
from repro_torch.analysis.core import Finding, RepoContext, register_rule

RULE = "engine-parity"

#: spec classes whose fields engines consume directly (name -> source file)
SPEC_CLASSES: Dict[str, str] = {
    "SimSpec": "src/repro_torch/service/spec.py",
    "ServingSpec": "src/repro_torch/service/spec.py",
    "MigrationSpec": "src/repro_torch/migration/config.py",
}

ENGINE_FILES: Dict[str, Tuple[str, ...]] = {
    "legacy": (
        "src/repro_torch/serving/sim.py",
        "src/repro_torch/serving/replica.py",
    ),
    "vector": ("src/repro_torch/serving/engine.py",),
    "jax": (
        "src/repro_torch/serving/torchengine/engine.py",
        "src/repro_torch/serving/torchengine/kernel.py",
        "src/repro_torch/serving/torchengine/schedule.py",
    ),
}

#: engine -> engine whose consumption it inherits (subclass relationship)
ENGINE_INHERITS: Dict[str, str] = {"jax": "vector"}

#: modules shared by every engine's data plane
SHARED_FILES: Tuple[str, ...] = (
    "src/repro_torch/serving/token/batch.py",
    "src/repro_torch/serving/token/config.py",
    "src/repro_torch/serving/token/metrics.py",
    "src/repro_torch/serving/token/replica.py",
    "src/repro_torch/migration/planner.py",
    "src/repro_torch/migration/runtime.py",
)


def _spec_fields(ctx: RepoContext) -> Dict[str, List[Tuple[str, str, int]]]:
    """class name -> [(field, source path, line)] for the spec classes."""
    out: Dict[str, List[Tuple[str, str, int]]] = {}
    for cls_name, path in SPEC_CLASSES.items():
        tree = ctx.tree(path)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) and node.name == cls_name:
                out[cls_name] = [
                    (f.target.id, path, f.lineno)  # type: ignore[union-attr]
                    for f in dataclass_fields(node)
                ]
                break
    return out


def _engine_consumption(ctx: RepoContext) -> Dict[str, Set[str]]:
    shared: Set[str] = set()
    for path in SHARED_FILES:
        tree = ctx.tree(path)
        if tree is not None:
            shared |= consumed_names(tree)
    consumed: Dict[str, Set[str]] = {}
    for engine, paths in ENGINE_FILES.items():
        names = set(shared)
        for path in paths:
            tree = ctx.tree(path)
            if tree is not None:
                names |= consumed_names(tree)
        consumed[engine] = names
    for engine, base in ENGINE_INHERITS.items():
        consumed[engine] |= consumed[base]
    return consumed


@register_rule(
    RULE,
    "spec fields consumed by one serving engine must be consumed by all "
    "engines (or carry an exemption naming the fallback contract)",
)
def run(ctx: RepoContext) -> List[Finding]:
    # engines whose files are entirely absent (fixture trees) drop out of
    # the comparison rather than reading as "consumes nothing"
    present = [
        e for e, paths in ENGINE_FILES.items()
        if any(ctx.tree(p) is not None for p in paths)
        or any(
            ctx.tree(p) is not None
            for p in ENGINE_FILES.get(ENGINE_INHERITS.get(e, ""), ())
        )
    ]
    if len(present) < 2:
        return []
    consumed = _engine_consumption(ctx)
    findings: List[Finding] = []
    for cls_name, fields in sorted(_spec_fields(ctx).items()):
        for field, path, line in fields:
            consumers = [e for e in present if field in consumed[e]]
            if not consumers or len(consumers) == len(present):
                continue
            missing = [e for e in present if e not in consumers]
            findings.append(Finding(
                rule=RULE,
                path=path,
                line=line,
                symbol=f"{cls_name}.{field}",
                message=(
                    f"{cls_name}.{field} is consumed by the "
                    f"{'/'.join(consumers)} engine"
                    f"{'s' if len(consumers) > 1 else ''} but not by "
                    f"{'/'.join(missing)} — engines must stay "
                    "decision-identical for every spec knob"
                ),
                hint=(
                    "consume the field on the missing engine path, or add "
                    "an analysis exemption whose justification names the "
                    "documented fallback (e.g. 'token cells delegate to "
                    "the vector data plane')"
                ),
            ))
    return findings
