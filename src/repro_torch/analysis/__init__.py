"""repro_torch.analysis — the repo-aware static invariant checker of the
port (counterpart of ``repro.analysis``), run over ``src/repro_torch``.

AST-driven lint framework encoding this repository's bug history as
enforceable rules: engine-parity (spec fields honored by every serving
engine), determinism (no repr/id/hash keys, unseeded RNGs, wall clocks,
or raw set iteration in the deterministic core), tracing-hazard (no
device queries or host syncs inside bodies captured as CUDA graphs),
silent-fallback (degraded paths must emit counters), and spec-drift
(every spec field loaded, built, and demonstrated in an example).

The rule ids, the ``Finding`` fields, the report schema (v1) and the exit
codes are the reference's; the modules are copies, since the port imports
nothing of the reference package.  Only the scanned paths, the exemption
file and the report's path and ``tool`` differ, and the tracing pass,
which is translated from JAX's trace boundary to CUDA-graph capture
(``passes/tracing.py``).

Run it: ``python -m repro_torch.analysis [--format json|text] [--rules ...]``.
Findings are silenced only via ``analysis_exemptions_torch.json`` entries
with mandatory justifications; the JSON report lands at
``artifacts/analysis_torch/report.json`` (schema v1).
"""

from repro_torch.analysis.core import (  # noqa: F401
    Finding,
    RepoContext,
    Rule,
    RULES,
    register_rule,
    rule_ids,
)
from repro_torch.analysis.exemptions import (  # noqa: F401
    Exemption,
    ExemptionError,
    load_exemptions,
)
from repro_torch.analysis.report import AnalysisReport, SCHEMA_VERSION  # noqa: F401
from repro_torch.analysis.runner import run_analysis  # noqa: F401

__all__ = [
    "AnalysisReport",
    "Exemption",
    "ExemptionError",
    "Finding",
    "RepoContext",
    "Rule",
    "RULES",
    "SCHEMA_VERSION",
    "load_exemptions",
    "register_rule",
    "rule_ids",
    "run_analysis",
]
