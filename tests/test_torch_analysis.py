"""The port's static checker (``repro_torch.analysis``) held against the
reference's (``repro.analysis``).

(a) Every case of the reference's own tests (``tests/test_analysis.py``)
    but its tracing and whole-repository cases is run as it stands, with
    its ``run_analysis`` and CLI ``main`` replaced by a mirror: each call
    runs the reference's checker on the case's tree and the port's on a
    copy of that tree with ``src/repro/`` moved to ``src/repro_torch/`` and
    ``analysis_exemptions.json`` to ``analysis_exemptions_torch.json``.
    Findings (rule, path, line, symbol, message, hint, exemption), the
    files scanned, stale exemptions, errors, exit codes, stdout and the
    report artifact must agree once the reference's package paths, tool
    name and report path are mapped to the port's.  The cases that read
    only the rule registry, the report schema or the CLI's rule list run
    against the port's objects themselves.
(b) The tracing pass is translated (JAX's trace boundary becomes CUDA-graph
    capture): each of the reference's three tracing cases has a capture
    twin whose findings agree in rule and symbol, each side's line on its
    own hazard; more capture cases pin the roots, the closure over every
    definition of a name, the host syncs and the dropped 64-bit family.
(c) The real trees: the port's findings on ``src/repro_torch`` equal the
    reference's on ``src/repro`` (rule, path mapped, symbol) less the one
    the port has no counterpart of.
(d) The gate: the port's tree is clean under every rule with its own
    exemption file, every entry used and justified.
"""

import contextlib
import functools
import inspect
import io
import json
import os
import shutil
import textwrap

import pytest

import test_analysis as ref_tests
from repro import analysis as ja
from repro.analysis.__main__ import main as j_main
from repro_torch import analysis as ta
from repro_torch.analysis.__main__ import main as t_main
from repro_torch.analysis.core import RepoContext as TRepoContext

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's names and paths -> the port's
_MAP = (
    ("src/repro/", "src/repro_torch/"),
    ("repro.analysis", "repro_torch.analysis"),
    ("repro.obs.registry", "repro_torch.obs.registry"),
    ("analysis_exemptions.json", "analysis_exemptions_torch.json"),
    (os.path.join("artifacts", "analysis", ""),
     os.path.join("artifacts", "analysis_torch", "")),
)


def _to_port(text: str) -> str:
    for a, b in _MAP:
        text = text.replace(a, b)
    return text


def _mirror_tree(ref_root: str, port_root: str) -> None:
    """Copy a fixture tree for the port: paths and file contents mapped,
    report artifacts left behind."""
    shutil.rmtree(port_root, ignore_errors=True)
    for dirpath, _, files in os.walk(ref_root):
        for name in files:
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, ref_root).replace(os.sep, "/")
            if rel.startswith("artifacts/"):
                continue
            dst = os.path.join(port_root, *_to_port(rel).split("/"))
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            with open(full, encoding="utf-8") as f:
                text = f.read()
            if name == "analysis_exemptions.json":
                text = _to_port(text)
            with open(dst, "w", encoding="utf-8") as f:
                f.write(text)


def _normal(report) -> dict:
    """A report as a dict, without its ``tool``."""
    d = report.to_dict()
    d.pop("tool")
    return d


def _mapped(d: dict) -> dict:
    return json.loads(_to_port(json.dumps(d)))


class Mirror:
    """Stands in for the reference test module's ``run_analysis`` and
    ``analysis_main``: runs both checkers, compares them, returns the
    reference's answer so the reference's own assertions still hold."""

    def __init__(self, base: str) -> None:
        self.base, self.calls = base, 0

    def _port_root(self, root: str) -> str:
        if os.path.abspath(root) == REPO_ROOT:
            return REPO_ROOT        # the port scans its own package there
        self.calls += 1
        port_root = os.path.join(self.base, f"port{self.calls}")
        _mirror_tree(root, port_root)
        return port_root

    def run_analysis(self, root, **kw):
        port_root = self._port_root(root)
        try:
            want = ja.run_analysis(root, **kw)
        except (KeyError, ja.ExemptionError) as e:
            with pytest.raises((KeyError, ta.ExemptionError)) as got:
                ta.run_analysis(port_root, **kw)
            assert type(got.value).__name__ == type(e).__name__
            assert str(got.value) == _to_port(str(e))
            raise
        got = ta.run_analysis(port_root, **kw)
        assert got.to_dict()["tool"] == "repro_torch.analysis"
        assert _normal(got) == _mapped(_normal(want))
        return want

    def main(self, argv):
        argv = list(argv)
        port_argv = list(argv)
        if "--root" in argv:
            i = argv.index("--root") + 1
            port_argv[i] = self._port_root(argv[i])
        with contextlib.redirect_stdout(io.StringIO()) as ref_out:
            rc = j_main(argv)
        with contextlib.redirect_stdout(io.StringIO()) as port_out:
            port_rc = t_main(port_argv)
        assert port_rc == rc
        text = ref_out.getvalue()
        want, got = text, port_out.getvalue()
        if "json" in argv:
            want, got = json.loads(want), json.loads(got)
            assert got.pop("tool") == "repro_torch.analysis"
            want.pop("tool")
            assert got == _mapped(want)
        elif "--list-rules" in argv:
            ids = [line.split(":")[0] for line in want.splitlines()]
            assert [line.split(":")[0] for line in got.splitlines()] == ids
        else:
            assert got == _to_port(want)
        if "--out" not in argv and "--list-rules" not in argv:
            root = argv[argv.index("--root") + 1]
            ref_report = ja.AnalysisReport.load(os.path.join(
                root, "artifacts", "analysis", "report.json"))
            port_report = ta.AnalysisReport.load(os.path.join(
                port_argv[port_argv.index("--root") + 1], "artifacts",
                "analysis_torch", "report.json"))
            assert _normal(port_report) == _mapped(_normal(ref_report))
        print(text, end="")
        return rc


# reference cases that read only module-level objects: run them against
# the port's objects themselves
_PORT_OBJECTS = {
    "test_all_five_rules_registered": {"RULES": ta.RULES,
                                       "rule_ids": ta.rule_ids},
    "test_report_schema_gate": {"AnalysisReport": ta.AnalysisReport},
    "test_cli_list_rules": {"analysis_main": t_main},
    "test_unknown_rule_raises": {"run_analysis": ta.run_analysis},
}
_TRACING = ("test_tracing_flags_backend_query_in_jit",
            "test_tracing_clean_when_query_hoisted",
            "test_tracing_follows_helpers_called_from_traced_bodies")
_WHOLE_REPO = ("test_repository_is_clean_under_all_rules",
               "test_repository_exemption_file_is_valid")
REFERENCE_CASES = sorted(
    name for name, fn in vars(ref_tests).items()
    if name.startswith("test_") and callable(fn)
    and name not in _TRACING + _WHOLE_REPO)


def _call(fn, tmp_path, capsys):
    kw = {}
    params = inspect.signature(fn).parameters
    if "tmp_path" in params:
        kw["tmp_path"] = tmp_path
    if "capsys" in params:
        kw["capsys"] = capsys
    fn(**kw)


def test_reference_cases_are_all_mirrored():
    """Every case of the reference's tests is covered here: (a) above, the
    tracing cases by their capture twins (b), the whole-repository cases
    by (c) and (d)."""
    names = {n for n in vars(ref_tests) if n.startswith("test_")}
    assert len(names) == 31
    assert names == set(REFERENCE_CASES) | set(_TRACING) | set(_WHOLE_REPO)
    assert set(_TRACING) == set(TRACING_TWINS)


@pytest.mark.parametrize("case", REFERENCE_CASES)
def test_reference_case_on_both_checkers(case, tmp_path, capsys,
                                         monkeypatch):
    fn = getattr(ref_tests, case)
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    if case in _PORT_OBJECTS:
        for name, obj in _PORT_OBJECTS[case].items():
            monkeypatch.setattr(ref_tests, name, obj)
        _call(fn, ref_dir, capsys)
        return
    mirror = Mirror(str(tmp_path))
    monkeypatch.setattr(ref_tests, "run_analysis", mirror.run_analysis)
    monkeypatch.setattr(ref_tests, "analysis_main", mirror.main)
    _call(fn, ref_dir, capsys)
    assert mirror.calls >= 1


# ---------------------------------------------------------------------------
# (b) tracing: CUDA-graph capture
# ---------------------------------------------------------------------------

# hazard lines carry a "# <-" marker; expected symbols are listed
TRACING_TWINS = {
    "test_tracing_flags_backend_query_in_jit": ("src/repro_torch/kernels/k.py", """\
        import torch


        def step(x, n):
            if torch.cuda.is_available():  # <-
                return x
            return x * n


        def capture(graph, x, n):
            with torch.cuda.graph(graph):
                step(x, n)
    """),
    "test_tracing_clean_when_query_hoisted": ("src/repro_torch/kernels/k.py", """\
        import torch


        def step(x, on_card):
            return x * 2


        def capture(graph, x):
            on_card = torch.cuda.is_available()
            with torch.cuda.graph(graph):
                step(x, on_card)
    """),
    "test_tracing_follows_helpers_called_from_traced_bodies": (
        "src/repro_torch/serving/torchengine/fastpath.py", """\
        import torch


        def _peek(x):
            return x.item()  # <-


        def step(x):
            return _peek(x) + 1


        def capture(graph, x):
            with torch.cuda.graph(graph):
                step(x)
    """),
}


def _write(root, rel, text):
    path = os.path.join(root, *rel.split("/"))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write(textwrap.dedent(text))


def _marked_lines(text):
    return [i for i, line in enumerate(textwrap.dedent(text).splitlines(), 1)
            if line.rstrip().endswith("# <-")]


def _tracing(root):
    report = ta.run_analysis(str(root), rules=["tracing-hazard"])
    return [f.finding for f in report.findings]


@pytest.mark.parametrize("case", sorted(TRACING_TWINS))
def test_tracing_twin_of_reference_case(case, tmp_path, monkeypatch):
    """The reference's case flags its jit body; the capture twin flags the
    captured body: the same rule and symbols, each line on its own side's
    hazard (or both clean)."""
    seen = []

    def record(root, **kw):
        report = ja.run_analysis(root, **kw)
        seen.append(report)
        return report

    monkeypatch.setattr(ref_tests, "run_analysis", record)
    (tmp_path / "ref").mkdir()
    getattr(ref_tests, case)(tmp_path / "ref")
    want = [f.finding for f in seen[0].findings]
    path, text = TRACING_TWINS[case]
    _write(str(tmp_path / "port"), path, text)
    got = _tracing(tmp_path / "port")
    assert [(f.rule, f.symbol) for f in got] == [(f.rule, f.symbol)
                                                 for f in want]
    assert [f.line for f in got] == _marked_lines(text)
    assert all(f.path == path for f in got)


CAPTURE_CASES = {
    # the steps' shape: the base's _step is abstract, the overrides run
    "override_in_subclass": ("src/repro_torch/launch/steps.py", """\
        import torch


        class Captured:
            def _step(self):
                raise NotImplementedError

            def _capture(self, graph):
                with torch.cuda.graph(graph):
                    self._step()


        class Serve(Captured):
            def _step(self):
                n = int(self.length)  # <-
                return self.tokens[:n]


        class Prefill(Captured):
            def _step(self):
                return self.model(self.tokens).item()  # <-
    """, ["_step", "_step"]),
    # self._step() -> self._read() -> .tolist(): two calls deep, methods
    "method_helper_two_deep": ("src/repro_torch/launch/steps.py", """\
        import torch


        class Step:
            def _read(self):
                return self.lengths.tolist()  # <-

            def _step(self):
                return self._read()

            def _capture(self, graph):
                with torch.cuda.graph(graph):
                    self._step()
    """, ["_read"]),
    "host_syncs": ("src/repro_torch/kernels/k.py", """\
        import torch


        def body(x, flag):
            a = x.cpu()  # <-
            b = x.numpy()  # <-
            torch.cuda.synchronize()  # <-
            if bool(flag):  # <-
                return float(x.sum())  # <-
            n = torch.cuda.device_count()  # <-
            return a, b, n, int(3), float("1.5")


        def capture(graph, x, flag):
            with torch.cuda.graph(graph):
                body(x, flag)
    """, ["body"] * 6),
    "statements_of_the_block": ("src/repro_torch/serving/torchengine/g.py", """\
        import torch


        def capture(graph, x):
            n = x.item()
            with torch.cuda.graph(graph):
                y = x * 2
                z = y.max().item()  # <-
            return n, z
    """, ["capture"]),
    "make_graphed_callables": ("src/repro_torch/kernels/k.py", """\
        import torch


        def forward(x):
            if torch.cuda.get_device_capability()[0] >= 9:  # <-
                return x * 2
            return x


        graphed = torch.cuda.make_graphed_callables(forward, (torch.ones(2),))
    """, ["forward"]),
    "uncaptured_function_is_clean": ("src/repro_torch/kernels/k.py", """\
        import torch


        def body(x):
            return x * 2


        def report(x):
            return x.item(), torch.cuda.is_available()


        def capture(graph, x):
            with torch.cuda.graph(graph):
                body(x)
            return report(x)
    """, []),
    # the reference's 64-bit family has no counterpart: torch keeps the
    # dtype it is asked for
    "float64_not_a_hazard": ("src/repro_torch/kernels/k.py", """\
        import numpy as np
        import torch


        def body(x):
            return x.to(torch.float64) + np.float64(1.0)


        def capture(graph, x):
            with torch.cuda.graph(graph):
                body(x)
    """, []),
    "outside_the_scope": ("src/repro_torch/models/m.py", """\
        import torch


        def body(x):
            return x.item()


        def capture(graph, x):
            with torch.cuda.graph(graph):
                body(x)
    """, []),
}


@pytest.mark.parametrize("case", sorted(CAPTURE_CASES))
def test_tracing_capture_case(case, tmp_path):
    path, text, symbols = CAPTURE_CASES[case]
    _write(str(tmp_path), path, text)
    got = _tracing(tmp_path)
    assert [f.symbol for f in got] == symbols
    assert [f.line for f in got] == _marked_lines(text)
    assert all(f.rule == "tracing-hazard" and f.path == path for f in got)


def test_tracing_dropped_family_is_the_reference_64_bit_one(tmp_path):
    """The reference flags a 64-bit literal in a jit body; the port's pass
    has no such family (its docstring says why)."""
    _write(str(tmp_path), "src/repro/kernels/k.py", """\
        import jax
        import numpy as np


        @jax.jit
        def body(x):
            return x + np.float64(1.0)
    """)
    report = ja.run_analysis(str(tmp_path), rules=["tracing-hazard"])
    assert ["32-bit" in f.finding.message for f in report.findings] == [True]
    doc = inspect.getmodule(ta.RULES["tracing-hazard"].run).__doc__
    assert "float64" in doc and "dropped" in doc


# ---------------------------------------------------------------------------
# (c) the real trees, (d) the gate
# ---------------------------------------------------------------------------

# the reference's exempted best-effort ``constrain`` has no counterpart:
# the port's sharding module swallows nothing
ONLY_IN_REFERENCE = {
    ("silent-fallback", "src/repro_torch/distributed/sharding.py",
     "swallowed-except"),
}


@functools.lru_cache(maxsize=None)
def _real_reports():
    return ja.run_analysis(REPO_ROOT), ta.run_analysis(REPO_ROOT)


def test_real_tree_findings_match_reference():
    want, got = _real_reports()
    want_keys = {(f.finding.rule, _to_port(f.finding.path), f.finding.symbol)
                 for f in want.findings}
    got_keys = {(f.finding.rule, f.finding.path, f.finding.symbol)
                for f in got.findings}
    assert ONLY_IN_REFERENCE <= want_keys
    assert got_keys == want_keys - ONLY_IN_REFERENCE
    assert len(got.findings) == len(got_keys) == 9
    assert got.n_files_scanned > 100


@pytest.mark.parametrize("part", ["report", "exemption_file"])
def test_port_tree_is_clean(part):
    if part == "report":
        _, report = _real_reports()
        assert sorted(report.rules) == sorted(ta.rule_ids())
        assert [f.finding.location() for f in report.active] == []
        assert report.unused_exemptions == []
        assert report.n_exempted == 9
        for f in report.findings:
            assert f.exempted and f.justification.strip()
    else:
        exemptions = ta.load_exemptions(TRepoContext(REPO_ROOT),
                                        known_rules=ta.rule_ids())
        assert len(exemptions) == 9
        assert all(e.justification.strip() for e in exemptions)
        assert all(e.path.startswith("src/repro_torch/") for e in exemptions)
        assert {(e.rule, e.path, e.symbol) for e in exemptions}.isdisjoint(
            ONLY_IN_REFERENCE)
