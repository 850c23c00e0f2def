"""What ``BENCHMARK.json`` and the data files beside the harness say: the
cells, their configurations, traffic mixes and limits, and the metrics a
run of a cell reports.  Everything is found by name."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def limits(cell_name: str) -> dict:
    """The cell's correctness limits (``checks/<cell>.json``)."""
    return json.loads((BENCH / "checks" / f"{cell_name}.json").read_text())


def metrics_for(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics with
    ``--trace 0``, its per-layer ones with ``--trace 1``."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def reader_file(metric: str) -> Path:
    """``metrics/<metric>.py``, or where there is none the file of the name
    without its last dotted part, and so on: ``decode_step_ms.qwen25-chat``
    reads ``metrics/decode_step_ms.py``.  A metric that differs by cell
    only in the end-to-end metric it moves shares its reader."""
    name = metric
    while not (BENCH / "metrics" / f"{name}.py").is_file():
        if "." not in name:
            raise FileNotFoundError(f"no reader of {metric!r} in {BENCH / 'metrics'}")
        name = name.rsplit(".", 1)[0]
    return BENCH / "metrics" / f"{name}.py"


def reader(metric: str) -> Callable:
    """``read(ctx)`` of the metric's reader (``reader_file``): the metric's
    value, or None where the run holds nothing to read."""
    path = reader_file(metric)
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reference(arch: str):
    """The plain reference module ``reference/<arch>.py``."""
    return importlib.import_module(f"portbench.reference.{arch}")
