"""Finding a cell's files by the names in ``BENCHMARK.json``.

- a configuration: the ``file`` its ``configs`` entry names;
- a traffic mix: ``bench/traffic/<traffic>.json``;
- a cell's correctness limits and sample: ``bench/cells/<workload>.json``;
- a metric: its reader ``bench/metrics/<metric>.py``, a module with
  ``read(run)`` returning a number, or None when the run gave it nothing
  to read.

A later change adds a cell, a mix, a configuration or a metric as new
files and entries; no file here names any of them.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]


class Cell:
    """One workload of ``BENCHMARK.json`` with its files loaded."""

    def __init__(self, spec: dict, name: str, root: Path,
                 bench: Path = BENCH):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.workload = cells[name]
        self.name = name
        configs = {c["name"]: c for c in spec["configs"]}
        self.config = _load(root / configs[self.workload["config"]]["file"])
        self.traffic = _load(bench / "traffic"
                             / f"{self.workload['traffic']}.json")
        self.check = _load(bench / "cells" / f"{name}.json")
        self.chips = int(self.workload["chips"])
        self.end_to_end = _metrics(spec["end_to_end"], name)
        self.per_layer = _metrics(spec["per_layer"], name)
        self.bench = bench


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _metrics(entries: List[dict], cell: str) -> List[dict]:
    """The metrics of ``entries`` the cell reports: those listing it, and
    those that list no cells."""
    return [m for m in entries
            if "workloads" not in m or cell in m["workloads"]]


def reader(bench: Path, metric: str):
    """The ``read`` function of ``bench/metrics/<metric>.py``."""
    path = bench / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def read_metrics(cell: Cell, entries: List[dict], run) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of every metric in ``entries`` whose
    reader found something to read."""
    out = {}
    for m in entries:
        value = reader(cell.bench, m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
