"""Finds every piece of the benchmark by its name in `BENCHMARK.json`:

    configs/<config>.json     a configuration: entry, reference, checks
    traffic/<traffic>.json    a traffic mix, read by pb/traffic.py
    workloads/<cell>.json     what a cell adds: the check's sample, traces
    entries/<entry>.py        the adapter that calls the program
    reference/<name>.py       the plain reference of a configuration
    metrics/<metric>.py       the reader of one per-layer metric

A later change adds a configuration, a cell or a metric by adding files
and entries; nothing here needs an edit for it.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent      # perfbench/
ROOT = HERE.parent                                 # the checkout


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(extra: str = "") -> dict:
    """`BENCHMARK.json`, with the cells of `extra` added where it is given:
    a file of held cells (`tests/held_cells.json`), whose `configs`,
    `workloads` and `per_layer` entries are appended and whose
    `add_to_workloads` names, for each of its cells, the metrics that
    list it."""
    bench = _json(ROOT / "BENCHMARK.json")
    if not extra:
        return bench
    more = _json(Path(extra))
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        bench[key] = bench[key] + more.get(key, [])
    for cell, names in more.get("add_to_workloads", {}).items():
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m["name"] in names and "workloads" in m and cell not in m["workloads"]:
                m["workloads"] = m["workloads"] + [cell]
    return bench


def _lists(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One entry of `workloads`, with its configuration, its traffic mix,
    its own file and the metrics it reports."""

    def __init__(self, name: str, bench: dict | None = None):
        bench = benchmark() if bench is None else bench
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.spec = found[0]
        self.chips = int(self.spec["chips"])
        self.config = _json(HERE / "configs" / f"{self.spec['config']}.json")
        self.traffic = _json(HERE / "traffic" / f"{self.spec['traffic']}.json")
        self.run = _json(HERE / "workloads" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"] if _lists(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _lists(m, name)]
        if self.config.get("chips", self.chips) != self.chips:
            raise ValueError(f"{name}: the cell asks for {self.chips} chips, "
                             f"its configuration for {self.config['chips']}")


def module(kind: str, name: str):
    """`perfbench/<kind>/<name>.py` as a module; names may hold dots."""
    key = f"perfbench_{kind}_{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {kind}/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod
