"""Cells by name: BENCHMARK.json, then the cell's configuration and traffic
files.  Nothing here knows a cell: a new cell is a line of BENCHMARK.json
and, where it needs them, a new configuration or traffic file."""
from __future__ import annotations

import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> dict:
    """-> {"name", "chips", "config": {...}, "traffic": {...},
    "end_to_end": [metric], "per_layer": [metric]}: the cell's own metrics,
    each a BENCHMARK.json entry (a metric with a "workloads" key only
    where it names this cell)."""
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg_entry = configs[cell["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic",
                           cell["traffic"] + ".json")) as f:
        traffic = json.load(f)

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return dict(name=name, chips=int(cell["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"] if mine(m)],
                per_layer=[m for m in spec["per_layer"] if mine(m)])
