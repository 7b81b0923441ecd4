"""Everything a run needs, found by name from files.

`BENCHMARK.json` at the checkout's root lists configurations, cells and
metrics.  A cell names a configuration and a traffic mix; the harness finds
the rest by name:

* a configuration's file (the entry's `file`), whose `family` names the
  generator `olapbench/data/<family>.py`, the reference
  `olapbench/reference/<family>.py` and the query folder
  `olapbench/queries/<family>/`;
* a traffic mix: `olapbench/mixes/<traffic>.json`;
* a query: `olapbench/queries/<family>/<query>.json`;
* a per-layer metric: its reader `olapbench/metrics/<metric>.py`.

So a cell, a mix or a metric is added as new files and new entries, with
no edit to a file that is there."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
from typing import Dict, List, Optional

PACKAGE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic: str
    chips: int
    config: dict
    mix: dict
    queries: Dict[str, dict]
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def family(self) -> str:
        return self.config["family"]

    def data_module(self):
        return importlib.import_module(f"olapbench.data.{self.family}")

    def reference_module(self):
        return importlib.import_module(f"olapbench.reference.{self.family}")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(root: str, name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    here = os.path.join(root, "olapbench")
    mix = load_json(os.path.join(here, "mixes", f"{w['traffic']}.json"))
    queries = {r["query"]: load_json(os.path.join(here, "queries", config["family"],
                                                  f"{r['query']}.json"))
               for r in mix["requests"]}
    return Cell(
        name=name, config_name=w["config"], traffic=w["traffic"], chips=int(w["chips"]),
        config=config, mix=mix, queries=queries,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def metric_reader(name: str):
    """The `read(run)` function of `olapbench/metrics/<name>.py` (loaded
    by path: a metric's name may hold dots)."""
    path = os.path.join(PACKAGE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"olapbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
