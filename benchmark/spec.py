"""What one cell is, read from BENCHMARK.json and the files it names.

A cell (an entry of `workloads`) names a configuration (an entry of
`configs`, whose `file` is a JSON object under benchmark/configs/) and a
traffic mix (benchmark/traffic/<traffic>.json). A per-layer metric is a
reader module benchmark/metrics/<metric name>.py with a function
`read(run) -> float | None`. Nothing here names a cell, a configuration, a
mix or a metric: a later cell adds files and entries only.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration file's object
    traffic: dict           # the traffic file's object
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]   # the per-layer metrics this cell reports
    readers: Dict[str, Callable]


def _reports(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_of_cell


def load_reader(name: str, metrics_dir: str = None) -> Callable:
    """The `read` function of benchmark/metrics/<name>.py."""
    path = os.path.join(metrics_dir or os.path.join(HERE, "metrics"),
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_cell(workload: str, root: str = ROOT) -> Cell:
    """The cell named `workload` of root/BENCHMARK.json."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    bench_dir = os.path.join(root, "benchmark")
    with open(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, names)]
    readers = {m["name"]: load_reader(m["name"],
                                      os.path.join(bench_dir, "metrics"))
               for m in per_layer}
    return Cell(workload, w["chips"], config, traffic, e2e, per_layer,
                readers)
