"""Find a cell's configuration, traffic mix and metric readers by name.

BENCHMARK.json (at the checkout's root) names them; each lives in a file of
its own under the benchmark's directory, so a later change adds a
configuration, a mix or a metric by adding files and entries:

  configs/<config>.json   the configuration's "file" in BENCHMARK.json:
                          "params" (InputParameters keywords), the
                          guarantees it states, its source and its cuts
  traffic/<traffic>.json  the mix: the loop ("round_trip") and its
                          parameters, and the "data" that
                          yardstick.gen.make_input generates
  metrics/<metric>.py     a per-layer metric's reader; a metric named
                          <family>.<part> may share metrics/<family>.py,
                          which is then called with the part
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    layer: Optional[str] = None      # per-layer metrics only
    moves: Optional[str] = None      # per-layer metrics only
    reader: Optional[Callable] = None
    module: object = None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _for_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_reader(bench_dir: str, name: str):
    """(module, read) of the per-layer metric `name`: metrics/<name>.py's
    read(run), or metrics/<family>.py's read(run, part) for a name
    <family>.<part>."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    part = None
    if not os.path.exists(path) and "." in name:
        family, part = name.split(".", 1)
        path = os.path.join(bench_dir, "metrics", family + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no reader for per-layer metric {name!r}: "
                                f"metrics/{name}.py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + os.path.basename(path)[:-3].replace(".", "_")
        .replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if part is None:
        return mod, mod.read
    return mod, (lambda run: mod.read(run, part))


def load_cell(name: str, root: str = ROOT,
              bench_dir: str = BENCH_DIR) -> Cell:
    """The cell `name` of root/BENCHMARK.json, with its files read."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells: Dict[str, dict] = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (one of "
                       f"{', '.join(sorted(cells))})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic",
                           w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [Metric(m["name"], m["unit"], m["better"], m["source"])
           for m in bench["end_to_end"] if _for_cell(m, name)]
    per = []
    for m in bench["per_layer"]:
        if not _for_cell(m, name):
            continue
        mod, read = load_reader(bench_dir, m["name"])
        per.append(Metric(m["name"], m["unit"], m["better"], m["source"],
                          m["layer"], m["moves"], read, mod))
    return Cell(name, int(w["chips"]), w["config"], config, w["traffic"],
                traffic, e2e, per)
