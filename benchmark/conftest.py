"""Test set-up for the benchmark's own tests (python -m pytest benchmark/).

The tests run the harness on the CPU at a tiny size (the program's plain
PyTorch path), from a copy of the benchmark's data files with tiny
configurations and mixes beside them; tests marked `cuda` need a card and
skip without one, deciding inside a fixture.
"""
from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
for p in (ROOT, BENCH_DIR):
    if p not in sys.path:
        sys.path.insert(0, p)

# tiny sizes: blocks of 256 KB, three blocks a round trip
TINY_BLOCK = 1 << 18
TINY_BYTES = 3 * TINY_BLOCK - 4096


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def make_tiny_root(dest: str) -> str:
    """A checkout root at dest whose BENCHMARK.json holds every cell of the
    benchmark and a tiny copy of each ("tiny-<cell>": 256 KB blocks, three
    blocks a round trip), each made of data files only.  Returns the
    benchmark directory under it."""
    bench = os.path.join(dest, "benchmark")
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "refdsrc", "yardstick", "test_*.py", "conftest.py"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    for c in list(b["configs"]):
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        cfg["params"]["fastq_block_size_bytes"] = TINY_BLOCK
        name = "tiny-" + c["name"]
        path = f"benchmark/configs/{name}.json"
        with open(os.path.join(dest, path), "w") as f:
            json.dump(cfg, f)
        b["configs"].append(dict(c, name=name, file=path))
    for w in list(b["workloads"]):
        with open(os.path.join(bench, "traffic", w["traffic"] + ".json")) \
                as f:
            tr = json.load(f)
        tr["data"]["bytes"] = TINY_BYTES
        traffic = "tiny-" + w["traffic"]
        with open(os.path.join(bench, "traffic", traffic + ".json"),
                  "w") as f:
            json.dump(tr, f)
        name = "tiny-" + w["name"]
        b["workloads"].append(dict(w, name=name, traffic=traffic,
                                   config="tiny-" + w["config"]))
        for m in b["end_to_end"] + b["per_layer"]:
            if w["name"] in m.get("workloads", ()):
                m["workloads"].append(name)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(b, f, indent=1)
    return bench


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    dest = str(tmp_path_factory.mktemp("bench"))
    return dest, make_tiny_root(dest)


def run_tiny(root, bench, cell: str, traced: bool = False, seed: int = 7,
             params=None, faults=None, device=None):
    """One run of a tiny cell (one operation, or one round trip), on the
    CPU unless a device is given; returns the result line."""
    import time

    import torch
    from yardstick import cell as C
    from yardstick import spec
    c = spec.load_cell(cell, root, bench)
    dev = device or torch.device("cpu")
    out = C.run_window(c, seed, 0.0, traced, dev, time.perf_counter(),
                       params=params, faults=faults)
    info = {"platform": dev.type, "kind": str(dev), "count": 1,
            "memory_peak_bytes": out.memory_peak}
    return C.result(c, seed, out, traced, info)
