"""BENCHMARK.json against the benchmark's contract, and a cell added by data
files alone."""
from __future__ import annotations

import json
import os
import re

import pytest
from conftest import ROOT, run_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys(bench):
    assert list(bench) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_workloads(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
        assert _line(w["why"])
        assert os.path.exists(os.path.join(ROOT, "benchmark", "traffic",
                                           w["traffic"] + ".json"))


def _reported(metrics, cell):
    return {m["name"] for m in metrics
            if "workloads" not in m or cell in m["workloads"]}


def test_metrics(bench):
    e2e, per = bench["end_to_end"], bench["per_layer"]
    names = [m["name"] for m in e2e + per]
    assert len(set(names)) == len(names)
    assert 1 <= len(e2e) <= 16 and 1 <= len(per) <= 128
    assert "setup_s" in names
    cells = {w["name"] for w in bench["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in per:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in {x["name"] for x in e2e}
        for cell in m["workloads"]:
            assert cell in cells
            assert m["moves"] in _reported(e2e, cell)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in e2e + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for cell in cells:
        rep = _reported(e2e, cell)
        assert "setup_s" in rep and len(rep) >= 2
        assert _reported(per, cell)


def test_every_metric_has_a_reader(bench):
    from yardstick import spec
    for m in bench["per_layer"]:
        mod, read = spec.load_reader(os.path.join(ROOT, "benchmark"),
                                     m["name"])
        assert callable(read)


def test_cell_from_data_files_only(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files, with entries in BENCHMARK.json, run with no file of the
    harness edited."""
    from conftest import TINY_BLOCK, make_tiny_root
    root = str(tmp_path)
    bench = make_tiny_root(root)
    with open(os.path.join(bench, "configs", "tiny-dsrc-m0.json")) as f:
        cfg = json.load(f)
    cfg["params"].update(dna_compression_level=1,
                         quality_compression_level=1)
    with open(os.path.join(bench, "configs", "tiny-d1q1.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "tiny-fixed-rt.json"),
              "w") as f:
        json.dump({"why": "fixed-width titles", "loop": "round_trip",
                   "data": {"generator": "fast", "titles": "fixed",
                            "bytes": 2 * TINY_BLOCK - 4096},
                   "reference_blocks": 1}, f)
    with open(os.path.join(bench, "metrics", "codec_calls.py"), "w") as f:
        f.write("def read(run, part):\n"
                "    return sum(1 for s in run.spans if s.kind == part)\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append({"name": "tiny-d1q1", "source": "a test",
                         "file": "benchmark/configs/tiny-d1q1.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "tiny-d1q1-fixed",
                           "config": "tiny-d1q1", "traffic": "tiny-fixed-rt",
                           "chips": 1, "why": "a test"})
    for m in b["end_to_end"]:
        if "compress_MiBps" == m["name"]:
            m["workloads"].append("tiny-d1q1-fixed")
    b["per_layer"].append({"name": "codec_calls.compress", "unit": "1",
                           "better": "lower", "source": "program_span",
                           "layer": "a test", "moves": "compress_MiBps",
                           "workloads": ["tiny-d1q1-fixed"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    res = run_tiny(root, bench, "tiny-d1q1-fixed", traced=True)
    assert res["correct"], res["checks"]
    assert res["metrics"]["codec_calls.compress"]["value"] == 2
    res = run_tiny(root, bench, "tiny-d1q1-fixed")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"compress_MiBps", "setup_s"}
