"""The result line has exactly the contract's keys, the harness loads no
JAX, and the command refuses to run without a card."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
from conftest import BENCH_DIR, ROOT, run_tiny

import run as R

DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("cell", ["tiny-m0-semi-rt", "tiny-m1-generic-rt"])
def test_untraced_line(tiny_root, cell):
    from yardstick import spec
    res = run_tiny(*tiny_root, cell)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(res["device"]) == DEVICE_KEYS
    want = {m.name: m.unit for m in spec.load_cell(cell, *tiny_root)
            .end_to_end}
    assert {k: v["unit"] for k, v in res["metrics"].items()} == want
    assert all(set(v) == {"value", "limit"} for v in res["checks"].values())
    json.dumps(res)


def test_traced_line(tiny_root):
    res = run_tiny(*tiny_root, "tiny-m0-umi-rt", traced=True)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert set(res["device"]) == DEVICE_KEYS | {"busy_s", "window_s"}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in res["breakdown"].values())
    # on the CPU there is no device trace: only the span metrics read,
    # the benchmark's and the program's (its recorder is on when traced)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        per = json.load(f)["per_layer"]
    program = {m["name"] for m in per if m["name"].split(".")[0] in (
        "stage_ms_per_MiB", "syncs_per_MiB", "block0_share",
        "api_ms_per_MiB", "read_ahead")}
    assert len(program) == 20
    assert set(res["metrics"]) == {
        "codec_overlap.compress", "codec_ms_per_MiB.compress",
        "codec_overlap.decompress", "codec_ms_per_MiB.decompress"} | program


def test_forbidden_modules_by_whole_top_level_name():
    names = ["dsrc_tpu_torch", "dsrc_tpu_torch.api", "jax_utils", "flaxen",
             "dsrc_tpu", "dsrc_tpu.api", "jax", "jax.numpy", "jaxlib.xla",
             "flax.linen"]
    assert R.forbidden_modules(names) == sorted(
        ["dsrc_tpu", "dsrc_tpu.api", "jax", "jax.numpy", "jaxlib.xla",
         "flax.linen"])


def _python(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_harness_and_reference_load_no_jax():
    """Everything the benchmark imports leaves no JAX and no dsrc_tpu in
    sys.modules, and nothing of it loads the program on import."""
    code = f"""
import glob, os, sys, time, torch
sys.path[:0] = [{ROOT!r}, {BENCH_DIR!r}]
import run, control
from yardstick import cell, check, gen, hooks, record, spec, trace, work
from refdsrc.models import block
from refdsrc.io import archive
before = sorted(m for m in sys.modules if m.split('.')[0] == 'dsrc_tpu_torch')
for f in glob.glob(os.path.join({BENCH_DIR!r}, 'metrics', '*.py')):
    spec.load_reader({BENCH_DIR!r}, os.path.basename(f)[:-3])
print('LEAK', run.forbidden_modules(sys.modules))
print('PROGRAM', before)
"""
    p = _python(code)
    assert p.returncode == 0, p.stderr
    assert "LEAK []" in p.stdout
    assert "PROGRAM []" in p.stdout


def test_reference_imports_nothing_of_the_program():
    import re
    pat = re.compile(r"^\s*(from|import)\s+(dsrc_tpu|jax|flax)\b", re.M)
    for dirpath, _, files in os.walk(os.path.join(BENCH_DIR, "refdsrc")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    assert not pat.search(fh.read()), f


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "m0-semi-rt", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


@pytest.mark.cuda
def test_card_traced_run(card, tiny_root):
    """On a card: a traced tiny run reads every per-layer metric of its
    cell, the rooflines at most 100%, and the device busy."""
    res = run_tiny(*tiny_root, "tiny-m0-umi-rt", traced=True, device=card)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    for k in ("k1_roofline.compress", "k2_roofline.decompress",
              "k3_roofline.decompress"):
        assert 0 < m[k]["value"] <= 100
    assert res["device"]["busy_s"] > 0
