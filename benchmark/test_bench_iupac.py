"""The m1-iupac-rt cell: K4's work count worked by hand, its configuration
beside dsrc-m1's, and its tiny copy run on the CPU (sound, control, and a
traced run that records K4's calls)."""
from __future__ import annotations

import json
import os
import time

import pytest
import torch
from conftest import ROOT, run_tiny
from yardstick import spec, work

K4 = spec.load_reader(os.path.join(ROOT, "benchmark"),
                      "k4_roofline.decompress")[0]


def _rows(*lanes):
    """payload [L, W] int32 whose row l holds the u16 words lanes[l]
    (padded with zero words), as the kernels read it."""
    w = max(len(r) for r in lanes) + 3
    w += w % 2
    u16 = torch.zeros(len(lanes), w, dtype=torch.int16)
    for i, r in enumerate(lanes):
        u16[i, :len(r)] = torch.tensor(r, dtype=torch.int16)
    return u16.view(torch.int32)


@pytest.mark.parametrize("table", ["tensor", "list"])
def test_k4_by_hand(table):
    # L = 2 lanes of t = 4 steps; lane 0 holds 3 words from word 0, lane 1
    # words 2..3 of its row (start word 2); n = 6 symbols
    payload = _rows([7, 0, 9], [0, 0, 4, 1])
    wptr = torch.tensor([0, 2], dtype=torch.int32)
    fields = [862] * 19
    freqs = torch.tensor(fields) if table == "tensor" else fields
    states = torch.zeros(2, dtype=torch.int32)
    nbytes, nops = work.totals(K4.k4_count(
        (payload, states, wptr, freqs, 6, 4), {}, None))
    # 5 u16 words 10, states and start words 16, 19 fields of 2 bytes 38,
    # 6 symbols of a byte; 7 operations a symbol, none for the slot table
    assert (nbytes, nops) == (10 + 16 + 38 + 6, 6 * 7)
    # the symbols written stop at the lanes' L * t
    assert work.totals(K4.k4_count(
        (), dict(payload=payload, states=states, wptr=wptr, freqs=freqs,
                 n=100, t=4), None)) == (10 + 16 + 38 + 8, 8 * 7)


def test_k4_kernel_names_and_site():
    assert K4.KERNEL.name == "k4"
    assert K4.KERNEL.sites == (("dsrc_tpu_torch.models.dna", "a19_decode"),)
    assert K4.KERNEL.matches("void (anonymous namespace)::a19_decode_kernel"
                             "<1>(int const*, int)")
    assert not K4.KERNEL.matches("rans_decode_kernel<2>")


def test_config_is_dsrc_m1_with_iupac_reads():
    """The same keys, preset and guarantees as dsrc-m1; the cell's traffic
    is generic-rt-192m's with the IUPAC share."""
    def load(path):
        with open(os.path.join(ROOT, path)) as f:
            return json.load(f)
    m1 = load("benchmark/configs/dsrc-m1.json")
    iupac = load("benchmark/configs/dsrc-m1-iupac.json")
    assert set(iupac) == set(m1)
    assert iupac["params"] == m1["params"]
    assert iupac["guarantees"] == m1["guarantees"]
    assert set(iupac["reduced"]) == set(m1["reduced"]) == {"file_bytes"}
    rt = load("benchmark/traffic/generic-rt-192m.json")
    tr = load("benchmark/traffic/iupac-rt-192m.json")
    assert tr["data"] == dict(rt["data"], iupac_share=0.01)
    assert tr["loop"] == rt["loop"] == "round_trip"
    assert tr["reference_blocks"] == 1


def test_sound_and_control(tiny_root):
    """The sound program is correct, with every count 0; the control (the
    program's lossy quality binning) is not, by every number that can see
    it."""
    root, bench = tiny_root
    res = run_tiny(root, bench, "tiny-m1-iupac-rt", seed=5_000_000_011)
    assert res["correct"], res["checks"]
    assert all(v["value"] == 0 for v in res["checks"].values())
    params = dict(spec.load_cell("tiny-m1-iupac-rt", root, bench)
                  .config["params"], lossy_quality=True)
    res = run_tiny(root, bench, "tiny-m1-iupac-rt", params=params)
    assert res["correct"] is False
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert checks["fastq_bytes_wrong"] > 0
    assert checks["container_faults"] > 0
    assert checks["reference_bytes_wrong"] > 0


def test_traced_run_records_k4_calls(tiny_root):
    """A traced CPU run records one K4 call a block, in the decompress
    operations only, beside K1's (A19's encode) and K3's (the quality)."""
    from yardstick import cell as C
    c = spec.load_cell("tiny-m1-iupac-rt", *tiny_root)
    assert "k4_roofline.decompress" in [m.name for m in c.per_layer]
    out = C.run_window(c, 3, 0.0, True, torch.device("cpu"),
                       time.perf_counter())
    kinds = [(out.run.ops[k.op].kind, k.kernel) for k in out.run.calls]
    assert kinds.count(("decompress", "k4")) == 3
    assert ("compress", "k4") not in kinds
    assert ("compress", "k1") in kinds and ("decompress", "k3") in kinds
    assert all(k.nbytes > 0 and k.nops > 0 for k in out.run.calls
               if k.kernel == "k4")
    # the patch is gone once the window has closed
    from dsrc_tpu_torch.models import dna
    from dsrc_tpu_torch.ops import a19_kernels
    assert dna.a19_decode is a19_kernels.a19_decode
