"""The benchmark's generators: equal bytes for equal seeds, other bytes for
other seeds, whole records cut within the size asked for."""
from __future__ import annotations

import numpy as np
import pytest
from yardstick import check, gen

SPECS = [
    {"generator": "fast", "bytes": 200_000},
    {"generator": "fast", "bytes": 200_000, "titles": "fixed"},
    {"generator": "realistic", "bytes": 200_000},
    {"generator": "realistic", "bytes": 200_000, "platform": "novaseq"},
    {"generator": "umi", "bytes": 200_000},
    {"generator": "realistic", "bytes": 200_000, "iupac_share": 0.01},
]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: "-".join(
    str(v) for k, v in s.items() if k != "bytes"))
def test_seeded(spec):
    a = gen.make_input(spec, 2**31 + 11)
    assert a == gen.make_input(spec, 2**31 + 11)
    assert a != gen.make_input(spec, 2**31 + 12)
    assert spec["bytes"] - 1000 < len(a) <= spec["bytes"]
    assert a.endswith(b"\n")
    lines = a.split(b"\n")[:-1]
    assert len(lines) % 4 == 0
    assert all(t.startswith(b"@") for t in lines[0::4])
    assert all(p == b"+" for p in lines[2::4])
    assert all(len(s) == len(q) == 100 for s, q in zip(lines[1::4],
                                                       lines[3::4]))
    assert min(min(q) for q in lines[3::4]) >= check.QUALITY_OFFSET


@pytest.mark.parametrize("seed", [0, -1, 2**64 + 5, 2**31 + 3])
def test_any_whole_seed(seed):
    assert 0 <= gen.data_seed(seed) < 2**63
    assert gen.make_input({"generator": "fast", "bytes": 5000}, seed)


def test_umi_in_every_name():
    data = gen.make_input({"generator": "umi", "bytes": 100_000}, 5)
    titles = data.split(b"\n")[0::4][:-1]
    for t in titles:
        name = t.split(b" ")[0]
        assert name.rsplit(b"_", 1)[1].strip(b"ACGT") == b""
        assert len(name.rsplit(b"_", 1)[1]) == 8


def test_iupac_codes_at_high_quality():
    spec = {"generator": "fast", "bytes": 400_000, "iupac_share": 0.01}
    data = np.frombuffer(gen.make_input(spec, 9), np.uint8)
    lines = bytes(data).split(b"\n")[:-1]
    seq = np.frombuffer(b"".join(lines[1::4]), np.uint8)
    qual = np.frombuffer(b"".join(lines[3::4]), np.uint8)
    iupac = np.isin(seq, np.frombuffer(b"RWSKMDVHBY", np.uint8))
    assert 0.005 < iupac.mean() < 0.015
    assert (qual[iupac] >= 33 + 20).all()


def test_unknown_generator():
    with pytest.raises(ValueError):
        gen.make_input({"generator": "nope", "bytes": 10}, 1)
