"""The -m1 preset (-d2 -q2) of the port on reads whose base calls carry
IUPAC ambiguity codes, against dsrc_tpu and the benchmark's plain
reference decoder (benchmark/refdsrc) on the CPU.

The input is the benchmark's `m1-iupac-rt` traffic at a small size: the
realistic generator (hiseq or novaseq qualities) with about 1% of the
bases at quality >= 20 replaced by one of the codes RWSKMDVHBY, cut to
three 256 KB blocks.  A code at quality 7 or above stays in the DNA, so
each block's DNA holds more than 8 distinct symbols and takes scheme A19
(static order-0 rANS; its decode is K4, here its plain version).  For
each input, DsrcModule(device="cpu") with two workers:

- puts every block's DNA in A19 (CompressionInfo.schemes);
- counts every base of the DNA stream (the bases less the codes folded
  into the quality) under dna.A19 in the recorder (utils/trace.py), on
  compress and on decompress, and no base under another scheme;
- round-trips byte for byte;
- writes dsrc_tpu's archive bytes;
- writes blocks that benchmark/refdsrc decodes to the input's records.

On reads with no code, no block takes A19 and nothing counts under
dna.A19.  CLI -v prints the dna.A19 count, on compress and on decompress.
"""
import io
import os
import sys

import numpy as np
import pytest

from dsrc_tpu import api as JAPI
from dsrc_tpu.config import InputParameters as JaxParams
from dsrc_tpu_torch.api import DsrcModule
from dsrc_tpu_torch.config import InputParameters
from dsrc_tpu_torch.utils import trace
from torch_jax_codec import jax_codec  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)
from yardstick import check, gen  # noqa: E402

BLOCK = 1 << 18
KW = dict(dna_compression_level=2, quality_compression_level=2,
          fastq_block_size_bytes=BLOCK, num_workers=2)
INPUTS = [(seed, platform) for seed in (11, 4_000_000_007)
          for platform in ("hiseq", "novaseq")]
CHECKS = ("a19_every_block", "dna_counts", "round_trip", "equals_jax",
          "reference_decodes")


def _data(seed: int, platform: str, share: float) -> bytes:
    return gen.make_input({"generator": "realistic", "platform": platform,
                           "read_len": 100, "bytes": 3 * BLOCK - 4096,
                           "iupac_share": share}, seed)


def dna_stream_bases(data: bytes) -> int:
    """The bases the DNA stream codes: every base but those folded into
    the quality stream (not A, C, G or T, at a quality below 7)."""
    lines = data.split(b"\n")
    seq = np.frombuffer(b"".join(lines[1::4]), np.uint8)
    qual = np.frombuffer(b"".join(lines[3::4]), np.uint8) - 33
    folded = ~np.isin(seq, list(b"ACGT")) & (qual < 7)
    return len(seq) - int(np.count_nonzero(folded))


def _dna_counts(fn):
    """fn's result, and the recorder's dna.* counts around it."""
    trace.start(keep=False)
    try:
        res = fn()
    finally:
        rec = trace.stop()
    return res, {k: t.count for k, t in rec.by_name().items()
                 if k.startswith("dna.")}


def _run(data: bytes) -> dict:
    mod = DsrcModule(InputParameters(**KW), device="cpu")
    arch, out = io.BytesIO(), io.BytesIO()
    info, enc = _dna_counts(lambda: mod.compress(io.BytesIO(data), arch))
    _, dec = _dna_counts(lambda: mod.decompress(
        io.BytesIO(arch.getvalue()), out))
    return {"data": data, "archive": arch.getvalue(), "out": out.getvalue(),
            "schemes": [d for d, _ in info.schemes], "enc": enc, "dec": dec,
            "bases": dna_stream_bases(data)}


@pytest.fixture(scope="module")
def runs():
    """The port's round trip of each input, made once."""
    cache = {}

    def get(seed, platform):
        if (seed, platform) not in cache:
            cache[seed, platform] = _run(_data(seed, platform, 0.01))
        return cache[seed, platform]
    return get


@pytest.mark.parametrize("check_name", CHECKS)
@pytest.mark.parametrize("seed,platform", INPUTS)
def test_m1_iupac_blocks(runs, jax_codec, seed, platform, check_name):
    r = runs(seed, platform)
    data = r["data"]
    if check_name == "a19_every_block":
        assert r["schemes"] == ["A19"] * 3
    elif check_name == "dna_counts":
        assert r["enc"] == r["dec"] == {"dna.A19": r["bases"]}
    elif check_name == "round_trip":
        assert r["out"] == data
    elif check_name == "equals_jax":
        jarch = io.BytesIO()
        with jax_codec():
            JAPI.DsrcModule(JaxParams(**KW)).compress(io.BytesIO(data),
                                                       jarch)
        assert r["archive"] == jarch.getvalue()
    else:
        offsets = check.record_offsets(data)
        wrong = check.reference_block_bytes_wrong(r["archive"], data,
                                                  offsets, [0, 1, 2])
        assert wrong == {0: 0, 1: 0, 2: 0}
        assert check.container_faults(r["archive"], KW,
                                      len(offsets) - 1) == []


def test_reads_without_codes_count_no_a19():
    data = _data(11, "hiseq", 0.0)
    assert set(b"".join(data.split(b"\n")[1::4])) <= set(b"ACGTN")
    r = _run(data)
    assert r["out"] == data
    assert "A19" not in r["schemes"]
    assert "dna.A19" not in r["enc"] and "dna.A19" not in r["dec"]
    assert r["enc"] == r["dec"]
    assert sum(r["enc"].values()) == r["bases"]
    assert all(s in ("CTX4", "CTX4P") for s in r["schemes"])


@pytest.mark.parametrize("mode", ["c", "d"])
def test_cli_verbose_prints_the_dna_count(tmp_path, capsys, mode):
    """CLI -v at -d2 -q2 prints dna.A19 with the DNA stream's bases, and
    no other scheme's count."""
    from dsrc_tpu_torch import cli
    data = _data(11, "hiseq", 0.01)
    src, arc = tmp_path / "in.fastq", tmp_path / "out.xfqz"
    src.write_bytes(data)
    opts = ["-d2", "-q2", "-b1"]
    assert cli.main(["c", *opts, str(src), str(arc)], device="cpu") == 0
    capsys.readouterr()
    argv = ["c", "-v", *opts, str(src), str(arc)] if mode == "c" else \
        ["d", "-v", str(arc), str(tmp_path / "back.fastq")]
    assert cli.main(argv, device="cpu") == 0
    rows = [line.split() for line in capsys.readouterr().err.splitlines()]
    counts = {r[0]: int(r[2]) for r in rows if r and r[0].startswith("dna.")}
    assert counts == {"dna.A19": dna_stream_bases(data)}
    assert not trace.active()
