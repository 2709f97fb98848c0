"""SEMI title mode 0 of the port (fixed read length, titles with a
free-text field: quality through K1/K2, DNA packed, titles through the tag
coder, K1 to encode and K3 to decode) against dsrc_tpu on the CPU.

- Mode-0 blobs equal the reference's, with direct and with delta quality.
- Archives cross-decode both ways; parse_semi_block of a reference mode-0
  blob gives the input's titles.
- A file whose blocks mix mode 0 and mode 2 gives the reference's archive
  at num_workers=1.
- The semi hints (lane bucket, plane counts) do not depend on worker
  scheduling: a file whose block 0 is mode 0 gives the reference's archive
  at 1 and 4 workers, also when a slow block 1 lets later blocks reach the
  plane-count hint first.

The reference compresses under tests/torch_jax_codec.py's jax_codec.
"""
import io
import threading
import time

import numpy as np
import pytest

from dsrc_tpu import api as JAPI
from dsrc_tpu.config import InputParameters as JaxParams
from dsrc_tpu.models import block as JB
from dsrc_tpu_torch import api as TAPI
from dsrc_tpu_torch.api import DsrcModule
from dsrc_tpu_torch.config import InputParameters
from dsrc_tpu_torch.io.archive import ArchiveReader
from dsrc_tpu_torch.models import block as TB
from dsrc_tpu_torch.models import tag as TTAG
from dsrc_tpu_torch.utils.bitio import BitReader
from torch_jax_codec import jax_codec  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

BLOCK = 1 << 17


def _mode0_file(qual: str, seed: int) -> bytes:
    """The reference's own mode-0 titles (tests/test_semi_tok.py: a text
    field in each) on 600 reads of 40 bases.  qual "direct": i.i.d.
    qualities (direct symbols cost less); "delta": one quality a read (the
    horizontal delta costs less)."""
    rng = np.random.default_rng(seed)
    pick = np.frombuffer(b"5:?DIKMN", np.uint8)
    recs = []
    for i in range(600):
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 40)].copy()
        seq[rng.random(40) < 0.01] = ord("N")
        q = pick[rng.integers(0, 8, 40)] if qual == "direct" else \
            np.full(40, pick[rng.integers(0, 8)])
        recs.append(b"@x%sq.%d z%dw\n%s\n+\n%s\n" % (
            b"ab"[i % 2:i % 2 + 1], i, i % 3, seq.tobytes(), q.tobytes()))
    return b"".join(recs)


def _semi_modes(blob: bytes):
    """(qual_mode, title_mode) of a SEMI blob."""
    r = BitReader(blob)
    assert r.get_byte() == TB.BLOCK_SEMI
    _num_rec, rpad, _read_len = (r.get_varint() for _ in range(3))
    TB._get_wire(r, rpad)
    return r.get_byte(), r.get_byte()


def _codecs(block):
    settings = InputParameters().to_settings()
    jshape = JB.BlockShape.for_block_size(BLOCK)
    tshape = TB.BlockShape.for_block_size(BLOCK)
    return (JB.BlockCodec(jshape, settings,
                          JAPI.analyze_first_block(block, jshape)),
            TB.BlockCodec(tshape, settings,
                          TAPI.analyze_first_block(block, tshape,
                                                   device="cpu"),
                          device="cpu"))


@pytest.mark.parametrize("qual,qual_mode", [("direct", 0), ("delta", 1)])
def test_mode0_blobs_equal_jax(jax_codec, qual, qual_mode):
    block = np.frombuffer(_mode0_file(qual, 5), np.uint8)
    jcodec, tcodec = _codecs(block)
    with jax_codec():
        jblob, jinfo = jcodec.compress(block)
    tblob, tinfo = tcodec.compress(block)
    assert _semi_modes(tblob) == (qual_mode, 0)
    assert tblob == jblob
    assert (tinfo.raw, tinfo.comp) == (jinfo.raw, jinfo.comp)
    np.testing.assert_array_equal(tcodec.decompress(jblob), block)


def test_mode0_archives_cross_decode_both_ways(jax_codec):
    data = _mode0_file("direct", 5)
    kw = dict(fastq_block_size_bytes=BLOCK, num_workers=1)
    jmod = JAPI.DsrcModule(JaxParams(**kw))
    jarch = io.BytesIO()
    with jax_codec():
        jmod.compress(io.BytesIO(data), jarch)
    tmod = DsrcModule(InputParameters(**kw), device="cpu")
    tarch = io.BytesIO()
    tmod.compress(io.BytesIO(data), tarch)
    assert _semi_modes(ArchiveReader(io.BytesIO(tarch.getvalue()))
                       .read_block(0)) == (0, 0)
    assert tarch.getvalue() == jarch.getvalue()
    out = io.BytesIO()
    tmod.decompress(io.BytesIO(jarch.getvalue()), out)
    assert out.getvalue() == data
    out = io.BytesIO()
    jmod.decompress(io.BytesIO(tarch.getvalue()), out)
    assert out.getvalue() == data


def test_parse_semi_block_gives_the_titles_of_a_reference_blob(jax_codec):
    data = _mode0_file("delta", 6)
    block = np.frombuffer(data, np.uint8)
    jcodec, _ = _codecs(block)
    with jax_codec():
        jblob, _ = jcodec.compress(block)
    r = BitReader(jblob)
    r.get_byte()
    d = TB.parse_semi_block(r, TB.BlockShape.for_block_size(BLOCK).cap,
                            "cpu")
    titles = [t[1:] for t in data.split(b"\n")[0::4] if t]
    assert d["mode"] == 0 and d["num_rec"] == len(titles)
    assert d["titles_np"].tobytes() == b"".join(titles)
    np.testing.assert_array_equal(d["title_len_np"],
                                  [len(t) for t in titles])
    assert "title" not in d and d["read_len"] == 40


# --------------------------------------------------------------------------
# files of several blocks
# --------------------------------------------------------------------------

def _block_of(regime: str, first: int, nbytes: int, rng) -> bytes:
    """Records of one regime filling exactly nbytes (the chunker then cuts
    the file at this block's end).  Titles "<regime>.<i> <v>": regime
    "text" has a letter word for v (title mode 0); "p1" and "p3" have
    numeric v whose record-to-record deltas need 1 and 3 byte planes.
    Each v takes one of two digit counts, so the titles vary in length (no
    UNIFORM block) and the block hits nbytes exactly."""
    digits, step, span = {"text": (2, 0, 0), "p1": (2, 0, 0),
                          "p3": (6, 400_000, 800_000)}[regime]
    seq_q = b"\nACGTACGTACGTNACGTACG\n+\nIIIIHHHHGGGGFFFF5555\n"

    def title(i, long):
        if regime == "text":
            v = (97 + rng.integers(0, 26, digits + long)).astype(
                np.uint8).tobytes()
        elif regime == "p1":
            v = b"%d" % (99 + long)                       # 99 or 100
        else:
            v = b"%d" % (10 ** (digits - 1 + long) + i * step % span)
        return b"@%s.%d %s" % (regime.encode(), i, v)

    base = [len(title(first + j, 0)) + len(seq_q) for j in range(1000)]
    k = int(np.searchsorted(np.cumsum(base), nbytes, side="right"))
    while sum(base[:k]) + k < nbytes:          # every record long: too short
        k += 1
    k_long = nbytes - sum(base[:k])
    assert 0 <= k_long <= k
    out = b"".join(title(first + j, int(j < k_long)) + seq_q
                   for j in range(k))
    assert len(out) == nbytes
    return out


def _regime_file(regimes, block: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    parts, first = [], 10_000
    for regime in regimes:
        parts.append(_block_of(regime, first, block, rng))
        first += parts[-1].count(b"\n") // 4
    return b"".join(parts)


def _archive_blocks(arch: bytes):
    rd = ArchiveReader(io.BytesIO(arch))
    return [rd.read_block(i) for i in range(rd.num_blocks)]


HINT_BLOCK = 8192


@pytest.fixture(scope="module")
def hint_file(jax_codec):
    """(data, the reference's archive at num_workers=1) of a file whose
    block 0 has a text field (title mode 0, so it seeds the lane bucket but
    not the plane-count hint) and whose blocks 1-3 are mode 2 with 1, 3 and
    3 byte planes in their second numeric field."""
    data = _regime_file(["text", "p1", "p3", "p3"], HINT_BLOCK, 8)
    jarch = io.BytesIO()
    with jax_codec():
        JAPI.DsrcModule(JaxParams(fastq_block_size_bytes=HINT_BLOCK,
                                  num_workers=1)).compress(
            io.BytesIO(data), jarch)
    return data, jarch.getvalue()


def test_mixed_mode0_and_mode2_file_equals_jax(hint_file):
    data, jarch = hint_file
    blobs = _archive_blocks(jarch)
    assert [_semi_modes(b)[1] for b in blobs] == [0, 2, 2, 2]
    pcs = [TB.parse_semi_block(BitReader(b[1:]), 1 << 15, "cpu")["pcs"]
           for b in blobs[1:]]
    assert pcs == [(1, 1), (1, 3), (1, 3)]      # block 1 seeds, then frozen
    tmod = DsrcModule(InputParameters(fastq_block_size_bytes=HINT_BLOCK,
                                      num_workers=1), device="cpu")
    tarch, out = io.BytesIO(), io.BytesIO()
    tmod.compress(io.BytesIO(data), tarch)
    assert tarch.getvalue() == jarch
    tmod.decompress(io.BytesIO(jarch), out)
    assert out.getvalue() == data


def test_semi_hints_do_not_depend_on_worker_scheduling(hint_file,
                                                       monkeypatch):
    """In a one-worker run block 1 seeds the plane-count hint.  With 4
    workers, block 1's title analysis is held back here, so that blocks 2
    and 3 reach the hint first: they must wait for block 1, or the archive
    changes (their planes would seed it)."""
    data, jarch = hint_file
    real = TTAG.analyze_value_fields

    def slow_block_1(stream, lengths):
        if bytes(stream[:3]) == b"p1." and \
                threading.current_thread() is not threading.main_thread():
            time.sleep(1.0)
        return real(stream, lengths)

    monkeypatch.setattr(TTAG, "analyze_value_fields", slow_block_1)
    for workers in (1, 4):
        tarch = io.BytesIO()
        DsrcModule(InputParameters(fastq_block_size_bytes=HINT_BLOCK,
                                   num_workers=workers),
                   device="cpu").compress(io.BytesIO(data), tarch)
        assert tarch.getvalue() == jarch, workers
