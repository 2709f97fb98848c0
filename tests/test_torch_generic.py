"""The GENERIC block class of the port (dsrc_tpu_torch/models/block.py and
the dna / quality / tag / transform modules under it) against dsrc_tpu on
the CPU, where K1, K2 and K3 run their plain versions.

- The golden GENERIC and lossy archives decode byte-exactly through the
  port, and their inputs compress to the golden bytes.
- For each DNA scheme (EMPTY, RAW, PACK2, CTX4, CTX8, CTX4P, CTX8P, A19) and
  each quality scheme (CONST, POS, TRUNC, RLE, CTX) a block built here
  takes that scheme in both packages, the blobs are equal, and the port
  decodes the reference's blob.
- Archives are byte-equal at further settings, and the port decodes the
  reference's.  Equal bytes make "the reference decodes the port's
  archive" the reference decoding its own; the reference's decode of the
  negative-shift quality contexts is held against K3's plain version in
  tests/test_torch_ctx.py.

The reference's encoders are run with their rANS wavefront
(ops/rans.py:rans_encode_from_freqs) split off and jitted once per shape
(tests/torch_jax_codec.py): the same functions composed the same way,
with fewer compiles.  Blocks are one 1 << 17-byte BlockShape throughout.
"""
import io
import os

import numpy as np
import pytest

from dsrc_tpu import api as JAPI
from dsrc_tpu.config import InputParameters as JaxParams
from dsrc_tpu.models import block as JB
from dsrc_tpu_torch import api as TAPI
from dsrc_tpu_torch.api import DsrcModule
from dsrc_tpu_torch.config import DsrcException, InputParameters
from dsrc_tpu_torch.models import block as TB
from torch_jax_codec import jax_codec  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
BLOCK = 1 << 17


def _read(name):
    return open(os.path.join(DATA, name), "rb").read()


# --------------------------------------------------------------------------
# golden archives
# --------------------------------------------------------------------------

GOLDEN = [("golden_generic", dict(dna_compression_level=2,
                                  quality_compression_level=2)),
          ("golden_lossy", dict(lossy_quality=True,
                                quality_compression_level=1))]


@pytest.mark.parametrize("name,kw", GOLDEN)
def test_golden_generic_archives_both_ways(name, kw):
    fq, xz = _read(name + ".fastq"), _read(name + ".xfqz")
    out = io.BytesIO()
    DsrcModule(device="cpu").decompress(io.BytesIO(xz), out)
    assert out.getvalue() == fq
    arch = io.BytesIO()
    DsrcModule(InputParameters(fastq_block_size_bytes=BLOCK, **kw),
               device="cpu").compress(io.BytesIO(fq), arch)
    assert arch.getvalue() == xz


def _codecs(block, **kw):
    params = InputParameters(fastq_block_size_bytes=BLOCK, **kw)
    settings = params.to_settings()
    jshape = JB.BlockShape.for_block_size(BLOCK)
    tshape = TB.BlockShape.for_block_size(BLOCK)
    jds = JAPI.analyze_first_block(block, jshape)
    tds = TAPI.analyze_first_block(block, tshape, device="cpu")
    assert (jds.quality_offset, jds.plus_repetition) == \
        (tds.quality_offset, tds.plus_repetition)
    return (JB.BlockCodec(jshape, settings, jds),
            TB.BlockCodec(tshape, settings, tds, device="cpu"))


def _fastq(seqs, quals, prefix=b"r"):
    return b"".join(b"@%s.%d\n%s\n+\n%s\n" % (prefix, i, s, q)
                    for i, (s, q) in enumerate(zip(seqs, quals)))


def _pick(rng, alphabet: bytes, n):
    return np.frombuffer(alphabet, np.uint8)[
        rng.integers(0, len(alphabet), n)].tobytes()


def _reads(rng, count, lo, hi, bases, quals):
    lens = rng.integers(lo, hi + 1, count)
    return ([_pick(rng, bases, k) for k in lens],
            [_pick(rng, quals, k) for k in lens])


def _case(name):
    """(block bytes, settings kw, expected (DNA, quality) schemes) of one
    block built to take the named schemes.  Streams stay under 4,096
    symbols (one lane geometry, T = 512 x L = 8) but for the base-pair
    schemes, which need 65,536 bases."""
    rng = np.random.default_rng(sum(name.encode()))
    if name == "pack2_pos":           # variable length, ACGT, iid quality
        s, q = _reads(rng, 60, 40, 90, b"ACGT", b"5:?DIKMN")
        return _fastq(s, q), dict(), ("PACK2", "POS")
    if name == "ctx4_ctx":
        s, q = _reads(rng, 55, 70, 70, b"ACGT", b"5:?DIKMN")
        return _fastq(s, q), dict(dna_compression_level=1,
                                  quality_compression_level=1), \
            ("CTX4", "CTX")
    if name == "ctx8_trunc":          # 7 unfolded symbols, '#' tails
        seqs, quals = [], []
        for _ in range(55):
            k, tail = 70, int(rng.integers(5, 30))
            seqs.append(_pick(rng, b"ACGTNRW", k - tail)
                        + _pick(rng, b"ACGT", tail))
            quals.append(_pick(rng, b"(5?I", k - tail) + b"#" * tail)
        return _fastq(seqs, quals), dict(dna_compression_level=1), \
            ("CTX8", "TRUNC")
    if name == "a19_rle":             # 19 symbols, quality in long runs
        seqs, quals = [], []
        for _ in range(55):
            seqs.append(_pick(rng, b"ACGTNRWSKMDVHBYXU.-", 70))
            runs = b"".join(_pick(rng, b"5?IK", 1) * int(rng.integers(4, 12))
                            for _ in range(20))
            quals.append(runs[:70])
        return _fastq(seqs, quals), dict(dna_compression_level=1), \
            ("A19", "RLE")
    if name == "ctx4p_const":         # one 70,000-base read: pairs
        return _fastq([_pick(rng, b"ACGT", 70_000)], [b"I" * 70_000]), \
            dict(dna_compression_level=2), ("CTX4P", "CONST")
    if name == "ctx8p_const":
        return _fastq([_pick(rng, b"ACGTNR", 70_000)], [b"5" * 70_000]), \
            dict(dna_compression_level=2), ("CTX8P", "CONST")
    if name == "raw":                 # a symbol outside the alphabet
        s, q = _reads(rng, 55, 70, 70, b"ACGT", b"5:?DIKMN")
        s[7] = s[7][:10] + b"Z" + s[7][11:]
        return _fastq(s, q), dict(dna_compression_level=1), ("RAW", "POS")
    assert name == "empty"            # every base folds into its quality
    s, q = _reads(rng, 55, 60, 60, b"N", b"!")
    return _fastq(s, q), dict(dna_compression_level=1), ("EMPTY", "CONST")


CASES = ["pack2_pos", "ctx4_ctx", "ctx8_trunc", "a19_rle", "ctx4p_const",
         "ctx8p_const", "raw", "empty"]


@pytest.mark.parametrize("name", CASES)
def test_block_blobs_equal_jax_for_every_scheme(jax_codec, name):
    data, kw, schemes = _case(name)
    block = np.frombuffer(data, np.uint8)
    jcodec, tcodec = _codecs(block, **kw)
    with jax_codec():
        jblob, jinfo = jcodec.compress(block)
    tblob, tinfo = tcodec.compress(block)
    assert tblob[0] == TB.BLOCK_GENERIC
    assert tinfo.schemes == [schemes]
    assert tblob == jblob
    assert (tinfo.raw, tinfo.comp) == (jinfo.raw, jinfo.comp)
    got = tcodec.decompress(jblob)
    if name == "raw":
        # the reference writes RAW symbols verbatim and decodes a symbol
        # outside the alphabet as byte 0
        data = data.replace(b"Z", b"\0")
    np.testing.assert_array_equal(got, np.frombuffer(data, np.uint8))


# --------------------------------------------------------------------------
# whole files: archives equal and cross-decoding
# --------------------------------------------------------------------------

def _four_level(n, read_len, seed):
    """NovaSeq-like 4-level quality ('#', '-', '8', 'F') on ACGT reads:
    under -l at most 4 distinct binned values, so CTX's lags at orders 3
    and 6 are wider than qbits = 2."""
    rng = np.random.default_rng(seed)
    lv = np.frombuffer(b"#-8F", np.uint8)
    seqs, quals = [], []
    for _ in range(n):
        walk = np.abs(np.cumsum(rng.integers(-1, 2, read_len)))
        seqs.append(_pick(rng, b"ACGT", read_len))
        quals.append(lv[np.minimum(3, walk)].tobytes())
    return _fastq(seqs, quals)


def _file_case(name):
    """(data, settings) of one whole-file case.  The CRC and field-filter
    cases reuse the -d3 -q2 case's data and orders, so the reference's
    encoders compile once for the three."""
    from dsrc_tpu_torch.utils.synth import make_fastq_realistic
    d3q2 = dict(dna_compression_level=3, quality_compression_level=2)
    if name == "d0q0_variable":
        rng = np.random.default_rng(72)
        return _fastq(*_reads(rng, 900, 30, 110, b"ACGT", b"5:?DIKMN")), \
            dict()
    if name == "lossy_q1_4level":
        return _four_level(900, 70, 73), \
            dict(lossy_quality=True, quality_compression_level=1)
    if name == "lossy_q2_4level":
        return _four_level(900, 70, 74), \
            dict(lossy_quality=True, quality_compression_level=2)
    extra = {"d3q2": {}, "crc": dict(calculate_crc32=True),
             "fields": dict(tag_preserve_mask=0b101)}[name]
    return make_fastq_realistic(330, 100, seed=71), dict(d3q2, **extra)


FILES = ["d3q2", "d0q0_variable", "lossy_q1_4level", "lossy_q2_4level",
         "crc", "fields"]


@pytest.mark.parametrize("name", FILES)
def test_archives_cross_decode(jax_codec, name):
    data, kw = _file_case(name)
    jmod = JAPI.DsrcModule(JaxParams(fastq_block_size_bytes=BLOCK, **kw))
    jarch = io.BytesIO()
    with jax_codec():
        jmod.compress(io.BytesIO(data), jarch)
    tmod = DsrcModule(InputParameters(fastq_block_size_bytes=BLOCK, **kw),
                      device="cpu")
    tarch = io.BytesIO()
    info = tmod.compress(io.BytesIO(data), tarch)
    assert all(d and q for d, q in info.schemes)
    assert tarch.getvalue() == jarch.getvalue()
    tout = io.BytesIO()
    tmod.decompress(io.BytesIO(jarch.getvalue()), tout)
    got, want = tout.getvalue().split(b"\n"), data.split(b"\n")
    if "tag_preserve_mask" in kw:
        # titles lose their unkept fields; reads and qualities stay
        assert [g for i, g in enumerate(got) if i % 4] == \
            [w for i, w in enumerate(want) if i % 4]
        assert all(g.startswith(b"@") for g in got[0:-1:4])
    elif kw.get("lossy_quality"):
        # qualities are binned; titles and reads stay
        assert got[0::4] == want[0::4] and got[1::4] == want[1::4]
    else:
        assert tout.getvalue() == data


def test_lossy_4level_takes_the_wide_lags():
    """The 4-level lossy cases above code quality (4 binned values, qbits
    2) with a lag wider than qbits, the reference's negative shift: their
    blocks hold about 60,000 quality values, n_hint 2^16."""
    from dsrc_tpu_torch.models import quality as TQ
    assert TQ._a_pad(4) == 4 and TQ._qbits(4) == 2
    assert TQ._coarse_bits(3, 2, 1 << 16) == (2, 3, 1)
    assert TQ._coarse_bits(6, 2, 1 << 16) == (2, 3, 2)


def test_colour_space_still_raises(jax_codec):
    """Colour space (SOLiD) was the one GENERIC input the port refused; it
    now writes the reference's archive (tests/test_torch_colour.py covers
    the settings) and decodes it.  A colour-space block whose reads lack
    the primer base still raises."""
    solid = b"".join(b"@s%d\nT%s\n+\n%s\n" % (i, b"0123." * 6, b"I" * 30)
                     for i in range(40))
    kw = dict(fastq_block_size_bytes=BLOCK, dna_compression_level=1)
    jarch = io.BytesIO()
    with jax_codec():
        JAPI.DsrcModule(JaxParams(**kw)).compress(io.BytesIO(solid), jarch)
    tmod = DsrcModule(InputParameters(**kw), device="cpu")
    tarch, out = io.BytesIO(), io.BytesIO()
    tmod.compress(io.BytesIO(solid), tarch)
    assert tarch.getvalue() == jarch.getvalue()
    tmod.decompress(io.BytesIO(jarch.getvalue()), out)
    assert out.getvalue() == solid
    with pytest.raises(DsrcException, match="color-space length"):
        tmod.compress(io.BytesIO(solid + b"@x\n0123\n+\nIIII\n"),
                      io.BytesIO())


def test_gather_and_scatter_streams_equal_jax():
    """ops/parser.py's per-record stream gather (every GENERIC block's
    titles, reads and qualities) and its inverse scatter, against the
    reference on one parsed block."""
    import jax.numpy as jnp
    import torch
    from dsrc_tpu.ops import parser as JP
    from dsrc_tpu_torch.ops import parser as TP
    data, _kw, _s = _case("pack2_pos")
    cap, rcap = 1 << 14, 128
    head = np.frombuffer(data[:cap // 2], np.uint8)
    nbytes = int(np.flatnonzero(head == 10)[3::4][-1]) + 1
    buf = np.zeros(cap, np.uint8)
    buf[:nbytes] = head[:nbytes]
    jp = JP.parse_block(jnp.asarray(buf), jnp.int32(nbytes), rcap)
    tp = TP.parse_block(torch.from_numpy(buf), nbytes, rcap)
    for field in ("title", "seq", "qual"):
        starts, lens = (getattr(tp, f"{field}_{k}") for k in ("start", "len"))
        want = JP.gather_stream(jnp.asarray(buf), getattr(jp, f"{field}_start"),
                                getattr(jp, f"{field}_len"), cap)
        got = TP.gather_stream(torch.from_numpy(buf), starts, lens, cap)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert int(got[1]) == int(want[1])
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        back = TP.scatter_stream(got[0], got[2], lens, starts, cap)
        want_back = JP.scatter_stream(want[0], want[2],
                                      getattr(jp, f"{field}_len"),
                                      getattr(jp, f"{field}_start"), cap)
        np.testing.assert_array_equal(back.numpy(), np.asarray(want_back))
