"""The tag coder's title passes in the native host library
(dsrc_tpu_torch/models/tag.py through dsrc_tpu_torch/utils/native.py) on
the CPU.

- tokenize, the field classification, render_value_titles and decode_tags
  give the same values and bytes from the library as from their numpy
  fallbacks, on generated titles (the benchmark's `fast`, UMI and
  `realistic` generators) and on edge cases: ties between modal separator
  rows and between modal token counts, zero-padded fields, numbers of 9,
  10, 18 and 19 digits, empty titles, a trailing separator, one token,
  more than 64 fields, mixed structures with exceptions.
- encode_tags -> decode_tags and analyze_value_fields ->
  render_value_titles give dsrc_tpu's tag bytes (dsrc_tpu/models/tag.py),
  and the input back.  The device byte coders are replaced in both
  packages by one that writes the stream and its contexts as they are, so
  every case runs in milliseconds; tests/test_torch_semi0.py and
  tests/test_torch_native.py hold the coded streams.
- A negative value on the render path (a malformed archive): decode_tags
  renders "%d" zero-filled as str.zfill does, natively; a value wider
  than its pad width goes to numpy (whose zfill truncates or not by
  version), counted as a fallback.  render_value_titles renders its digit
  rule for any value.
- Without the library every pass counts native.fallback; with it none.
"""
import numpy as np
import pytest

from dsrc_tpu.models import tag as JTAG
from dsrc_tpu.utils.bitio import BitReader as JBitReader
from dsrc_tpu.utils.bitio import BitWriter as JBitWriter
from dsrc_tpu_torch.models import tag as TTAG
from dsrc_tpu_torch.ops.streams import pack_ints
from dsrc_tpu_torch.utils import native, trace
from dsrc_tpu_torch.utils.bitio import BitReader, BitWriter
from torch_threads import one_torch_thread  # noqa: F401
from test_torch_native import GEN, both, same

FULL = 0xFFFFFFFFFFFFFFFF
CAP = 1 << 20


def _titles(fastq: bytes):
    return [line[1:] for line in fastq.split(b"\n")[:-1][0::4]]


def _tie_rows():
    # 40 records "a.b:N" and 40 "a:b.N" (appearing first): the row ".:"
    # sorts first and wins, as np.unique(axis=0) then argmax pick it
    return ([b"a:b.%d" % i for i in range(40)]
            + [b"a.b:%d" % i for i in range(40)])


def _tie_k():
    # as many records with 2 separators as with 4: the smaller k wins
    return [b"p:%d:q" % i for i in range(30)] + \
        [b"p:%d:q:r:%d" % (i, i % 7) for i in range(30)]


def _mixed():
    rng = np.random.default_rng(11)
    out = []
    for i in range(300):
        u = rng.random()
        if u < 0.7:
            out.append(b"SRR7.%d len=%d" % (i, 90 + i % 11))
        elif u < 0.85:
            out.append(b"odd_%d" % i)
        else:
            out.append(b"SRR7.%d/1 len=%d x" % (i, i))
    return out


TITLES = {
    "fast-variable": lambda: _titles(GEN.fastq_of_size(300_000, 7200000011)),
    "fast-fixed": lambda: _titles(GEN.fastq_of_size(
        300_000, 7200000011, fixed_width=True)),
    "umi": lambda: _titles(GEN.umi_fastq_of_size(300_000, 7100000003)),
    "hiseq": lambda: _titles(GEN.realistic_of_size(300_000, 7300000013)),
    "novaseq": lambda: _titles(GEN.realistic_of_size(
        300_000, 7300000013, platform="novaseq")),
    "mixed-exceptions": _mixed,
    "tie-rows": _tie_rows,
    "tie-k": _tie_k,
    "zero-padded": lambda: [b"%03d:%05d:7" % (i % 4, i * 37)
                            for i in range(200)],
    "padded-mixed-width": lambda: [b"id:%s" % (b"%03d" % i if i % 2 else
                                               b"%d" % (i * 1000))
                                   for i in range(100)],
    "digits-9": lambda: [b"n:%d" % (123456789 - i * 7) for i in range(50)],
    "digits-10": lambda: [b"n:%d" % (1234567890 + i) for i in range(50)],
    "digits-18": lambda: [b"n:%d" % (123456789012345678 - i)
                          for i in range(50)],
    "digits-19": lambda: [b"n:%d" % (1234567890123456789 + i)
                          for i in range(50)],
    "empty": lambda: [b""] * 40,
    "some-empty": lambda: [b"r:%d" % i if i % 5 else b""
                           for i in range(100)],
    "trailing-separator": lambda: [b"r:%d:" % i for i in range(60)],
    "k1-numeric": lambda: [b"%d" % (i * 3) for i in range(60)],
    "k1-text": lambda: [b"read%sz" % b"ACGT"[i % 4:i % 4 + 1]
                        for i in range(60)],
    "over-64-fields": lambda: [b":".join(b"%d" % (i + j) for j in range(70))
                               for i in range(20)],
    "long-const": lambda: [b"c:" + b"Q" * 129 + b":%d" % i
                           for i in range(20)],
}


def _stream(titles):
    return (np.frombuffer(b"".join(titles), np.uint8),
            np.array([len(t) for t in titles], np.int64))


@pytest.fixture(scope="module")
def plain_coders():
    """The byte coders of both packages replaced by one that writes the
    stream (and the text stream's contexts) as they are."""
    def put(w, data, ctx=None):
        w.put_varint(len(data))
        w.put_bytes(np.asarray(data, np.uint8).tobytes())
        if ctx is not None:
            w.put_bytes(np.asarray(ctx[:len(data)], np.uint8).tobytes())

    def get(r, ctx=None):
        n = r.get_varint()
        data = np.frombuffer(r.get_bytes(n), np.uint8)
        if ctx is not None:
            assert r.get_bytes(n) == np.asarray(ctx[:n], np.uint8).tobytes()
        return data

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TTAG, "_code_text", lambda w, d, c, cap, dev: put(w, d, c))
        mp.setattr(TTAG, "_code_bytes", lambda w, d, cap, dev: put(w, d))
        mp.setattr(TTAG, "_decode_text", lambda r, c, cap, dev: get(r, c))
        mp.setattr(TTAG, "_decode_bytes", lambda r, cap, dev: get(r))
        mp.setattr(JTAG, "_code_text", lambda w, d, c, cap: put(w, d, c))
        mp.setattr(JTAG, "_code_bytes", lambda w, d, cap: put(w, d))
        mp.setattr(JTAG, "_decode_text", lambda r, c, cap: get(r, c))
        mp.setattr(JTAG, "_decode_bytes", lambda r, cap: get(r))
        yield


def _table(tt):
    return None if tt is None else (tt.k, tt.seps, tt.tok_start, tt.tok_len,
                                    tt.match_idx, tt.exc_idx)


@pytest.mark.parametrize("name", sorted(TITLES))
def test_tokenize_matches_fallback_and_reference(name):
    s, ln = _stream(TITLES[name]())
    lib, fb = both(lambda: _table(TTAG.tokenize(s, ln)))
    assert same(lib, fb)
    assert same(lib, _table(JTAG.tokenize(s, ln)))
    if name == "tie-rows":
        assert lib[1].tobytes() == b".:" and list(lib[5]) == list(range(40))
    elif name == "tie-k":
        assert lib[0] == 3 and len(lib[5]) == 30
    elif name == "over-64-fields":
        assert lib is None


CONST, NUM, TEXT = TTAG.KIND_CONST, TTAG.KIND_NUM, TTAG.KIND_TEXT
WANT_KINDS = {      # the fields' kinds at 9 and at 18 digits
    "digits-9": {9: [CONST, NUM], 18: [CONST, NUM]},
    "digits-10": {9: [CONST, TEXT], 18: [CONST, NUM]},
    "digits-18": {9: [CONST, TEXT], 18: [CONST, NUM]},
    "digits-19": {9: [CONST, TEXT], 18: [CONST, TEXT]},
    "long-const": {9: [CONST, TEXT, NUM], 18: [CONST, TEXT, NUM]},
    "zero-padded": {9: [NUM, NUM, CONST], 18: [NUM, NUM, CONST]},
    "padded-mixed-width": {9: [CONST, TEXT], 18: [CONST, TEXT]},
    "trailing-separator": {9: [CONST, NUM, CONST], 18: [CONST, NUM, CONST]},
    "empty": {9: [CONST], 18: [CONST]},
    "k1-text": {9: [TEXT], 18: [TEXT]},
}


@pytest.mark.parametrize("max_digits", [9, 18])
@pytest.mark.parametrize("name", sorted(set(TITLES) - {"over-64-fields"}))
def test_classify_matches_fallback(name, max_digits):
    s, ln = _stream(TITLES[name]())
    tt = TTAG.tokenize(s, ln)
    lib, fb = both(TTAG._classify, s, tt, max_digits)
    assert same(lib[:2], fb[:2])
    for f in np.flatnonzero(lib[0] == TTAG.KIND_NUM):
        assert same(lib[2][f], fb[2][f])
    want = WANT_KINDS.get(name)
    if want is not None:
        assert list(lib[0]) == want[max_digits]
    if name == "zero-padded":
        assert list(lib[1]) == [3, 5, 0]


def _encode(mod, writer, s, ln, *args):
    w = writer()
    mod.encode_tags(w, s, ln, FULL, CAP, *args)
    return w.getvalue()


@pytest.mark.parametrize("name", sorted(TITLES))
def test_encode_decode_match_fallback_and_reference(name, plain_coders):
    titles = TITLES[name]()
    s, ln = _stream(titles)

    def round_trip():
        blob = _encode(TTAG, BitWriter, s, ln, "cpu")
        return blob, TTAG.decode_tags(BitReader(blob), len(ln), CAP, "cpu")

    (blob, out), (blob_fb, out_fb) = both(round_trip)
    assert blob == blob_fb == _encode(JTAG, JBitWriter, s, ln)
    assert same(out, out_fb)
    ref = JTAG.decode_tags(JBitReader(blob), len(ln), CAP)
    assert out[0].tobytes() == ref[0].tobytes() == s.tobytes()
    assert np.array_equal(out[1], ref[1]) and np.array_equal(out[1], ln)
    assert out[1].dtype == np.int64


VALUE_TITLES = {"fast-variable", "fast-fixed", "zero-padded", "digits-9",
                "k1-numeric", "empty", "trailing-separator"}
NOT_VALUE_TITLES = {"umi", "mixed-exceptions", "tie-k", "digits-10",
                    "over-64-fields", "k1-text", "long-const", "some-empty"}


@pytest.mark.parametrize("name", sorted(TITLES))
def test_value_titles_match_fallback_and_reference(name):
    s, ln = _stream(TITLES[name]())
    lib, fb = both(TTAG.analyze_value_fields, s, ln)
    ref = JTAG.analyze_value_fields(s, ln)
    assert same(lib, fb) and same(lib, ref)
    if name in VALUE_TITLES:
        assert lib is not None
    elif name in NOT_VALUE_TITLES:
        assert lib is None
    if lib is None:
        return
    vmat, meta = lib
    got, got_fb = both(TTAG.render_value_titles, vmat, meta, len(ln))
    assert same(got, got_fb)
    want = JTAG.render_value_titles(vmat, meta, len(ln))
    assert got[0].tobytes() == want[0].tobytes() == s.tobytes()
    assert same(got[1], want[1])


NEG_VALUES = np.array([-1, -7, -12, -123456, -(1 << 62), -(1 << 63), 0, 5,
                       (1 << 63) - 1], np.int64)


def _num_section(vals, pad: int) -> bytes:
    """A token-coded tag section by hand: "x" ":" one FS_NUM_VALUE field
    (zero-padded to pad when pad > 0), no text, no exceptions."""
    w = BitWriter()
    w.put_byte(TTAG.TS_TOK)
    w.put_varint(2)
    w.put_bytes(b":")
    pack_ints(w, np.zeros(0, np.int64))
    w.put_byte(TTAG.FS_CONST)
    w.put_varint(1)
    w.put_bytes(b"x")
    w.put_byte(TTAG.FS_NUM_VALUE | (TTAG.FS_PAD_FLAG if pad else 0))
    if pad:
        w.put_varint(pad)
    pack_ints(w, vals)
    w.put_varint(0)          # the (empty) text stream, as plain_coders has it
    return w.getvalue()


@pytest.mark.parametrize("pad", [0, 3, 21, 30])
@pytest.mark.parametrize("which", ["negative", "small", "one-wider",
                                   "all"])
def test_decode_renders_negative_values(which, pad, plain_coders):
    vals = {"negative": NEG_VALUES[:3], "small": np.array([-5, 0, 7, 42]),
            "one-wider": np.array([7, -123, 1234]), "all": NEG_VALUES}[which]
    blob = _num_section(vals, pad)

    def decode():
        trace.start(keep=False)
        try:
            out = TTAG.decode_tags(BitReader(blob), len(vals), CAP, "cpu")
        finally:
            rec = trace.stop()
        fb = rec.by_name().get(native.FALLBACK)
        return out, fb.count if fb else 0

    (lib, n_lib), (fb, n_fb) = both(decode)
    assert same(lib, fb)
    ref = JTAG.decode_tags(JBitReader(blob), len(vals), CAP)
    assert lib[0].tobytes() == ref[0].tobytes()
    assert same(lib[1], ref[1])
    text = b"".join(b"x:" + (b"%d" % v).zfill(pad) for v in vals)
    fits = all(len(b"%d" % v) <= pad for v in vals)
    if pad == 0 or fits:
        # "%d" and str.zfill: the sign, then the zeros, then the digits
        assert lib[0].tobytes() == text
        assert n_lib == 0
    else:
        # wider than the pad: numpy renders it on every path
        assert n_lib == 1
    assert n_fb == 1


@pytest.mark.parametrize("fields", [
    [(TTAG.TOKF_NUM, None)],
    [(TTAG.TOKF_CONST, b"ab"), (TTAG.TOKF_NUM_PAD, 4)],
    [(TTAG.TOKF_NUM_PAD, 10), (TTAG.TOKF_NUM, None), (TTAG.TOKF_CONST, b"")],
    [(TTAG.TOKF_NUM_PAD, 0), (TTAG.TOKF_NUM, None)],
])
def test_render_value_titles_any_value(fields):
    rng = np.random.default_rng(len(fields))
    n = 64
    cols = sum(sch != TTAG.TOKF_CONST for sch, _ in fields)
    vmat = rng.integers(-(1 << 31), 1 << 31, (n, cols)).astype(np.int32)
    vmat[:8, 0] = [-1, -9, -10, -123, 0, 9, 10, (1 << 31) - 1]
    meta = (len(fields), b":.#"[:len(fields) - 1], fields)
    lib, fb = both(TTAG.render_value_titles, vmat, meta, n)
    assert same(lib, fb)
    ref = JTAG.render_value_titles(vmat, meta, n)
    assert lib[0].tobytes() == ref[0].tobytes()
    assert same(lib[1], ref[1])


def test_render_value_titles_pad_past_ten_keeps_numpy():
    """A pad width over 10 (never written: a value field holds at most 9
    digits) indexes past numpy's powers of ten on both paths."""
    meta = (1, b"", [(TTAG.TOKF_NUM_PAD, 11)])
    vmat = np.arange(4, dtype=np.int32)[:, None]
    with pytest.raises(IndexError):
        TTAG.render_value_titles(vmat, meta, 4)
    with pytest.raises(IndexError):
        JTAG.render_value_titles(vmat, meta, 4)


@pytest.mark.parametrize("name", ["umi", "mixed-exceptions", "hiseq"])
def test_fallback_counted_only_without_library(name, plain_coders):
    s, ln = _stream(TITLES[name]())

    def calls():
        trace.start(keep=False)
        try:
            blob = _encode(TTAG, BitWriter, s, ln, "cpu")
            TTAG.decode_tags(BitReader(blob), len(ln), CAP, "cpu")
            TTAG.analyze_value_fields(s, ln)
        finally:
            rec = trace.stop()
        fb = rec.by_name().get(native.FALLBACK)
        return fb.count if fb else 0

    n_lib, n_fb = both(calls)
    assert n_lib == 0
    # tokenize twice, classify once or twice, render once
    assert n_fb >= 4
