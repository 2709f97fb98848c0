"""The tag coder's title passes in the native host library
(dsrc_tpu_torch/models/tag.py through dsrc_tpu_torch/utils/native.py) on
the CPU.

- tokenize, the field classification, analyze_value_fields,
  render_value_titles and decode_tags give dsrc_tpu's values and bytes
  (dsrc_tpu/models/tag.py) on generated titles (the benchmark's `fast`,
  UMI and `realistic` generators) and on edge cases: ties between modal
  separator rows and between modal token counts, zero-padded fields,
  numbers of 9, 10, 18 and 19 digits, empty titles, a trailing separator,
  one token, more than 64 fields, mixed structures with exceptions.
- encode_tags -> decode_tags and analyze_value_fields ->
  render_value_titles give dsrc_tpu's tag bytes and the input back.  The
  device byte coders are replaced in both packages by one that writes the
  stream and its contexts as they are, so every case runs in
  milliseconds; tests/test_torch_semi0.py and tests/test_torch_native.py
  hold the coded streams.
- Well-formed sections never reach the numpy renderers.  A malformed
  section the library declines (a value wider than its pad, exceptions
  out of order or that do not add up, fields of the wrong length, a value
  meta that does not fit its matrix) is rendered by them to dsrc_tpu's
  bytes, or raises what dsrc_tpu raises.
- A negative value on the render path (a malformed archive): decode_tags
  renders "%d" zero-filled as str.zfill does, natively; a value wider
  than its pad width goes to the numpy renderer (whose zfill truncates or
  not by version).  render_value_titles renders its digit rule for any
  value.
"""
import contextlib

import numpy as np
import pytest

from dsrc_tpu.models import tag as JTAG
from dsrc_tpu.utils.bitio import BitReader as JBitReader
from dsrc_tpu.utils.bitio import BitWriter as JBitWriter
from dsrc_tpu_torch.models import tag as TTAG
from dsrc_tpu_torch.ops.streams import pack_ints
from dsrc_tpu_torch.utils.bitio import BitReader, BitWriter
from torch_threads import one_torch_thread  # noqa: F401
from test_torch_native import GEN, same

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


@contextlib.contextmanager
def numpy_renders(raise_on_call: bool = False):
    """The names of the numpy renderers called inside the block, in order
    (with raise_on_call, a call raises instead)."""
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        for name in ("_render_tags_numpy", "_render_values_numpy"):
            real = getattr(TTAG, name)

            def renderer(*args, _name=name, _real=real):
                calls.append(_name)
                if raise_on_call:
                    raise AssertionError(f"{_name} reached")
                return _real(*args)
            mp.setattr(TTAG, name, renderer)
        yield calls


@pytest.mark.parametrize("name", sorted(TITLES))
def test_tokenize_matches_reference(name):
    s, ln = _stream(TITLES[name]())
    lib = _table(TTAG.tokenize(s, ln))
    assert same(lib, _table(JTAG.tokenize(s, ln)))
    if name == "tie-rows":
        assert lib[1].tobytes() == b".:" and list(lib[5]) == list(range(40))
    elif name == "tie-k":
        assert lib[0] == 3 and len(lib[5]) == 30
    elif name == "over-64-fields":
        assert lib is None


@pytest.mark.parametrize("stream,lengths", [
    (b"", []), (b"ab:c", [2, -1, 3]), (b"ab:c", [3, 2])])
def test_tokenize_rejects_lengths_the_stream_cannot_hold(stream, lengths):
    """No title, a negative length or a stream shorter than the lengths'
    sum never reaches the library's pointers."""
    with pytest.raises(ValueError, match="tag_tokenize"):
        TTAG.tokenize(np.frombuffer(stream, np.uint8),
                      np.array(lengths, np.int64))


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


def _reference_classify(stream, tt, max_digits):
    """_classify's kinds, pads and values by dsrc_tpu's field tests, as its
    encode_tags (at 18 digits) and analyze_value_fields (at 9) apply them."""
    kinds = np.full(tt.k, TEXT, np.int32)
    pads = np.zeros(tt.k, np.int64)
    vals = [None] * tt.k
    for f in range(tt.k):
        start, tlen = tt.tok_start[:, f], tt.tok_len[:, f]
        if JTAG._is_const(stream, start, tlen):
            kinds[f] = CONST
            continue
        v, pad = JTAG._numeric_values(stream, start, tlen)
        if v is not None and int(tlen.max()) <= max_digits:
            kinds[f], pads[f], vals[f] = NUM, pad, v
    return kinds, pads, vals


@pytest.mark.parametrize("max_digits", [9, 18])
@pytest.mark.parametrize("name", sorted(set(TITLES) - {"over-64-fields"}))
def test_classify_matches_reference(name, max_digits):
    s, ln = _stream(TITLES[name]())
    tt = TTAG.tokenize(s, ln)
    lib = TTAG._classify(s, tt, max_digits)
    ref = _reference_classify(s, tt, max_digits)
    assert same(lib[:2], ref[:2])
    for f in np.flatnonzero(lib[0] == TTAG.KIND_NUM):
        assert same(lib[2][f], ref[2][f])
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
def test_encode_decode_match_reference(name, plain_coders):
    titles = TITLES[name]()
    s, ln = _stream(titles)
    blob = _encode(TTAG, BitWriter, s, ln, "cpu")
    assert blob == _encode(JTAG, JBitWriter, s, ln)
    with numpy_renders(raise_on_call=True):
        out = TTAG.decode_tags(BitReader(blob), len(ln), CAP, "cpu")
    ref = JTAG.decode_tags(JBitReader(blob), len(ln), CAP)
    assert out[0].tobytes() == ref[0].tobytes() == s.tobytes()
    assert np.array_equal(out[1], ref[1]) and np.array_equal(out[1], ln)
    assert out[1].dtype == np.int64


VALUE_TITLES = {"fast-variable", "fast-fixed", "zero-padded", "digits-9",
                "k1-numeric", "empty", "trailing-separator"}
NOT_VALUE_TITLES = {"umi", "mixed-exceptions", "tie-k", "digits-10",
                    "over-64-fields", "k1-text", "long-const", "some-empty"}


@pytest.mark.parametrize("name", sorted(TITLES))
def test_value_titles_match_reference(name):
    s, ln = _stream(TITLES[name]())
    lib = TTAG.analyze_value_fields(s, ln)
    assert same(lib, JTAG.analyze_value_fields(s, ln))
    if name in VALUE_TITLES:
        assert lib is not None
    elif name in NOT_VALUE_TITLES:
        assert lib is None
    if lib is None:
        return
    vmat, meta = lib
    with numpy_renders(raise_on_call=True):
        got = TTAG.render_value_titles(vmat, meta, len(ln))
    want = JTAG.render_value_titles(vmat, meta, len(ln))
    assert got[0].tobytes() == want[0].tobytes() == s.tobytes()
    assert same(got[1], want[1])


NEG_VALUES = np.array([-1, -7, -12, -123456, -(1 << 62), -(1 << 63), 0, 5,
                       (1 << 63) - 1], np.int64)


def _section(k: int, fields, exc_idx=(), text=b"", exc_lens=(),
             exc_bytes=b"", seps=None) -> bytes:
    """A token-coded tag section by hand, its byte streams as plain_coders
    writes them.  fields: ("c", token) | ("n", values, pad) (FS_NUM_VALUE)
    | ("rle", run values, run lengths) | ("t", lengths) (FS_TEXT, its bytes
    in `text`)."""
    w = BitWriter()
    w.put_byte(TTAG.TS_TOK)
    w.put_varint(k)
    w.put_bytes(b":" * (k - 1) if seps is None else seps)
    pack_ints(w, np.asarray(exc_idx, np.int64))
    text_lens, text_fields = {}, []
    for fk, (kind, *arg) in enumerate(fields):
        if kind == "c":
            w.put_byte(TTAG.FS_CONST)
            w.put_varint(len(arg[0]))
            w.put_bytes(arg[0])
        elif kind == "n":
            vals, pad = arg
            w.put_byte(TTAG.FS_NUM_VALUE | (TTAG.FS_PAD_FLAG if pad else 0))
            if pad:
                w.put_varint(pad)
            pack_ints(w, np.asarray(vals, np.int64))
        elif kind == "rle":
            w.put_byte(TTAG.FS_NUM_RLE)
            pack_ints(w, np.asarray(arg[0], np.int64))
            pack_ints(w, np.asarray(arg[1], np.int64))
        else:
            w.put_byte(TTAG.FS_TEXT)
            pack_ints(w, np.asarray(arg[0], np.int64))
            text_lens[fk] = np.asarray(arg[0], np.int64)
            text_fields.append(fk)
    ctx = JTAG._text_ctx(text_lens, text_fields)
    w.put_varint(len(text))
    w.put_bytes(text)
    w.put_bytes(np.asarray(ctx[:len(text)], np.uint8).tobytes())
    if len(exc_idx):
        pack_ints(w, np.asarray(exc_lens, np.int64))
        w.put_varint(len(exc_bytes))
        w.put_bytes(exc_bytes)
    return w.getvalue()


def _num_section(vals, pad: int) -> bytes:
    """"x" ":" one FS_NUM_VALUE field (zero-padded to pad when pad > 0)."""
    return _section(2, [("c", b"x"), ("n", vals, pad)])


@pytest.mark.parametrize("pad", [0, 3, 21, 30])
@pytest.mark.parametrize("which", ["negative", "small", "one-wider",
                                   "all"])
def test_decode_renders_negative_values(which, pad, plain_coders):
    vals = {"negative": NEG_VALUES[:3], "small": np.array([-5, 0, 7, 42]),
            "one-wider": np.array([7, -123, 1234]), "all": NEG_VALUES}[which]
    blob = _num_section(vals, pad)
    with numpy_renders() as calls:
        lib = TTAG.decode_tags(BitReader(blob), len(vals), CAP, "cpu")
    ref = JTAG.decode_tags(JBitReader(blob), len(vals), CAP)
    assert lib[0].tobytes() == ref[0].tobytes()
    assert same(lib[1], ref[1])
    text = b"".join(b"x:" + (b"%d" % v).zfill(pad) for v in vals)
    fits = all(len(b"%d" % v) <= pad for v in vals)
    if pad == 0 or fits:
        # "%d" and str.zfill: the sign, then the zeros, then the digits
        assert lib[0].tobytes() == text
        assert calls == []
    else:
        # wider than the pad: the library declines, numpy renders it
        assert calls == ["_render_tags_numpy"]


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
    with numpy_renders(raise_on_call=True):
        lib = TTAG.render_value_titles(vmat, meta, n)
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
def test_titles_never_reach_numpy_renderers(name, plain_coders):
    s, ln = _stream(TITLES[name]())
    with numpy_renders(raise_on_call=True) as calls:
        blob = _encode(TTAG, BitWriter, s, ln, "cpu")
        out = TTAG.decode_tags(BitReader(blob), len(ln), CAP, "cpu")
        value = TTAG.analyze_value_fields(s, ln)
        if value is not None:
            TTAG.render_value_titles(*value, len(ln))
    assert out[0].tobytes() == s.tobytes() and calls == []


X3 = [("c", b"x"), ("n", [1, 2, 3], 0)]        # "x:1" "x:2" "x:3"
MALFORMED_TAGS = {   # (num_rec, section) of a section the library declines
    "no-fields": (3, lambda: _section(0, [])),
    "more-exceptions-than-records": (3, lambda: _section(
        2, X3, exc_idx=[0, 1, 2, 3], exc_lens=[1, 1, 1, 1],
        exc_bytes=b"abcd")),
    "exception-lengths-count": (4, lambda: _section(
        2, X3, exc_idx=[1], exc_lens=[2, 2], exc_bytes=b"abcd")),
    "exception-lengths-bytes": (4, lambda: _section(
        2, X3, exc_idx=[1], exc_lens=[5], exc_bytes=b"abc")),
    "negative-exception-length": (5, lambda: _section(
        2, X3, exc_idx=[1, 3], exc_lens=[-2, 4], exc_bytes=b"ab")),
    "exceptions-out-of-order": (5, lambda: _section(
        2, X3, exc_idx=[3, 1], exc_lens=[2, 3], exc_bytes=b"abcde")),
    "numeric-field-long": (3, lambda: _section(
        2, [("c", b"x"), ("n", [1, 2, 3, 4], 0)])),
    "numeric-field-short": (3, lambda: _section(
        2, [("c", b"x"), ("n", [1, 2], 0)])),
    "rle-runs-short": (4, lambda: _section(
        2, [("c", b"x"), ("rle", [7, 9], [1, 2])])),
    "pad-over-64": (3, lambda: _section(
        2, [("c", b"x"), ("n", [1, 22, 333], 65)])),
    "value-wider-than-pad": (3, lambda: _section(
        2, [("c", b"x"), ("n", [1, 22, 4444], 3)])),
    "text-lengths-count": (3, lambda: _section(
        2, [("c", b"x"), ("t", [2, 2])], text=b"abcd")),
    "text-lengths-sum": (3, lambda: _section(
        2, [("c", b"x"), ("t", [2, 2, 6])], text=b"abcdef")),
}
MALFORMED_VALUES = {   # (vmat, meta, num_rec) render_value_titles declines
    "values-too-few-columns": lambda: (
        np.arange(4, dtype=np.int32)[:, None],
        (3, b"::", [(TTAG.TOKF_NUM, None), (TTAG.TOKF_CONST, b"r"),
                    (TTAG.TOKF_NUM, None)]), 4),
    "values-num-rec-past-matrix": lambda: (
        np.arange(4, dtype=np.int32)[:, None],
        (2, b":", [(TTAG.TOKF_CONST, b"r"), (TTAG.TOKF_NUM, None)]), 6),
}


def _outcome(fn):
    """fn()'s (titles bytes, lengths), or the type of what it raised."""
    try:
        titles, lens = fn()
    except Exception as e:     # noqa: BLE001 -- the type is the result
        return type(e)
    return np.asarray(titles).tobytes(), np.asarray(lens, np.int64).tolist()


@pytest.mark.parametrize("name", sorted(MALFORMED_TAGS)
                         + sorted(MALFORMED_VALUES))
def test_malformed_section_renders_as_reference(name, plain_coders):
    """A malformed tag section the library declines decodes to dsrc_tpu's
    bytes or raises what it raises, through the numpy renderer."""
    if name in MALFORMED_TAGS:
        num_rec, section = MALFORMED_TAGS[name]
        blob = section()
        with numpy_renders() as calls:
            got = _outcome(lambda: TTAG.decode_tags(
                BitReader(blob), num_rec, CAP, "cpu"))
        want = _outcome(lambda: JTAG.decode_tags(
            JBitReader(blob), num_rec, CAP))
        assert calls == ["_render_tags_numpy"]
    else:
        vmat, meta, num_rec = MALFORMED_VALUES[name]()
        with numpy_renders() as calls:
            got = _outcome(lambda: TTAG.render_value_titles(
                vmat, meta, num_rec))
        want = _outcome(lambda: JTAG.render_value_titles(
            vmat, meta, num_rec))
        assert calls == ["_render_values_numpy"]
    assert got == want
