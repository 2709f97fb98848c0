"""Tag (read-title) codec (port of dsrc_tpu/models/tag.py; host numpy
analysis copied as it is, byte-identical sections).

Titles are tokenized at the separators " ._,=:/-#" (reference
TagModeler.cpp:161); each field of the block's modal structure is coded as a
constant, by one of the numeric schemes (delta-const, value, delta, RLE,
delta-RLE, dictionary) chosen by an explicit bit-cost model, or as free
text in one shared byte stream with (field, position) contexts.  Records
that deviate from the modal structure go raw on the side; a block with no
dominant structure is coded raw as one order-1 byte stream.  The byte
streams go through ops/ctx.py (K1 to encode, K3 to decode) on the codec's
device.  GENERIC blocks and semi title mode 0 code their titles with
encode_tags / decode_tags; semi title mode 2 uses analyze_value_fields /
render_value_titles: every field constant or numeric, coded on the device
as an [R, F] value matrix.

The passes over title bytes (tokenize, the field classification, and the
rendering of decoded fields back to titles) run in the native host library
(utils/native.py), which the port requires.  The two renderers keep a numpy
body for the sections the library declines, which only a malformed archive
holds: there they render, or reject, as dsrc_tpu does.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import DsrcException
from ..ops import ctx as C
from ..ops.streams import (deserialize_rans, pack_ints, serialize_rans,
                           stream_tensors, to_numpy, unpack_ints)
from ..utils import native
from ..utils.bitio import BitReader, BitWriter

SEPARATORS = b" ._,=:/-#"
_SEP_SET = np.zeros(256, bool)
for _c in SEPARATORS:
    _SEP_SET[_c] = True

MAX_FIELDS = 64          # beyond this -> raw (reference numbers fields to 64)
MAX_CONST_LEN = 128      # reference MAX_FIELD_STAT_LEN
MAX_DICT = 512           # reference Huffman-over-values cap (TagModeler.h:73)

TS_EMPTY = 0
TS_RAW = 1
TS_TOK = 2

FS_CONST = 0
FS_NUM_DELTA_CONST = 1
FS_NUM_VALUE = 2
FS_NUM_DELTA = 3
FS_TEXT = 4
FS_NUM_RLE = 5
FS_NUM_DELTA_RLE = 6
FS_NUM_DICT = 7
FS_TEXT_DELTA = 8
FS_PAD_FLAG = 0x10       # numeric scheme modifier: zero-padded fixed width


class TokenTable:
    """Token structure of the records matching the block's modal format:
    K tokens separated by K-1 separator chars (a title may end in a
    separator: its final token is empty).  `exc_idx` lists the records that
    deviate (coded raw on the side)."""

    def __init__(self, k: int, seps: np.ndarray, tok_start: np.ndarray,
                 tok_len: np.ndarray, match_idx: np.ndarray,
                 exc_idx: np.ndarray):
        self.k = k                    # tokens per matching record
        self.seps = seps              # [K-1] separator chars (modal)
        self.tok_start = tok_start    # [Rm, K] global offsets into stream
        self.tok_len = tok_len        # [Rm, K]
        self.match_idx = match_idx    # [Rm] record indices (sorted)
        self.exc_idx = exc_idx        # [Re] record indices (sorted)


def tokenize(stream: np.ndarray, lengths: np.ndarray
             ) -> Optional[TokenTable]:
    """Split titles at separators; records deviating from the modal
    (field count, separator sequence) become exceptions.  None when fewer
    than half the records share one structure (mixed block -> raw)."""
    tt = native.tag_tokenize(stream, lengths, MAX_FIELDS)
    return None if tt is None else TokenTable(*tt)


def filter_fields(stream: np.ndarray, lengths: np.ndarray,
                  preserve_mask: int) -> Tuple[np.ndarray, np.ndarray]:
    """Drop tokens (and their trailing separators) whose 1-based index is not
    preserved.  Per-record, structure-independent (like FastqParserExt)."""
    R = len(lengths)
    n = int(lengths.sum())
    stream = stream[:n]
    rec_of = np.repeat(np.arange(R, dtype=np.int64), lengths)
    is_sep = _SEP_SET[stream]
    # token id of each char within its record (separators close their token)
    sep_cum = np.cumsum(is_sep)
    rec_start = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    sep_before_rec = np.concatenate(
        [[0], sep_cum]).astype(np.int64)[rec_start[rec_of]]
    tok_id = np.where(is_sep, sep_cum - 1, sep_cum) - sep_before_rec
    tok_id = np.minimum(tok_id, 63)
    keep_tok = np.array([(preserve_mask >> i) & 1 for i in range(64)], bool)
    keep = keep_tok[tok_id]
    new_stream = stream[keep]
    new_lengths = np.zeros(R, np.int64)
    np.add.at(new_lengths, rec_of[keep], 1)
    return new_stream, new_lengths


# --------------------------------------------------------------------------
# Per-field analysis
# --------------------------------------------------------------------------

KIND_CONST = 0     # _classify's field kinds
KIND_NUM = 1
KIND_TEXT = 2


def _classify(stream: np.ndarray, tt: TokenTable, max_digits: int):
    """Each field of tt as KIND_CONST (one token of at most MAX_CONST_LEN
    bytes in every record), KIND_NUM (decimal tokens of at most max_digits
    <= 18 digits, all of one width when one is zero-padded) or KIND_TEXT:
    (kinds [k], pads [k], vals), vals[f] a numeric field's int64 values and
    pads[f] its pad width."""
    return native.tag_classify(stream, tt.tok_start, tt.tok_len,
                               max_digits, MAX_CONST_LEN)


def _extract_field(stream, start, tlen) -> np.ndarray:
    """Concatenated bytes of one field across records (record-major)."""
    total = int(tlen.sum())
    if total == 0:
        return np.zeros(0, np.uint8)
    reps = np.repeat(np.arange(len(tlen), dtype=np.int64), tlen)
    offs = np.concatenate([[0], np.cumsum(tlen)[:-1]]).astype(np.int64)
    within = np.arange(total, dtype=np.int64) - offs[reps]
    return stream[start[reps] + within]


def _runs(vals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(run_values, run_lengths) of a value sequence."""
    if len(vals) == 0:
        return vals, np.zeros(0, np.int64)
    change = np.concatenate([[True], vals[1:] != vals[:-1]])
    starts = np.flatnonzero(change)
    lens = np.diff(np.concatenate([starts, [len(vals)]]))
    return vals[starts], lens.astype(np.int64)


def _pack_cost(vals: np.ndarray) -> int:
    """Bits pack_ints would spend (width * n + small header)."""
    if len(vals) == 0:
        return 16
    width = int(vals.max() - vals.min()).bit_length()
    return width * len(vals) + 80


def _choose_numeric_scheme(vals: np.ndarray):
    """Explicit bit-cost shootout across the numeric scheme zoo (reference
    FinalizeFieldsStats, TagModeler.cpp:461-551).  Returns (scheme, payload
    tuple)."""
    R = len(vals)
    diffs = np.diff(vals)
    if R >= 2 and len(diffs) and (diffs == diffs[0]).all():
        return FS_NUM_DELTA_CONST, (int(vals[0]), int(diffs[0]))
    costs = {FS_NUM_VALUE: _pack_cost(vals)}
    if R >= 2:
        costs[FS_NUM_DELTA] = _pack_cost(diffs) + 64
    rv, rl = _runs(vals)
    costs[FS_NUM_RLE] = _pack_cost(rv) + _pack_cost(rl)
    if R >= 2:
        dv, dl = _runs(diffs)
        costs[FS_NUM_DELTA_RLE] = _pack_cost(dv) + _pack_cost(dl) + 64
    uniq = np.unique(vals)
    if 1 < len(uniq) <= MAX_DICT:
        idx_width = int(len(uniq) - 1).bit_length()
        costs[FS_NUM_DICT] = _pack_cost(uniq) + idx_width * R + 80
    scheme = min(costs, key=costs.get)
    if scheme == FS_NUM_VALUE:
        return scheme, (vals,)
    if scheme == FS_NUM_DELTA:
        return scheme, (int(vals[0]), diffs)
    if scheme == FS_NUM_RLE:
        return scheme, (rv, rl)
    if scheme == FS_NUM_DELTA_RLE:
        return scheme, (int(vals[0]), dv, dl)
    idx = np.searchsorted(uniq, vals)
    return FS_NUM_DICT, (uniq, idx)


# --------------------------------------------------------------------------
# Text-field vertical delta (reference ham_mask, TagModeler.cpp:159-459)
# --------------------------------------------------------------------------

def _text_mat(field: np.ndarray, tlen: np.ndarray):
    """Field bytes -> ([R, W] matrix, [R, W] validity mask)."""
    R = len(tlen)
    w = int(tlen.max()) if R else 0
    mat = np.zeros((R, max(w, 1)), np.int64)
    mask = np.arange(max(w, 1))[None, :] < tlen[:, None]
    if field.size:
        mat[mask] = field
    return mat, mask


def _text_delta_fwd(field: np.ndarray, tlen: np.ndarray) -> np.ndarray:
    """sym = (char - previous record's char at the same position) mod 256;
    positions past the previous record's length (and record 0) are literal."""
    mat, mask = _text_mat(field, tlen)
    prev = np.zeros_like(mat)
    prev[1:] = mat[:-1]
    pmask = np.zeros_like(mask)
    pmask[1:] = mask[:-1]
    out = np.where(pmask, (mat - prev) & 0xFF, mat)
    return out[mask].astype(np.uint8)


def _text_delta_bwd(deltas: np.ndarray, tlen: np.ndarray) -> np.ndarray:
    """Inverse of _text_delta_fwd, vectorized per column: within segments
    between literal resets the char is a running sum of deltas mod 256."""
    mat, mask = _text_mat(deltas, tlen)
    R, W = mat.shape
    rows = np.arange(R)
    pmask = np.zeros_like(mask)
    pmask[1:] = mask[:-1]
    reset = mask & ~pmask                     # literal positions
    csum = np.cumsum(np.where(mask, mat, 0), axis=0)
    # prefix sum just above each position's latest reset row
    reset_row = np.where(reset, rows[:, None], -1)
    last_reset = np.maximum.accumulate(reset_row, axis=0)
    base = np.where(last_reset > 0,
                    np.take_along_axis(
                        np.concatenate([np.zeros((1, W), np.int64),
                                        csum[:-1]], axis=0),
                        np.maximum(last_reset, 0), axis=0), 0)
    out = (csum - base) & 0xFF
    return out[mask].astype(np.uint8)


def _pos_entropy_bits(data: np.ndarray, pos: np.ndarray) -> float:
    """Total bits under a per-(pos bucket) byte model (matches the device
    coder's positional context)."""
    if len(data) == 0:
        return 0.0
    key = pos.astype(np.int64) * 256 + data
    counts = np.bincount(key, minlength=1)
    counts = counts[counts > 0].astype(np.float64)
    grp = np.bincount(pos, minlength=1).astype(np.float64)
    grp = grp[grp > 0]
    return float(-(counts * np.log2(counts)).sum()
                 + (grp * np.log2(grp)).sum())


def _field_positions(tlen: np.ndarray) -> np.ndarray:
    total = int(tlen.sum())
    reps = np.repeat(np.arange(len(tlen), dtype=np.int64), tlen)
    offs = np.concatenate([[0], np.cumsum(tlen)[:-1]]).astype(np.int64)
    return np.minimum(np.arange(total, dtype=np.int64) - offs[reps],
                      (1 << POS_CTX_BITS) - 1)


# --------------------------------------------------------------------------
# Device byte-stream codec (shared by raw titles and text tokens)
# --------------------------------------------------------------------------

def _dev(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _code_bytes(w: BitWriter, data: np.ndarray, cap: int, device) -> None:
    """Order-1 byte-context rANS of a [n] uint8 array (n <= cap).  Lane
    geometry is sized to the stream (ops/ctx.py stream_cap), not the block."""
    n = len(data)
    nc = C.stream_cap(cap, n)
    num_lanes = C.pick_num_lanes(nc)
    edges = C.band_edges(nc // num_lanes)
    padded = _dev(np.pad(data.astype(np.int32), (0, nc - n)), device)
    enc = C.encode_orderk(padded, n, 1, 8, 256, num_lanes, edges)
    serialize_rans(w, n, enc["payload"], enc["nwords"], enc["states"])


POS_CTX_BITS = 4   # token-position context (reference per-position char
FID_CTX_BITS = 3   # histograms, TagModeler.cpp:159-459) + field id
TEXT_NUM_CTX = 1 << (POS_CTX_BITS + FID_CTX_BITS)


def _text_ctx(field_lens, text_fields) -> np.ndarray:
    """Context ids for the shared text stream: (field id & 7) << 4 |
    min(position-in-token, 15).  Derivable by the decoder from the already
    transmitted per-field token lengths."""
    parts = []
    for fk in text_fields:
        lens = np.asarray(field_lens[fk], np.int64)
        pos = _field_positions(lens)
        parts.append(((fk & 7) << POS_CTX_BITS) | pos)
    return (np.concatenate(parts) if parts
            else np.zeros(0, np.int64)).astype(np.int32)


def _code_text(w: BitWriter, data: np.ndarray, ctx: np.ndarray,
               cap: int, device) -> None:
    """Positional-context coding of the shared token text stream."""
    from .quality import _encode_ctxarr
    n = len(data)
    nc = C.stream_cap(cap, n)
    num_lanes = C.pick_num_lanes(nc)
    edges = C.band_edges(nc // num_lanes)
    d = _dev(np.pad(data.astype(np.int32), (0, nc - n)), device)
    c = _dev(np.pad(ctx[:n], (0, nc - n)), device)
    enc = _encode_ctxarr(d, n, c, TEXT_NUM_CTX, 256, num_lanes, edges)
    serialize_rans(w, n, enc["payload"], enc["nwords"], enc["states"])


def _decode_text(r: BitReader, ctx: np.ndarray, cap: int,
                 device) -> np.ndarray:
    from .quality import _decode_ctxarr
    n, payload, states, _ = deserialize_rans(r)
    if n == 0:
        return np.zeros(0, np.uint8)
    nc = C.stream_cap(cap, n)
    num_lanes = C.pick_num_lanes(nc)
    edges = C.band_edges(nc // num_lanes)
    t_steps = nc // num_lanes
    pl, st = stream_tensors(payload, states, num_lanes, device)
    c = _dev(np.pad(ctx[:n].astype(np.int32), (0, nc - n)), device)
    dec = _decode_ctxarr(pl, st, n, c, t_steps, TEXT_NUM_CTX, 256,
                         num_lanes, edges)
    return to_numpy(dec[:n]).astype(np.uint8)


def _decode_bytes(r: BitReader, cap: int, device) -> np.ndarray:
    n, payload, states, _ = deserialize_rans(r)
    if n == 0:
        return np.zeros(0, np.uint8)
    nc = C.stream_cap(cap, n)
    num_lanes = C.pick_num_lanes(nc)
    edges = C.band_edges(nc // num_lanes)
    t_steps = nc // num_lanes
    pl, st = stream_tensors(payload, states, num_lanes, device)
    dec = C.decode_orderk(pl, st, n, t_steps, 1, 8, 256, num_lanes, edges)
    return to_numpy(dec[:n]).astype(np.uint8)


# --------------------------------------------------------------------------
# Value-field analysis for device title coding (semi title mode 2)
# --------------------------------------------------------------------------

TOKF_CONST = 0     # identical token in every record: stored once
TOKF_NUM = 1       # canonical decimal (no leading zeros): value column
TOKF_NUM_PAD = 2   # zero-padded fixed-width decimal: value column + width


def analyze_value_fields(stream: np.ndarray, lengths: np.ndarray):
    """Tokenize titles and classify every field as constant or numeric, so
    the whole title section reduces to an [R, F] int32 VALUE matrix the
    device codes with group-delta byte-plane rANS (semi mode 2) — the
    reference TagModeler's const/numeric schemes (TagModeler.cpp:461-551)
    restated as matrix columns.

    Returns (vmat [R, F] int32, meta) or None when the block doesn't fit
    (structure exceptions, text fields, >9-digit numbers).  meta =
    (k, seps bytes, fields) with fields: (TOKF_CONST, bytes) |
    (TOKF_NUM, None) | (TOKF_NUM_PAD, width) — everything needed to render
    titles exactly from the values."""
    stream = np.ascontiguousarray(stream, np.uint8)
    lengths = np.ascontiguousarray(lengths, np.int64)
    tt = tokenize(stream, lengths)
    if tt is None or len(tt.exc_idx):
        return None
    kinds, pads, vals = _classify(stream, tt, 9)
    if (kinds == KIND_TEXT).any():
        return None              # text or >9 digits: host tag coder instead
    fields = []
    vcols = []
    for f in range(tt.k):
        if kinds[f] == KIND_CONST:
            s0, w0 = int(tt.tok_start[0, f]), int(tt.tok_len[0, f])
            fields.append((TOKF_CONST, stream[s0:s0 + w0].tobytes()))
            continue
        if pads[f]:
            fields.append((TOKF_NUM_PAD, int(pads[f])))
        else:
            fields.append((TOKF_NUM, None))
        vcols.append(vals[f].astype(np.int32))
    vmat = (np.stack(vcols, axis=1) if vcols
            else np.zeros((len(lengths), 0), np.int32))
    return vmat, (tt.k, bytes(tt.seps), fields)


_POW10 = 10 ** np.arange(10, dtype=np.int64)


def _render_values_native(vmat: np.ndarray, meta, num_rec: int):
    """render_value_titles from the library in one pass, or None for a
    meta or value matrix that does not fit, which only a malformed archive
    holds (_render_values_numpy renders or rejects those as dsrc_tpu
    does)."""
    k, seps, fields = meta
    nnum = sum(sch != TOKF_CONST for sch, _ in fields)
    if len(fields) != k or len(seps) < k - 1 or vmat.ndim != 2 \
            or not 0 <= num_rec <= len(vmat) or vmat.shape[1] < nnum or any(
                sch == TOKF_NUM_PAD and not 0 <= int(arg) <= 10
                for sch, arg in fields):
        return None
    kind = np.array([0 if sch == TOKF_CONST else
                     2 if sch == TOKF_NUM_PAD else 1
                     for sch, _ in fields], np.int32)
    arg = np.array([len(a) if sch == TOKF_CONST else
                    int(a) if sch == TOKF_NUM_PAD else 0
                    for sch, a in fields], np.int64)
    data = [np.frombuffer(a, np.uint8) if sch == TOKF_CONST else None
            for sch, a in fields]
    width = int(np.where(kind == 1, 10, arg).sum()) + max(k - 1, 0)
    return native.tag_render_values(
        num_rec, np.frombuffer(seps, np.uint8), kind, arg, data,
        np.ascontiguousarray(vmat[:num_rec]), num_rec * width)


def render_value_titles(vmat: np.ndarray, meta, num_rec: int):
    """Inverse of analyze_value_fields: (concatenated titles u8,
    lengths i64).  A field of TOKF_NUM takes as many digits as its value
    has (1 to 10), one of TOKF_NUM_PAD its width; digit i of w is
    floor(v / 10^(w-1-i)) mod 10, exact by construction."""
    vmat = np.asarray(vmat, np.int64)
    got = _render_values_native(vmat, meta, num_rec)
    if got is not None:
        return got
    return _render_values_numpy(vmat, meta, num_rec)


def _render_values_numpy(vmat: np.ndarray, meta, num_rec: int):
    """render_value_titles for what the library declines (a malformed
    archive's meta or value matrix), by numpy as dsrc_tpu renders it, or
    raising what dsrc_tpu raises."""
    k, seps, fields = meta
    vmat = vmat[:num_rec]
    col = 0
    widths = []                    # per piece: [R] char widths
    pieces = []                    # (kind, arg): 'c' bytes | 'n' (vals, w)
    for f, (sch, arg) in enumerate(fields):
        if sch == TOKF_CONST:
            pieces.append(("c", np.frombuffer(arg, np.uint8)))
            widths.append(np.full(num_rec, len(arg), np.int64))
        else:
            v = vmat[:, col]
            col += 1
            if sch == TOKF_NUM_PAD:
                w = np.full(num_rec, int(arg), np.int64)
            else:
                w = 1 + (v[None, :] >= _POW10[1:10, None]).sum(0)
            pieces.append(("n", (v, w)))
            widths.append(w)
        if f < k - 1:
            pieces.append(("c", np.frombuffer(seps[f:f + 1], np.uint8)))
            widths.append(np.full(num_rec, 1, np.int64))
    lens = np.sum(widths, axis=0) if widths else \
        np.zeros(num_rec, np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    out = np.zeros(int(lens.sum()), np.uint8)
    off = np.zeros(num_rec, np.int64)
    for (kind, arg), w in zip(pieces, widths):
        dst = starts + off
        if kind == "c":
            out[dst[:, None] + np.arange(len(arg))[None, :]] = arg[None, :]
        else:
            v, wn = arg
            maxw = int(wn.max()) if len(wn) else 0
            if maxw:
                ci = np.arange(maxw, dtype=np.int64)[None, :]
                exp = wn[:, None] - 1 - ci
                dig = (v[:, None] // _POW10[np.maximum(exp, 0)]) % 10
                m = ci < wn[:, None]
                out[(dst[:, None] + ci)[m]] = (dig + 48)[m].astype(np.uint8)
        off = off + w
    return out, lens


# --------------------------------------------------------------------------
# Encode
# --------------------------------------------------------------------------

def encode_tags(w: BitWriter, stream: np.ndarray, lengths: np.ndarray,
                preserve_mask: int, cap: int, device) -> None:
    """stream: concatenated title bytes (no '@'), lengths: [R]; the byte
    streams are coded on `device`."""
    R = len(lengths)
    if R == 0:
        w.put_byte(TS_EMPTY)
        return
    stream = np.ascontiguousarray(stream, np.uint8)
    lengths = np.ascontiguousarray(lengths, np.int64)
    if preserve_mask != 0xFFFFFFFFFFFFFFFF:
        stream, lengths = filter_fields(stream, lengths, preserve_mask)
    tt = tokenize(stream, lengths)
    if tt is None:
        w.put_byte(TS_RAW)
        pack_ints(w, lengths)
        _code_bytes(w, stream[: int(lengths.sum())], cap, device)
        return
    w.put_byte(TS_TOK)
    w.put_varint(tt.k)
    w.put_bytes(tt.seps.astype(np.uint8).tobytes())
    pack_ints(w, tt.exc_idx)
    Rm = len(tt.match_idx)
    text_parts: List[np.ndarray] = []
    text_lens: dict = {}
    text_field_ids: List[int] = []
    kinds, pads, vals = _classify(stream, tt, 18)
    for k in range(tt.k):
        start, tlen = tt.tok_start[:, k], tt.tok_len[:, k]
        if kinds[k] == KIND_CONST:
            w.put_byte(FS_CONST)
            w.put_varint(int(tlen[0]))
            w.put_bytes(stream[start[0]: start[0] + tlen[0]].tobytes())
            continue
        if kinds[k] == KIND_NUM:
            pad_width = int(pads[k])
            scheme, payload = _choose_numeric_scheme(vals[k])
            w.put_byte(scheme | (FS_PAD_FLAG if pad_width else 0))
            if pad_width:
                w.put_varint(pad_width)
            if scheme == FS_NUM_DELTA_CONST:
                w.put_svarint(payload[0])
                w.put_svarint(payload[1])
            elif scheme == FS_NUM_VALUE:
                pack_ints(w, payload[0])
            elif scheme == FS_NUM_DELTA:
                w.put_svarint(payload[0])
                pack_ints(w, payload[1])
            elif scheme == FS_NUM_RLE:
                pack_ints(w, payload[0])
                pack_ints(w, payload[1])
            elif scheme == FS_NUM_DELTA_RLE:
                w.put_svarint(payload[0])
                pack_ints(w, payload[1])
                pack_ints(w, payload[2])
            else:  # FS_NUM_DICT
                pack_ints(w, payload[0])
                pack_ints(w, payload[1])
            continue
        field = _extract_field(stream, start, tlen)
        pos = _field_positions(tlen)
        delta = _text_delta_fwd(field, tlen)
        if _pos_entropy_bits(delta.astype(np.int64), pos) \
                < _pos_entropy_bits(field.astype(np.int64), pos):
            w.put_byte(FS_TEXT_DELTA)
            payload_bytes = delta
        else:
            w.put_byte(FS_TEXT)
            payload_bytes = field
        pack_ints(w, tlen)
        text_parts.append(payload_bytes)
        text_lens[k] = tlen
        text_field_ids.append(k)
    text = np.concatenate(text_parts) if text_parts else np.zeros(0, np.uint8)
    ctx = _text_ctx(text_lens, text_field_ids)
    _code_text(w, text, ctx, cap, device)
    if len(tt.exc_idx):
        exc_lens = lengths[tt.exc_idx]
        pack_ints(w, exc_lens)
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(
            np.int64)
        exc_bytes = _extract_field(stream, starts[tt.exc_idx], exc_lens)
        _code_bytes(w, exc_bytes, cap, device)


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------

def _num_to_bytes(vals: np.ndarray, pad_width: int = 0):
    """Vectorized decimal rendering: returns (concat bytes, lens [R])."""
    v = np.asarray(vals, np.int64)
    strs = np.char.mod("%d", v)
    if pad_width:
        strs = np.char.zfill(strs, pad_width)
    lens = np.char.str_len(strs).astype(np.int64)
    maxw = int(lens.max()) if len(lens) else 1
    mat = strs.astype(f"S{maxw}").view(np.uint8).reshape(len(v), maxw)
    mask = np.arange(maxw)[None, :] < lens[:, None]
    return mat[mask], lens


def decode_tags(r: BitReader, num_rec: int, cap: int, device
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (concat title bytes, lengths [R]); the byte streams are
    decoded on `device`."""
    scheme = r.get_byte()
    if scheme == TS_EMPTY:
        return np.zeros(0, np.uint8), np.zeros(0, np.int64)
    if scheme == TS_RAW:
        lengths = unpack_ints(r)
        stream = _decode_bytes(r, cap, device)
        return stream, lengths
    k = r.get_varint()
    seps = np.frombuffer(r.get_bytes(k - 1), np.uint8) if k > 1 \
        else np.zeros(0, np.uint8)
    exc_idx = unpack_ints(r).astype(np.int64)
    R = num_rec - len(exc_idx)
    # per field: ("c", token bytes) | ("n", int64 values, pad width) |
    # ("t", lengths, vertical delta); a text field's bytes come after
    fields: List[tuple] = []
    text_lens: dict = {}
    text_fields: List[int] = []
    for fk in range(k):
        fs = r.get_byte()
        pad_width = 0
        if fs & FS_PAD_FLAG:
            fs &= ~FS_PAD_FLAG
            pad_width = r.get_varint()
        if fs == FS_CONST:
            ln = r.get_varint()
            fields.append(("c", np.frombuffer(r.get_bytes(ln), np.uint8)))
            continue
        if fs in (FS_TEXT, FS_TEXT_DELTA):
            tlens = unpack_ints(r)
            fields.append(("t", tlens, fs == FS_TEXT_DELTA))
            text_lens[fk] = tlens
            text_fields.append(fk)
            continue
        if fs == FS_NUM_DELTA_CONST:
            v0 = r.get_svarint()
            d = r.get_svarint()
            vals = v0 + d * np.arange(R, dtype=np.int64)
        elif fs == FS_NUM_VALUE:
            vals = unpack_ints(r)
        elif fs == FS_NUM_DELTA:
            v0 = r.get_svarint()
            diffs = unpack_ints(r)
            vals = np.concatenate([[v0], v0 + np.cumsum(diffs)]).astype(
                np.int64)
        elif fs == FS_NUM_RLE:
            rv = unpack_ints(r)
            rl = unpack_ints(r)
            vals = np.repeat(rv, rl)
        elif fs == FS_NUM_DELTA_RLE:
            v0 = r.get_svarint()
            dv = unpack_ints(r)
            dl = unpack_ints(r)
            diffs = np.repeat(dv, dl)
            vals = np.concatenate([[v0], v0 + np.cumsum(diffs)]).astype(
                np.int64)
        elif fs == FS_NUM_DICT:
            uniq = unpack_ints(r)
            idx = unpack_ints(r)
            vals = uniq[idx]
        else:
            raise DsrcException(f"bad tag field scheme {fs}")
        fields.append(("n", vals, pad_width))
    ctx = _text_ctx(text_lens, text_fields)
    text = _decode_text(r, ctx, cap, device)
    # split the shared text stream back into per-field chunks
    text_bytes = {}
    off = 0
    for fk in text_fields:
        lens = text_lens[fk]
        total = int(lens.sum())
        chunk = text[off: off + total]
        if fields[fk][2]:
            chunk = _text_delta_bwd(chunk.astype(np.int64),
                                    np.asarray(lens, np.int64))
        text_bytes[fk] = chunk
        off += total
    exc_lens = np.zeros(0, np.int64)
    exc_bytes = np.zeros(0, np.uint8)
    if len(exc_idx):
        exc_lens = unpack_ints(r).astype(np.int64)
        exc_bytes = _decode_bytes(r, cap, device)
    got = _render_tags_native(num_rec, R, seps, fields, text_bytes,
                              exc_idx, exc_lens, exc_bytes)
    if got is not None:
        return got
    return _render_tags_numpy(num_rec, R, seps, fields, text_bytes,
                              exc_idx, exc_lens, exc_bytes)


_MAX_PAD = 64      # a wider pad width (never written) renders with numpy


def _render_tags_native(num_rec, R, seps, fields, text_bytes, exc_idx,
                        exc_lens, exc_bytes):
    """decode_tags' titles from the library in one pass, or None for fields
    that do not fit their records, which only a malformed archive holds
    (_render_tags_numpy renders or rejects those as dsrc_tpu does)."""
    k = len(fields)
    if k < 1 or R < 0 or len(seps) < k - 1 or \
            len(exc_lens) != len(exc_idx) or (exc_lens < 0).any() or \
            len(exc_bytes) != int(exc_lens.sum()):
        return None
    kind = np.zeros(k, np.int32)
    arg = np.zeros(k, np.int64)
    data: List[Optional[np.ndarray]] = [None] * k
    ivec: List[Optional[np.ndarray]] = [None] * k
    bound = R * (k - 1) + len(exc_bytes)
    for fk, fld in enumerate(fields):
        if fld[0] == "c":
            data[fk] = np.ascontiguousarray(fld[1], np.uint8)
            arg[fk] = len(fld[1])
            bound += R * len(fld[1])
        elif fld[0] == "n":
            vals, pad = fld[1], fld[2]
            if len(vals) != R or pad > _MAX_PAD:
                return None
            kind[fk], arg[fk] = 1, pad
            ivec[fk] = np.ascontiguousarray(vals, np.int64)
            bound += R * max(pad, 20)
        else:
            lens, chunk = np.asarray(fld[1], np.int64), text_bytes[fk]
            if len(lens) != R or (lens < 0).any() or \
                    len(chunk) != int(lens.sum()):
                return None
            kind[fk] = 2
            data[fk] = np.ascontiguousarray(chunk, np.uint8)
            ivec[fk] = np.ascontiguousarray(lens)
            bound += len(chunk)
    return native.tag_render(num_rec, np.ascontiguousarray(seps, np.uint8),
                             kind, arg, data, ivec,
                             np.ascontiguousarray(exc_idx, np.int64),
                             np.ascontiguousarray(exc_lens, np.int64),
                             np.ascontiguousarray(exc_bytes, np.uint8),
                             bound)


def _render_tags_numpy(num_rec, R, seps, fields, text_bytes, exc_idx,
                       exc_lens, exc_bytes):
    """decode_tags' titles for what the library declines (a malformed
    archive's section), by numpy as dsrc_tpu renders them, or raising what
    dsrc_tpu raises: each field's bytes, scattered field by field, then the
    exception titles spliced in."""
    k = len(fields)
    field_bytes: List[np.ndarray] = []
    field_lens: List[np.ndarray] = []
    for fk, fld in enumerate(fields):
        if fld[0] == "c":
            field_bytes.append(np.tile(fld[1], R))
            field_lens.append(np.full(R, len(fld[1]), np.int64))
        elif fld[0] == "n":
            b, lens = _num_to_bytes(fld[1], fld[2])
            field_bytes.append(b)
            field_lens.append(lens)
        else:
            field_bytes.append(text_bytes[fk])
            field_lens.append(fld[1])
    # assemble matched titles: token_0 sep_0 ... sep_{K-2} token_{K-1}
    lens_mat = np.stack(field_lens, axis=1) if k else np.zeros((R, 0))
    title_lens = lens_mat.sum(1) + (k - 1)
    total_out = int(title_lens.sum())
    out = np.zeros(total_out, np.uint8)
    title_starts = np.concatenate([[0], np.cumsum(title_lens)[:-1]]).astype(
        np.int64)
    cum_k = title_starts.copy()                 # running dst offset per record
    for fk in range(k):
        content, lens = field_bytes[fk], field_lens[fk]
        total = int(lens.sum())
        if total:
            reps = np.repeat(np.arange(R, dtype=np.int64), lens)
            offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
            within = np.arange(total, dtype=np.int64) - offs[reps]
            out[cum_k[reps] + within] = content
        cum_k = cum_k + lens
        if fk < k - 1:
            out[cum_k] = seps[fk]
            cum_k = cum_k + 1
    if not len(exc_idx):
        return out, title_lens.astype(np.int64)
    # splice exception titles back at their record positions
    all_lens = np.zeros(num_rec, np.int64)
    is_exc = np.zeros(num_rec, bool)
    is_exc[exc_idx] = True
    all_lens[exc_idx] = exc_lens
    all_lens[~is_exc] = title_lens
    final = np.zeros(int(all_lens.sum()), np.uint8)
    fstarts = np.concatenate([[0], np.cumsum(all_lens)[:-1]]).astype(np.int64)
    def _splice(idx_rows, lens, content):
        total = int(lens.sum())
        if not total:
            return
        reps = np.repeat(np.arange(len(lens), dtype=np.int64), lens)
        offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
        within = np.arange(total, dtype=np.int64) - offs[reps]
        final[fstarts[idx_rows][reps] + within] = content
    _splice(np.flatnonzero(~is_exc), title_lens, out)
    _splice(exc_idx, exc_lens, exc_bytes)
    return final, all_lens
