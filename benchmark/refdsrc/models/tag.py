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
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import DsrcException
from ..ops import ctx as C
from ..ops.streams import (deserialize_rans, stream_tensors, to_numpy,
                           unpack_ints)
from ..utils.bitio import BitReader

SEPARATORS = b" ._,=:/-#"
_SEP_SET = np.zeros(256, bool)
for _c in SEPARATORS:
    _SEP_SET[_c] = True

MAX_FIELDS = 64          # beyond this -> raw (reference numbers fields to 64)

TS_EMPTY = 0
TS_RAW = 1

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


# --------------------------------------------------------------------------
# Per-field analysis
# --------------------------------------------------------------------------


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


_POW10 = 10 ** np.arange(10, dtype=np.int64)


def render_value_titles(vmat: np.ndarray, meta, num_rec: int):
    """Inverse of analyze_value_fields: (concatenated titles u8,
    lengths i64).  Vectorized digit extraction; exact by construction."""
    k, seps, fields = meta
    vmat = np.asarray(vmat, np.int64)[:num_rec]
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
    field_bytes: List[Optional[np.ndarray]] = []   # None => from text stream
    field_lens: List[np.ndarray] = []
    field_delta: List[bool] = []
    text_fields: List[int] = []
    for fk in range(k):
        fs = r.get_byte()
        pad_width = 0
        if fs & FS_PAD_FLAG:
            fs &= ~FS_PAD_FLAG
            pad_width = r.get_varint()
        if fs == FS_CONST:
            ln = r.get_varint()
            tok = np.frombuffer(r.get_bytes(ln), np.uint8)
            field_bytes.append(np.tile(tok, R))
            field_lens.append(np.full(R, ln, np.int64))
            field_delta.append(False)
        elif fs == FS_NUM_DELTA_CONST:
            v0 = r.get_svarint()
            d = r.get_svarint()
            vals = v0 + d * np.arange(R, dtype=np.int64)
            b, lens = _num_to_bytes(vals, pad_width)
            field_bytes.append(b)
            field_lens.append(lens)
            field_delta.append(False)
        elif fs == FS_NUM_VALUE:
            vals = unpack_ints(r)
            b, lens = _num_to_bytes(vals, pad_width)
            field_bytes.append(b)
            field_lens.append(lens)
            field_delta.append(False)
        elif fs == FS_NUM_DELTA:
            v0 = r.get_svarint()
            diffs = unpack_ints(r)
            vals = np.concatenate([[v0], v0 + np.cumsum(diffs)]).astype(
                np.int64)
            b, lens = _num_to_bytes(vals, pad_width)
            field_bytes.append(b)
            field_lens.append(lens)
            field_delta.append(False)
        elif fs == FS_NUM_RLE:
            rv = unpack_ints(r)
            rl = unpack_ints(r)
            vals = np.repeat(rv, rl)
            b, lens = _num_to_bytes(vals, pad_width)
            field_bytes.append(b)
            field_lens.append(lens)
            field_delta.append(False)
        elif fs == FS_NUM_DELTA_RLE:
            v0 = r.get_svarint()
            dv = unpack_ints(r)
            dl = unpack_ints(r)
            diffs = np.repeat(dv, dl)
            vals = np.concatenate([[v0], v0 + np.cumsum(diffs)]).astype(
                np.int64)
            b, lens = _num_to_bytes(vals, pad_width)
            field_bytes.append(b)
            field_lens.append(lens)
            field_delta.append(False)
        elif fs == FS_NUM_DICT:
            uniq = unpack_ints(r)
            idx = unpack_ints(r)
            vals = uniq[idx]
            b, lens = _num_to_bytes(vals, pad_width)
            field_bytes.append(b)
            field_lens.append(lens)
            field_delta.append(False)
        elif fs in (FS_TEXT, FS_TEXT_DELTA):
            tlens = unpack_ints(r)
            field_bytes.append(None)
            field_lens.append(tlens)
            field_delta.append(fs == FS_TEXT_DELTA)
            text_fields.append(fk)
        else:
            raise DsrcException(f"bad tag field scheme {fs}")
    ctx = _text_ctx(field_lens, text_fields)
    text = _decode_text(r, ctx, cap, device)
    # split the shared text stream back into per-field chunks
    off = 0
    for fk in text_fields:
        total = int(field_lens[fk].sum())
        chunk = text[off: off + total]
        if field_delta[fk]:
            chunk = _text_delta_bwd(chunk.astype(np.int64),
                                    np.asarray(field_lens[fk], np.int64))
        field_bytes[fk] = chunk
        off += total
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
    exc_lens = unpack_ints(r).astype(np.int64)
    exc_bytes = _decode_bytes(r, cap, device)
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
