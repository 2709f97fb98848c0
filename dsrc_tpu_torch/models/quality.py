"""Quality stream codec of the GENERIC block class (port of
dsrc_tpu/models/quality.py; byte-identical sections).

  scheme CONST : one distinct value: store it
  scheme POS   : every symbol's context is its read position (capped)
  scheme TRUNC : positional over the '#'-truncated prefix; the trailing run
                 is rebuilt from per-record truncated lengths
  scheme RLE   : run-length (sym, len <= 254), run symbols order-k coded,
                 lengths conditioned on their symbol
  scheme CTX   : order-k coding with coarse previous in-record symbols plus
                 a 16-bucket relative position (decode: K3 mode 2)

Scheme choice for order 0 follows the reference's ratio rules
(QualityModelerProxy.h:113-122); order >= 1 always uses CTX.  Every coded
stream goes through ops/ctx.py (K1 to encode, K3 to decode).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import DsrcException
from ..ops import ctx as C
from ..ops.ctx_kernels import MODE_QUALITY, CtxMode, coarse_ctx
from ..ops.rans import lane_active, lane_lengths, lane_merge, lane_split
from ..ops.rans_kernels import rans_encode_from_freqs
from ..ops.streams import (deserialize_rans, item, pack_ints, serialize_rans,
                           stream_tensors, to_numpy, unpack_ints)
from ..ops.transform import (compact, expand_positions, histogram, pad_to,
                             segment_max, take_clip)
from ..utils.bitio import BitReader, BitWriter

QS_EMPTY = 0
QS_CONST = 1
QS_POS = 2
QS_TRUNC = 3
QS_RLE = 4
QS_CTX = 5

POS_CTX_CAP = 256      # positional context ids are min(pos, cap-1)
POS_BUCKETS = 16       # relative-position buckets for CTX scheme
MAX_RUN = 254          # reference's run-length cap (QualityRLEModeler)
A_BUCKETS = (2, 4, 8, 16, 32, 64, 128, 256)


def _a_pad(distinct: int) -> int:
    for a in A_BUCKETS:
        if distinct <= a:
            return a
    return 256


def _qbits(a_pad: int) -> int:
    return max(1, (a_pad - 1).bit_length())


def _pow2ceil(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length()) if n > 1 else 1


def _coarse_bits(order: int, qbits: int, n_hint: int):
    """Per-lag context bits for the CTX scheme, nearest lag finest; bounded
    by the sampling budget (bins <= n/8) and 2^18 bins.  A lag may be wider
    than qbits (orders 3 and 6 at qbits <= 2): it then adds zero bits."""
    budget = max(0, int(n_hint).bit_length() - 1 - 3 - 4 - qbits)
    hb = min(order * qbits, 18 - 4 - qbits, budget)
    lags = []
    want = (qbits, 3, 2, 2)             # finest first
    for k in range(min(order, 4)):
        c = min(want[k], hb - sum(lags))
        if c <= 0:
            break
        lags.append(c)
    return tuple(lags)


def _pos_params(a_pad: int, n_hint: int):
    shift = 0
    while shift < 8 and (POS_CTX_CAP >> shift) * a_pad > max(n_hint // 4,
                                                             1024):
        shift += 1
    return shift, POS_CTX_CAP >> shift


# --------------------------------------------------------------------------
# Stream layout from record lengths (shared by encoder and decoder)
# --------------------------------------------------------------------------
# Stream positions and record numbers are int32: a block's capacity is
# below 2^31 (models/block.BlockShape), and so is any sum of its lengths.

def stream_layout(lengths: torch.Tensor, cap: int, need_rec: bool = True):
    """lengths [R] -> (rec_of [cap] or None, pos_of [cap]) int32 for the
    concatenated stream; past the total the values are clipped (mask
    separately).  Computed a quarter of the stream at a time."""
    lens = lengths.to(torch.int32)
    cum = torch.cumsum(lens, 0, dtype=torch.int32)
    starts = cum - lens
    pos_of = torch.arange(cap, dtype=torch.int32, device=lengths.device)
    rec_of = torch.empty_like(pos_of) if need_rec else None
    step = max(1, -(-cap // 4))
    for a in range(0, cap, step):
        pos = pos_of[a:a + step]
        rec = torch.searchsorted(cum, pos, right=True, out_int32=True) \
            .clamp_(max=lengths.shape[0] - 1)
        pos.sub_(torch.index_select(starts, 0, rec))
        if need_rec:
            rec_of[a:a + step] = rec
        del rec
    return rec_of, pos_of


def quality_hist(qvals: torch.Tensor, n: int) -> torch.Tensor:
    """Value histogram [256] (int64) of the first n quality values."""
    return histogram(qvals[:n], 256)


def quality_stats(qvals: torch.Tensor, n: int, lengths: torch.Tensor,
                  num_rec: int, hash_val: int, rcap: int):
    """(value histogram [256], run count (int), truncated length per
    record [rcap] int32): the order-0 scheme choice's inputs."""
    q = qvals[:n]
    rec_of, pos_of = stream_layout(lengths, n)
    last = (pos_of + 1).masked_fill_(q == hash_val, 0)
    tl = segment_max(last, rec_of, rcap)
    del last, rec_of
    tl.masked_fill_(torch.arange(rcap, dtype=torch.int32,
                                 device=qvals.device) >= num_rec, 0)
    new_run = pos_of == 0
    new_run[1:] |= q[1:] != q[:-1]
    return quality_hist(qvals, n), item(new_run.sum()), tl


# --------------------------------------------------------------------------
# Precomputed-context codec (POS / TRUNC / RLE substreams)
# --------------------------------------------------------------------------

def _encode_ctxarr(dense: torch.Tensor, n: int, ctx: torch.Tensor,
                   num_ctx: int, nsym: int, num_lanes: int,
                   edges: Tuple[int, ...]):
    lanes = lane_split(dense, num_lanes)
    t_steps = lanes.shape[0]
    active = lane_active(t_steps, lane_lengths(n, num_lanes, t_steps,
                                                dense.device))
    payload, nwords, states = C.encode_ctx_lanes(
        lanes, active, lane_split(ctx, num_lanes), num_ctx, nsym, edges)
    return dict(payload=payload, nwords=nwords, states=states)


def _decode_ctxarr(payload, states, n: int, ctx: torch.Tensor, t_steps: int,
                   num_ctx: int, nsym: int, num_lanes: int,
                   edges: Tuple[int, ...]) -> torch.Tensor:
    syms = C.decode_ctx_precomputed(
        payload, states, lane_lengths(n, num_lanes, t_steps, payload.device),
        t_steps, num_ctx, nsym, edges, lane_split(ctx, num_lanes))
    return lane_merge(syms, t_steps * num_lanes)


# --------------------------------------------------------------------------
# CTX scheme: coarse in-record history + relative-position bucket
# --------------------------------------------------------------------------

def _ctx_params(order: int, a_pad: int, n_hint: int):
    qbits = _qbits(a_pad)
    lags = _coarse_bits(order, qbits, n_hint)
    hb = sum(lags)
    return qbits, hb, lags, (1 << hb) * POS_BUCKETS


def _bucket(pos: torch.Tensor, rlen: torch.Tensor) -> torch.Tensor:
    """min(pos * 16 // max(rlen, 1), 15), uint8; pos (consumed) and rlen
    int32.  pos is clipped to rlen first, which leaves every bucket as it
    was; the product is int32 while the longest record allows it."""
    rlen = rlen.clamp_(min=1)
    pos = torch.minimum(pos, rlen, out=pos)
    if item(rlen.max()) * POS_BUCKETS >= 2**31:
        pos, rlen = pos.to(torch.int64), rlen.to(torch.int64)
    pos.mul_(POS_BUCKETS).div_(rlen, rounding_mode="floor")
    return pos.clamp_(max=POS_BUCKETS - 1).to(torch.uint8)


def ctxq_model(lengths: torch.Tensor, cap: int, order: int, a_pad: int,
               num_lanes: int, n_hint: int):
    """The CTX scheme's model of a stream of `cap` steps: (num_ctx, the
    decoder's CtxMode, reset [T, L] bool: a step starts a record, bucket
    [T, L] uint8: its relative-position bucket)."""
    qbits, hb, lags, num_ctx = _ctx_params(order, a_pad, n_hint)
    # the packed history (len(lags) symbols of qbits), the context and
    # ctx * A + sym stay far inside int32
    if len(lags) * qbits > 30 or num_ctx * a_pad >= 2**31:
        raise DsrcException(f"quality context of {len(lags)} x {qbits} "
                            f"bits, {num_ctx} x {a_pad} bins: too wide")
    rec_of, pos_of = stream_layout(lengths, cap)
    rlen = take_clip(lengths.to(torch.int32), rec_of)
    del rec_of
    mode = CtxMode(MODE_QUALITY, sbits=qbits,
                   cmask=(1 << (len(lags) * qbits)) - 1 if lags else 0,
                   hb=hb, lags=lags)
    reset = lane_split(pos_of == 0, num_lanes)   # _bucket consumes pos_of
    return (num_ctx, mode, reset,
            lane_split(_bucket(pos_of, rlen), num_lanes))


def ctxq_history(lanes: torch.Tensor, reset: torch.Tensor, qbits: int,
                 nlags: int) -> torch.Tensor:
    """Bulk form of the reference's history scan (quality.py:240-247): the
    exact-history carry h[t] of each step of [T, L] lanes packs s[t-i] at
    bits (i-1)*qbits for i = 1..nlags, where t-i >= 0 and no record starts
    in (t-i, t] (a reset at t itself empties h[t]).  int32, computed
    lane-major (the result is the transpose of a contiguous [L, T])."""
    t_steps = lanes.shape[0]
    s = lanes.T
    cr = reset.T.to(torch.int32).cumsum_(1)
    h = torch.zeros(s.shape, dtype=torch.int32, device=s.device)
    for i in range(1, min(nlags, t_steps - 1) + 1):
        part = s[:, :-i].to(torch.int32) << ((i - 1) * qbits)
        h[:, i:] |= part.masked_fill_(cr[:, i:] != cr[:, :-i], 0)
        del part
    return h.T


def ctxq_contexts(lanes: torch.Tensor, reset: torch.Tensor,
                  bucket: torch.Tensor, mode: CtxMode) -> torch.Tensor:
    """The encoder's [T, L] context ids: coarse history | bucket << hb
    (int32)."""
    hist = ctxq_history(lanes, reset, mode.sbits, len(mode.lags))
    ctx = coarse_ctx(hist, mode.sbits, mode.lags)
    del hist
    return ctx.bitwise_or_(bucket.to(torch.int32) << mode.hb)


def ctxq_aux(reset: torch.Tensor, bucket: torch.Tensor) -> torch.Tensor:
    """K3's per-step input in the quality mode, lane-major [L, T] int32:
    bucket << 1 | record start."""
    aux = bucket.T.to(torch.int32, memory_format=torch.contiguous_format)
    return aux.bitwise_left_shift_(1).bitwise_or_(reset.T)


def _encode_ctxq(dense: torch.Tensor, n: int, lengths: torch.Tensor,
                 cap: int, order: int, a_pad: int, num_lanes: int,
                 edges: Tuple[int, ...], n_hint: int):
    num_ctx, mode, reset, bucket = ctxq_model(lengths, cap, order, a_pad,
                                              num_lanes, n_hint)
    lanes = lane_split(dense, num_lanes)
    t_steps = lanes.shape[0]
    active = lane_active(t_steps, lane_lengths(n, num_lanes, t_steps,
                                                dense.device))
    ctx = ctxq_contexts(lanes, reset, bucket, mode)
    del reset, bucket
    freq, cum = C.ctx_models(lanes, active, ctx, num_ctx, a_pad, edges)
    del ctx
    payload, nwords, states = rans_encode_from_freqs(freq, cum,
                                                     active.contiguous())
    return dict(payload=payload, nwords=nwords, states=states)


def _decode_ctxq(payload, states, n: int, lengths: torch.Tensor, cap: int,
                 t_steps: int, order: int, a_pad: int, num_lanes: int,
                 edges: Tuple[int, ...], n_hint: int) -> torch.Tensor:
    num_ctx, mode, reset, bucket = ctxq_model(lengths, cap, order, a_pad,
                                              num_lanes, n_hint)
    aux = ctxq_aux(reset, bucket)
    del reset, bucket
    syms = C.decode_ctx_lanes(
        payload, states, lane_lengths(n, num_lanes, t_steps,
                                       payload.device),
        t_steps, num_ctx, a_pad, edges, mode, aux=aux)
    return lane_merge(syms, t_steps * num_lanes)


def _rle_sym_order(a_pad: int, nr_hint: int) -> int:
    return 1 if nr_hint >= 4 * a_pad * a_pad else 0


# --------------------------------------------------------------------------
# RLE scheme helpers: runs with the MAX_RUN cap, and expansion
# --------------------------------------------------------------------------

def _make_runs(qvals: torch.Tensor, n: int, lengths: torch.Tensor):
    """Record-segmented runs of the first n values, capped at MAX_RUN.
    Returns (run_syms [n_runs], run_len_syms [n_runs] in [0, MAX_RUN),
    both int32)."""
    q = qvals[:n]
    _, pos_of = stream_layout(lengths, n, need_rec=False)
    new_raw = pos_of == 0
    del pos_of
    new_raw[1:] |= q[1:] != q[:-1]
    # a position's offset in its raw run: its index less the run's start
    raw_start = torch.nonzero(new_raw).view(-1).to(torch.int32)
    raw_id = new_raw.to(torch.int32).cumsum_(0).sub_(1)
    in_run = torch.arange(n, dtype=torch.int32, device=q.device) \
        .sub_(take_clip(raw_start, raw_id))
    del raw_start, raw_id
    new_raw |= torch.remainder(in_run, MAX_RUN, out=in_run) == 0
    del in_run
    starts = torch.nonzero(new_raw).view(-1)
    del new_raw
    run_syms = torch.index_select(q, 0, starts).to(torch.int32)
    ends = torch.empty_like(starts)
    ends[:-1] = starts[1:]
    ends[-1:] = n
    return run_syms, ends.sub_(starts).sub_(1).to(torch.int32)


def _expand_runs(run_syms: torch.Tensor, run_lens: torch.Tensor,
                 n_runs: int, cap: int):
    """Inverse of _make_runs: ([>= n_runs] syms, [>= n_runs] len-1 syms)
    -> (stream [min(total, cap)], total)."""
    lens = run_lens[:n_runs].to(torch.int32).add_(1)
    cum = torch.cumsum(lens, 0, dtype=torch.int32)
    total = item(cum[-1]) if n_runs else 0
    j = torch.arange(min(total, cap), dtype=torch.int32,
                     device=run_syms.device)
    rid = torch.searchsorted(cum, j, right=True, out_int32=True)
    return take_clip(run_syms, rid), total


# --------------------------------------------------------------------------
# Truncation helpers
# --------------------------------------------------------------------------

def _trunc_keep(lengths, trunc, n: int) -> torch.Tensor:
    """[n] bool: a position lies inside its record's truncated length."""
    rec_of, pos_of = stream_layout(lengths, n)
    return pos_of < take_clip(trunc.to(torch.int32), rec_of)


def _truncate_stream(qvals, n: int, lengths, trunc, cap: int):
    return compact(qvals[:n], _trunc_keep(lengths, trunc, n), cap)


def _untruncate_stream(tstream, lengths, trunc, n: int,
                       hash_val: int) -> torch.Tensor:
    """[n]: the kept values in place, hash_val in the truncated tails."""
    keep = _trunc_keep(lengths, trunc, n)
    out = take_clip(tstream, expand_positions(keep))
    return out.masked_fill_(~keep, hash_val)


# --------------------------------------------------------------------------
# Top-level quality section codec
# --------------------------------------------------------------------------

def _pos_ctx(lengths: torch.Tensor, cap: int, shift: int = 0,
             dtype=torch.int32):
    """Positional contexts min(pos, 255) >> shift: int32 for K3's aux,
    uint8 for the encoder."""
    _, pos_of = stream_layout(lengths, cap, need_rec=False)
    return pos_of.clamp_(max=POS_CTX_CAP - 1).bitwise_right_shift_(shift) \
        .to(dtype)


def _geom(cap: int, n: int):
    """Stream-sized lane geometry: (nc, num_lanes, edges)."""
    nc = C.stream_cap(cap, n)
    num_lanes = C.pick_num_lanes(nc)
    return nc, num_lanes, C.band_edges(nc // num_lanes)


def _put(w: BitWriter, n: int, enc: dict) -> None:
    serialize_rans(w, n, enc["payload"], enc["nwords"], enc["states"])


def encode_quality(w: BitWriter, qvals: torch.Tensor, n: int,
                   lengths: torch.Tensor, num_rec: int, order: int,
                   hash_val: int) -> str:
    """qvals: [cap] post-transform values in [0,256), zero past n.
    lengths: [rcap] per-record quality lengths.  hash_val: '#' after offset
    subtraction (-1 when truncation does not apply).  Returns the name of
    the scheme written."""
    cap = qvals.shape[0]
    rcap = lengths.shape[0]
    if n == 0:
        w.put_byte(QS_EMPTY)
        return "EMPTY"
    if order >= 1:
        hist = quality_hist(qvals, n)
    else:
        hist, nr, trunc = quality_stats(qvals, n, lengths, num_rec,
                                        hash_val, rcap)
    hist = to_numpy(hist)
    present = np.flatnonzero(hist)
    if len(present) == 1:
        w.put_byte(QS_CONST)
        w.put_varint(n)
        w.put_byte(int(present[0]))
        return "CONST"
    a_pad = _a_pad(len(present))
    lut = np.zeros(256, np.uint8)
    lut[present] = np.arange(len(present))
    dense = torch.zeros(cap, dtype=torch.uint8, device=qvals.device)
    torch.index_select(torch.from_numpy(lut).to(qvals.device), 0,
                       qvals[:n].to(torch.int32).clamp_(0, 255),
                       out=dense[:n])
    if order >= 1:
        scheme = QS_CTX
    else:
        th_total = item(trunc.sum())
        if nr and th_total / max(2 * nr, 1) > 1.25:
            scheme = QS_RLE
        elif th_total and n / th_total > 1.10 and 0 <= hash_val < 256:
            scheme = QS_TRUNC
        else:
            scheme = QS_POS
    w.put_byte(scheme)
    w.put_bytes(np.packbits(hist > 0).tobytes())  # 32-byte presence bitmap

    if scheme == QS_POS:
        nc, num_lanes, edges = _geom(cap, n)
        shift, pctx = _pos_params(a_pad, _pow2ceil(n))
        ctx = _pos_ctx(lengths, nc, shift, torch.uint8)
        _put(w, n, _encode_ctxarr(dense[:nc], n, ctx, pctx, a_pad,
                                  num_lanes, edges))
        return "POS"
    if scheme == QS_TRUNC:
        pack_ints(w, to_numpy(trunc)[:num_rec])
        tstream, t_total = _truncate_stream(dense, n, lengths, trunc, cap)
        del dense
        nc, num_lanes, edges = _geom(cap, t_total)
        shift, pctx = _pos_params(a_pad, _pow2ceil(t_total))
        ctx = _pos_ctx(trunc, nc, shift, torch.uint8)
        _put(w, t_total, _encode_ctxarr(tstream[:nc], t_total, ctx, pctx,
                                        a_pad, num_lanes, edges))
        return "TRUNC"
    if scheme == QS_RLE:
        run_syms, run_lens = _make_runs(dense, n, lengths)
        del dense
        nr = run_syms.shape[0]
        nc, num_lanes, edges = _geom(cap, nr)
        run_syms, run_lens = pad_to(run_syms, nc), pad_to(run_lens, nc)
        sym_order = _rle_sym_order(a_pad, _pow2ceil(nr))
        _put(w, nr, C.encode_orderk(run_syms, nr, sym_order, _qbits(a_pad),
                                    a_pad, num_lanes, edges))
        _put(w, nr, _encode_ctxarr(run_lens, nr, run_syms, a_pad,
                                   MAX_RUN + 1, num_lanes, edges))
        return "RLE"
    nc, num_lanes, edges = _geom(cap, n)
    _put(w, n, _encode_ctxq(dense[:nc], n, lengths, nc, order, a_pad,
                            num_lanes, edges, _pow2ceil(n)))
    return "CTX"


def _stream(r: BitReader, geom_of, device):
    """One coded stream -> (n, geometry (nc, num_lanes, edges) that
    geom_of(n) gives, payload and states on device)."""
    n, payload, states, _ = deserialize_rans(r)
    geom = geom_of(n)
    return (n, geom) + stream_tensors(payload, states, geom[1], device)


def decode_quality(r: BitReader, cap: int, lengths: torch.Tensor,
                   num_rec: int, order: int, hash_val: int
                   ) -> Tuple[torch.Tensor, int]:
    """Returns ([cap] int16 values in [0,256), zero past n; n)."""
    dev = lengths.device
    qvals = torch.zeros(cap, dtype=torch.int16, device=dev)
    scheme = r.get_byte()
    if scheme == QS_EMPTY:
        return qvals, 0
    if scheme == QS_CONST:
        n = r.get_varint()
        qvals[:n] = r.get_byte()
        return qvals, n
    bitmap = np.frombuffer(r.get_bytes(32), np.uint8)
    present = np.flatnonzero(np.unpackbits(bitmap))
    a_pad = _a_pad(len(present))
    inv = np.zeros(a_pad, np.int16)
    inv[: len(present)] = present[:a_pad]

    def geom(n):
        return _geom(cap, n)

    # dense: the decoded symbols, at least n of them
    if scheme == QS_POS:
        n, (nc, num_lanes, edges), pl, st = _stream(r, geom, dev)
        shift, pctx = _pos_params(a_pad, _pow2ceil(n))
        dense = _decode_ctxarr(pl, st, n, _pos_ctx(lengths, nc, shift),
                               nc // num_lanes, pctx, a_pad, num_lanes,
                               edges)
    elif scheme == QS_TRUNC:
        trunc_np = unpack_ints(r)
        rcap = lengths.shape[0]
        trunc = torch.from_numpy(np.pad(
            trunc_np, (0, rcap - len(trunc_np))).astype(np.int32)).to(dev)
        t_total, (nc, num_lanes, edges), pl, st = _stream(r, geom, dev)
        shift, pctx = _pos_params(a_pad, _pow2ceil(t_total))
        tdense = _decode_ctxarr(pl, st, t_total, _pos_ctx(trunc, nc, shift),
                                nc // num_lanes, pctx, a_pad, num_lanes,
                                edges)
        lut = np.zeros(256, np.int32)
        lut[present] = np.arange(len(present))
        hash_dense = int(lut[hash_val]) if 0 <= hash_val < 256 else 0
        n = item(lengths[:num_rec].sum())
        dense = _untruncate_stream(tdense[:nc], lengths, trunc, n,
                                   hash_dense)
        del tdense
    elif scheme == QS_RLE:
        nr, (nc, num_lanes, edges), pl, st = _stream(r, geom, dev)
        t_steps = nc // num_lanes
        run_syms = C.decode_orderk(pl, st, nr, t_steps,
                                   _rle_sym_order(a_pad, _pow2ceil(nr)),
                                   _qbits(a_pad), a_pad, num_lanes,
                                   edges)[:nc]
        run_syms = run_syms.masked_fill(
            torch.arange(nc, dtype=torch.int32, device=dev) >= nr, 0)
        nr2, _, pl2, st2 = _stream(r, lambda _n: (nc, num_lanes, edges), dev)
        run_lens = _decode_ctxarr(pl2, st2, nr2, run_syms, t_steps, a_pad,
                                  MAX_RUN + 1, num_lanes, edges)
        dense, n = _expand_runs(run_syms, run_lens, nr, cap)
        del run_syms, run_lens
    else:  # QS_CTX
        n, (nc, num_lanes, edges), pl, st = _stream(r, geom, dev)
        dense = _decode_ctxq(pl, st, n, lengths, nc, nc // num_lanes,
                             order, a_pad, num_lanes, edges, _pow2ceil(n))
    m = min(n, cap)
    torch.index_select(torch.from_numpy(inv).to(dev), 0,
                       dense[:m].clamp_(0, a_pad - 1), out=qvals[:m])
    return qvals, int(item(n))
