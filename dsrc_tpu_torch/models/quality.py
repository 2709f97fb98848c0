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

from ..ops import ctx as C
from ..ops.ctx_kernels import MODE_QUALITY, CtxMode, coarse_ctx
from ..ops.rans import lane_active, lane_lengths, lane_merge, lane_split
from ..ops.streams import (deserialize_rans, pack_ints, serialize_rans,
                           stream_tensors, to_numpy, unpack_ints)
from ..ops.transform import (compact, expand_positions, histogram,
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

def stream_layout(lengths: torch.Tensor, cap: int):
    """lengths [R] -> (rec_of [cap], pos_of [cap]) int64 for the
    concatenated stream; past the total the values are clipped (mask
    separately)."""
    lens = lengths.to(torch.int64)
    cum = torch.cumsum(lens, 0)
    starts = cum - lens
    idx = torch.arange(cap, dtype=torch.int64, device=lengths.device)
    rec_c = torch.clamp(torch.searchsorted(cum, idx, right=True),
                        max=lengths.shape[0] - 1)
    return rec_c, idx - take_clip(starts, rec_c)


def quality_stats(qvals: torch.Tensor, n: int, lengths: torch.Tensor,
                  num_rec: int, hash_val: int, cap: int, rcap: int):
    """(value histogram [256], run count (0-dim), truncated length per
    record [rcap])."""
    active = torch.arange(cap, device=qvals.device) < n
    hist = histogram(qvals, 256, active)
    rec_of, pos_of = stream_layout(lengths, cap)
    is_real = (qvals != hash_val) & active
    tl = segment_max(torch.where(is_real, pos_of + 1, 0), rec_of, rcap)
    tl = torch.where(torch.arange(rcap, device=qvals.device) < num_rec, tl, 0)
    prev = torch.cat([qvals[:1] + 1, qvals[:-1]])
    new_run = ((qvals != prev) | (pos_of == 0)) & active
    return hist, new_run.sum(), tl


# --------------------------------------------------------------------------
# Precomputed-context codec (POS / TRUNC / RLE substreams)
# --------------------------------------------------------------------------

def _encode_ctxarr(dense: torch.Tensor, n: int, ctx: torch.Tensor,
                   num_ctx: int, nsym: int, num_lanes: int,
                   edges: Tuple[int, ...]):
    lanes = lane_split(dense.to(torch.int32), num_lanes)
    ctxl = lane_split(ctx.to(torch.int32), num_lanes)
    t_steps = lanes.shape[0]
    active = lane_active(t_steps, lane_lengths(n, num_lanes, t_steps,
                                                dense.device))
    payload, nwords, states = C.encode_ctx_lanes(
        torch.where(active, lanes, 0), active, torch.where(active, ctxl, 0),
        num_ctx, nsym, edges)
    return dict(payload=payload, nwords=nwords, states=states)


def _decode_ctxarr(payload, states, n: int, ctx: torch.Tensor, t_steps: int,
                   num_ctx: int, nsym: int, num_lanes: int,
                   edges: Tuple[int, ...]) -> torch.Tensor:
    lengths = lane_lengths(n, num_lanes, t_steps, payload.device)
    ctxl = lane_split(ctx.to(torch.int32), num_lanes)
    active = lane_active(t_steps, lengths)
    syms = C.decode_ctx_precomputed(payload, states, lengths, t_steps,
                                    num_ctx, nsym, edges,
                                    torch.where(active, ctxl, 0))
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
    return torch.clamp(torch.div(pos * POS_BUCKETS, torch.clamp(rlen, min=1),
                                 rounding_mode="floor"), max=POS_BUCKETS - 1)


def ctxq_model(lengths: torch.Tensor, cap: int, order: int, a_pad: int,
               num_lanes: int, n_hint: int):
    """The CTX scheme's model of a stream of `cap` steps: (num_ctx, the
    decoder's CtxMode, reset [T, L] bool: a step starts a record, bucket
    [T, L] int64: its relative-position bucket)."""
    qbits, hb, lags, num_ctx = _ctx_params(order, a_pad, n_hint)
    rec_of, pos_of = stream_layout(lengths, cap)
    rlen = take_clip(lengths.to(torch.int64), rec_of)
    mode = CtxMode(MODE_QUALITY, sbits=qbits,
                   cmask=(1 << (len(lags) * qbits)) - 1 if lags else 0,
                   hb=hb, lags=lags)
    return (num_ctx, mode, lane_split(pos_of == 0, num_lanes),
            lane_split(_bucket(pos_of, rlen), num_lanes))


def ctxq_history(lanes: torch.Tensor, reset: torch.Tensor, qbits: int,
                 nlags: int) -> torch.Tensor:
    """Bulk form of the reference's history scan (quality.py:240-247): the
    exact-history carry h[t] of each step of [T, L] lanes packs s[t-i] at
    bits (i-1)*qbits for i = 1..nlags, where t-i >= 0 and no record starts
    in (t-i, t] (a reset at t itself empties h[t])."""
    t_steps = lanes.shape[0]
    s = lanes.T.to(torch.int64)                  # lane-major [L, T]
    cr = torch.cumsum(reset.T.to(torch.int64), 1)
    h = torch.zeros_like(s)
    for i in range(1, nlags + 1):
        if i >= t_steps:
            break
        ok = cr[:, i:] == cr[:, :-i]
        h[:, i:] |= torch.where(ok, s[:, :-i] << ((i - 1) * qbits), 0)
    return h.T


def ctxq_contexts(lanes: torch.Tensor, reset: torch.Tensor,
                  bucket: torch.Tensor, mode: CtxMode) -> torch.Tensor:
    """The encoder's [T, L] context ids: coarse history | bucket << hb."""
    hist = ctxq_history(lanes, reset, mode.sbits, len(mode.lags))
    return coarse_ctx(hist, mode.sbits, mode.lags) | (bucket << mode.hb)


def ctxq_aux(reset: torch.Tensor, bucket: torch.Tensor) -> torch.Tensor:
    """K3's per-step input in the quality mode, lane-major [L, T]:
    bucket << 1 | record start."""
    return ((bucket << 1) | reset.to(torch.int64)).T


def _encode_ctxq(dense: torch.Tensor, n: int, lengths: torch.Tensor,
                 cap: int, order: int, a_pad: int, num_lanes: int,
                 edges: Tuple[int, ...], n_hint: int):
    num_ctx, mode, reset, bucket = ctxq_model(lengths, cap, order, a_pad,
                                              num_lanes, n_hint)
    lanes = lane_split(dense.to(torch.int64), num_lanes)
    t_steps = lanes.shape[0]
    active = lane_active(t_steps, lane_lengths(n, num_lanes, t_steps,
                                                dense.device))
    lanes = torch.where(active, lanes, 0)
    ctx = ctxq_contexts(lanes, reset, bucket, mode)
    payload, nwords, states = C.encode_ctx_lanes(
        lanes, active, torch.where(active, ctx, 0), num_ctx, a_pad, edges)
    return dict(payload=payload, nwords=nwords, states=states)


def _decode_ctxq(payload, states, n: int, lengths: torch.Tensor, cap: int,
                 t_steps: int, order: int, a_pad: int, num_lanes: int,
                 edges: Tuple[int, ...], n_hint: int) -> torch.Tensor:
    num_ctx, mode, reset, bucket = ctxq_model(lengths, cap, order, a_pad,
                                              num_lanes, n_hint)
    syms = C.decode_ctx_lanes(
        payload, states, lane_lengths(n, num_lanes, t_steps,
                                       payload.device),
        t_steps, num_ctx, a_pad, edges, mode, aux=ctxq_aux(reset, bucket))
    return lane_merge(syms, t_steps * num_lanes)


def _rle_sym_order(a_pad: int, nr_hint: int) -> int:
    return 1 if nr_hint >= 4 * a_pad * a_pad else 0


# --------------------------------------------------------------------------
# RLE scheme helpers: runs with the MAX_RUN cap, and expansion
# --------------------------------------------------------------------------

def _scatter(cap: int, idx: torch.Tensor, src: torch.Tensor,
             add: bool) -> torch.Tensor:
    """[cap] int32 zeros with src set (or added) at idx; idx == cap drops."""
    out = torch.zeros(cap + 1, dtype=torch.int32, device=src.device)
    if add:
        out.scatter_add_(0, idx, src.to(torch.int32))
    else:
        out.scatter_(0, idx, src.to(torch.int32))
    return out[:cap]


def _make_runs(qvals: torch.Tensor, n: int, lengths: torch.Tensor,
               cap: int):
    """Record-segmented runs capped at MAX_RUN.  Returns (run_syms [cap],
    run_len_syms [cap] in [0, MAX_RUN), n_runs)."""
    dev = qvals.device
    idx = torch.arange(cap, dtype=torch.int64, device=dev)
    active = idx < n
    _, pos_of = stream_layout(lengths, cap)
    prev = torch.cat([qvals[:1] + 1, qvals[:-1]])
    new_raw = ((qvals != prev) | (pos_of == 0)) & active
    raw_id = torch.cumsum(new_raw.to(torch.int64), 0) - 1
    starts = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    starts.scatter_reduce_(0, torch.clamp(raw_id, min=0),
                           torch.where(new_raw, idx, 0), reduce="amax",
                           include_self=True)
    in_run = idx - take_clip(starts[:cap], raw_id)
    new_run = (new_raw | (torch.remainder(in_run, MAX_RUN) == 0)) & active
    rid = torch.cumsum(new_run.to(torch.int64), 0) - 1
    run_syms = _scatter(cap, torch.where(new_run, rid, cap), qvals, False)
    rlen = _scatter(cap, torch.where(active, rid, cap),
                    torch.ones_like(rid), True)
    return run_syms, torch.clamp(rlen - 1, min=0), int(new_run.sum())


def _expand_runs(run_syms: torch.Tensor, run_lens: torch.Tensor,
                 n_runs: int, cap: int):
    """Inverse of _make_runs: ([cap] syms, [cap] len-1 syms) -> ([cap]
    stream, total)."""
    idx = torch.arange(cap, dtype=torch.int64, device=run_syms.device)
    lens = torch.where(idx < n_runs, run_lens.to(torch.int64) + 1, 0)
    cum = torch.cumsum(lens, 0)
    rid = torch.searchsorted(cum, idx, right=True)
    total = int(cum[-1]) if cap else 0
    return torch.where(idx < total, take_clip(run_syms, rid), 0), total


# --------------------------------------------------------------------------
# Truncation helpers
# --------------------------------------------------------------------------

def _trunc_keep(lengths, trunc, n: int, cap: int):
    active = torch.arange(cap, device=lengths.device) < n
    rec_of, pos_of = stream_layout(lengths, cap)
    return active, active & (pos_of < take_clip(trunc.to(torch.int64),
                                                rec_of))


def _truncate_stream(qvals, n: int, lengths, trunc, cap: int):
    _, keep = _trunc_keep(lengths, trunc, n, cap)
    packed, total = compact(qvals, keep)
    return packed, int(total)


def _untruncate_stream(tstream, lengths, trunc, n: int, hash_val: int,
                       cap: int) -> torch.Tensor:
    active, keep = _trunc_keep(lengths, trunc, n, cap)
    out = torch.where(keep, take_clip(tstream, expand_positions(keep)),
                      hash_val)
    return torch.where(active, out, 0)


# --------------------------------------------------------------------------
# Top-level quality section codec
# --------------------------------------------------------------------------

def _pos_ctx(lengths: torch.Tensor, cap: int, shift: int = 0):
    _, pos_of = stream_layout(lengths, cap)
    return torch.clamp(pos_of, max=POS_CTX_CAP - 1) >> shift


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
    hist, n_runs, trunc = quality_stats(qvals, n, lengths, num_rec,
                                        hash_val, cap, rcap)
    hist = to_numpy(hist)
    present = np.flatnonzero(hist)
    if len(present) == 1:
        w.put_byte(QS_CONST)
        w.put_varint(n)
        w.put_byte(int(present[0]))
        return "CONST"
    a_pad = _a_pad(len(present))
    lut = np.zeros(256, np.int32)
    lut[present] = np.arange(len(present))
    dense = torch.from_numpy(lut).to(qvals.device)[
        torch.clamp(qvals.to(torch.int64), 0, 255)]
    if order >= 1:
        scheme = QS_CTX
    else:
        th_total = int(trunc.sum())
        nr = int(n_runs)
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
        ctx = _pos_ctx(lengths, cap, shift)
        _put(w, n, _encode_ctxarr(dense[:nc], n, ctx[:nc], pctx, a_pad,
                                  num_lanes, edges))
        return "POS"
    if scheme == QS_TRUNC:
        pack_ints(w, to_numpy(trunc)[:num_rec])
        tstream, t_total = _truncate_stream(dense, n, lengths, trunc, cap)
        nc, num_lanes, edges = _geom(cap, t_total)
        shift, pctx = _pos_params(a_pad, _pow2ceil(t_total))
        ctx = _pos_ctx(trunc, cap, shift)
        _put(w, t_total, _encode_ctxarr(tstream[:nc], t_total, ctx[:nc],
                                        pctx, a_pad, num_lanes, edges))
        return "TRUNC"
    if scheme == QS_RLE:
        run_syms, run_lens, nr = _make_runs(dense, n, lengths, cap)
        nc, num_lanes, edges = _geom(cap, nr)
        sym_order = _rle_sym_order(a_pad, _pow2ceil(nr))
        _put(w, nr, C.encode_orderk(run_syms[:nc], nr, sym_order,
                                    _qbits(a_pad), a_pad, num_lanes, edges))
        _put(w, nr, _encode_ctxarr(run_lens[:nc], nr, run_syms[:nc], a_pad,
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


def _pad_to(x: torch.Tensor, cap: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, cap - x.shape[0]))


def decode_quality(r: BitReader, cap: int, lengths: torch.Tensor,
                   num_rec: int, order: int, hash_val: int
                   ) -> Tuple[torch.Tensor, int]:
    """Returns ([cap] int32 values in [0,256), zero past n; n)."""
    dev = lengths.device
    idx = torch.arange(cap, device=dev)
    scheme = r.get_byte()
    if scheme == QS_EMPTY:
        return torch.zeros(cap, dtype=torch.int32, device=dev), 0
    if scheme == QS_CONST:
        n = r.get_varint()
        val = r.get_byte()
        return torch.where(idx < n, val, 0).to(torch.int32), n
    bitmap = np.frombuffer(r.get_bytes(32), np.uint8)
    present = np.flatnonzero(np.unpackbits(bitmap))
    a_pad = _a_pad(len(present))
    inv = np.zeros(a_pad, np.int32)
    inv[: len(present)] = present[:a_pad]

    def geom(n):
        return _geom(cap, n)

    if scheme == QS_POS:
        n, (nc, num_lanes, edges), pl, st = _stream(r, geom, dev)
        shift, pctx = _pos_params(a_pad, _pow2ceil(n))
        ctx = _pos_ctx(lengths, cap, shift)
        dense = _pad_to(_decode_ctxarr(pl, st, n, ctx[:nc], nc // num_lanes,
                                       pctx, a_pad, num_lanes, edges)[:nc],
                        cap)
    elif scheme == QS_TRUNC:
        trunc_np = unpack_ints(r)
        rcap = lengths.shape[0]
        trunc = torch.from_numpy(np.pad(
            trunc_np, (0, rcap - len(trunc_np))).astype(np.int32)).to(dev)
        t_total, (nc, num_lanes, edges), pl, st = _stream(r, geom, dev)
        shift, pctx = _pos_params(a_pad, _pow2ceil(t_total))
        ctx = _pos_ctx(trunc, cap, shift)
        tdense = _pad_to(_decode_ctxarr(pl, st, t_total, ctx[:nc],
                                        nc // num_lanes, pctx, a_pad,
                                        num_lanes, edges)[:nc], cap)
        lut = np.zeros(256, np.int32)
        lut[present] = np.arange(len(present))
        hash_dense = int(lut[hash_val]) if 0 <= hash_val < 256 else 0
        n = int(lengths[:num_rec].sum())
        dense = _untruncate_stream(tdense, lengths, trunc, n, hash_dense, cap)
    elif scheme == QS_RLE:
        nr, (nc, num_lanes, edges), pl, st = _stream(r, geom, dev)
        t_steps = nc // num_lanes
        run_syms = C.decode_orderk(pl, st, nr, t_steps,
                                   _rle_sym_order(a_pad, _pow2ceil(nr)),
                                   _qbits(a_pad), a_pad, num_lanes,
                                   edges)[:nc]
        rmask = torch.arange(nc, device=dev) < nr
        run_syms = torch.where(rmask, run_syms, 0)
        nr2, _, pl2, st2 = _stream(r, lambda _n: (nc, num_lanes, edges), dev)
        run_lens = _decode_ctxarr(pl2, st2, nr2, run_syms, t_steps, a_pad,
                                  MAX_RUN + 1, num_lanes, edges)[:nc]
        run_lens = torch.where(rmask, run_lens, 0)
        dense, n = _expand_runs(_pad_to(run_syms, cap), _pad_to(run_lens, cap),
                                nr, cap)
    else:  # QS_CTX
        n, (nc, num_lanes, edges), pl, st = _stream(r, geom, dev)
        dense = _pad_to(_decode_ctxq(pl, st, n, lengths, nc, nc // num_lanes,
                                     order, a_pad, num_lanes, edges,
                                     _pow2ceil(n))[:nc], cap)
    vals = torch.from_numpy(inv).to(dev)[torch.clamp(dense.to(torch.int64),
                                                     0, a_pad - 1)]
    return torch.where(idx < n, vals, 0), int(n)
