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
from ..ops.ctx_kernels import MODE_QUALITY, CtxMode
from ..ops.rans import lane_lengths, lane_merge, lane_split
from ..ops.streams import deserialize_rans, stream_tensors, unpack_ints
from ..ops.transform import expand_positions, take_clip
from ..utils.bitio import BitReader

QS_EMPTY = 0
QS_CONST = 1
QS_POS = 2
QS_TRUNC = 3
QS_RLE = 4

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


# --------------------------------------------------------------------------
# Precomputed-context codec (POS / TRUNC / RLE substreams)
# --------------------------------------------------------------------------


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
    if int(rlen.max()) * POS_BUCKETS >= 2**31:
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


def ctxq_aux(reset: torch.Tensor, bucket: torch.Tensor) -> torch.Tensor:
    """K3's per-step input in the quality mode, lane-major [L, T] int32:
    bucket << 1 | record start."""
    aux = bucket.T.to(torch.int32, memory_format=torch.contiguous_format)
    return aux.bitwise_left_shift_(1).bitwise_or_(reset.T)


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


def _expand_runs(run_syms: torch.Tensor, run_lens: torch.Tensor,
                 n_runs: int, cap: int):
    """Inverse of _make_runs: ([>= n_runs] syms, [>= n_runs] len-1 syms)
    -> (stream [min(total, cap)], total)."""
    lens = run_lens[:n_runs].to(torch.int32).add_(1)
    cum = torch.cumsum(lens, 0, dtype=torch.int32)
    total = int(cum[-1]) if n_runs else 0
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
        n = int(lengths[:num_rec].sum())
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
    return qvals, int(n)
