"""Band-adaptive context-model rANS (port of dsrc_tpu/ops/ctx.py; the same
payloads, word for word).

The wavefront time axis of a lane-split stream is cut into geometric bands;
band b is coded with a static table quantized from the (ctx, sym) histogram
of bands < b, summed over all lanes, which the decoder rebuilds from its own
output.  No table is transmitted.

  encode: per band, one flat gather of (freq, cum) from the band's table,
          then K1 (rans_encode_from_freqs) over the whole stream
  decode: per band, the table rebuilt on the device from the histogram,
          then one K3 launch (ops/ctx_kernels.ctx_decode_band)

Histograms are K5's integer counts (ops/hist_kernels) of the bin ids
ctx * A + sym (the reference's int8 matmul histogram counts the same).  The
geometry (stream_cap, pick_num_lanes, band_edges) is a pure function of
the transmitted symbol count, so both sides derive it.  The reference's
hashed contexts (hash_mul) are used by no codec and are not ported.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..config import DsrcException
from .ctx_kernels import (MODE_HISTORY, MODE_PRECOMPUTED, CtxMode,
                          ctx_decode_band)
from .hist_kernels import hist_count, hist_count_ctx
from .rans import (cum_from_freqs, lane_active, lane_lengths, lane_merge,
                   lane_split, quantize_counts)
from .rans_kernels import rans_encode_from_freqs
from .transform import histogram


def band_edges(t_steps: int, max_bands: int = 9,
               base: int = 16) -> Tuple[int, ...]:
    """Geometric band schedule: edges 0 < b, 2b, 4b, ... <= T (b = base)."""
    edges = [0]
    e = base
    while e < t_steps and len(edges) < max_bands:
        edges.append(e)
        e *= 2
    edges.append(t_steps)
    return tuple(edges)


def stream_cap(cap: int, n: int) -> int:
    """Power-of-two working length for a stream of n symbols inside a block
    of capacity cap (both sides derive it from the transmitted n)."""
    if n <= 1:
        return min(cap, 4096)
    return min(cap, max(4096, 1 << int(n - 1).bit_length()))


def pick_num_lanes(n: int, target_per_lane: int = 512,
                   max_lanes: int = 2048) -> int:
    l = max(8, min(max_lanes, n // target_per_lane if n else 8))
    return 1 << (l.bit_length() - 1)


def _check_hash(hash_mul: int) -> None:
    if hash_mul:
        raise DsrcException("hashed contexts (hash_mul) are not ported")


def history_ctx_lanes(lanes: torch.Tensor, order: int, sym_bits: int,
                      hash_mul: int = 0) -> torch.Tensor:
    """[T, L] symbol lanes -> [T, L] context ids from the previous `order`
    symbols of the same lane (packed at sym_bits each, newest lowest).
    int32 (int64 for int64 lanes), row-major."""
    _check_hash(hash_mul)
    t_steps = lanes.shape[0]
    mask = (1 << (order * sym_bits)) - 1
    dt = torch.int64 if lanes.dtype == torch.int64 else torch.int32
    ctx = torch.zeros(lanes.shape, dtype=dt, device=lanes.device)
    for i in range(1, min(order, t_steps - 1) + 1):
        ctx[i:] |= lanes[:-i].to(dt) << ((i - 1) * sym_bits)
    return ctx.bitwise_and_(mask)


def history_carry_update(carry: torch.Tensor, sym: torch.Tensor, order: int,
                         sym_bits: int, hash_mul: int = 0) -> torch.Tensor:
    """Decoder-side mirror of history_ctx_lanes (carry IS the ctx id)."""
    _check_hash(hash_mul)
    mask = (1 << (order * sym_bits)) - 1
    return ((carry << sym_bits) | sym) & mask


def hist_update(flat: torch.Tensor, active: torch.Tensor,
                nbins: int) -> torch.Tensor:
    """[*] flat bin ids -> [nbins] int64 counts of the active elements whose
    id lies in [0, nbins) (others are dropped, as the reference drops
    them)."""
    return histogram(flat, nbins, active)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """A row-major int32 copy of x."""
    return torch.empty(x.shape, dtype=torch.int32,
                       device=x.device).copy_(x)


def _in_range(x: torch.Tensor, n: int) -> torch.Tensor:
    """0 <= x < n, for any integer type (a uint8 x holds no value >= 256,
    and no comparison with n may wrap)."""
    if x.dtype == torch.uint8:
        return x < n if n < 256 else torch.ones_like(x, dtype=torch.bool)
    return (x >= 0) & (x < n)


def ctx_models(lanes: torch.Tensor, active: torch.Tensor, ctx: torch.Tensor,
               num_ctx: int, nsym: int, edges: Tuple[int, ...]):
    """Every step's (freq, cum) [T, L] int32 under its band's table, the
    input of K1.

    The reference takes one [A]-wide table row per symbol and sums a
    one-hot; a flat gather of table[ctx * A + sym] gives the same values.
    Every caller's contexts lie in [0, num_ctx) and its symbols in
    [0, nsym): out of range, a context is clipped and a symbol codes
    freq 0 and is not counted.  Bin ids are int32 (num_ctx * nsym < 2^31)
    and made for at most a quarter of the steps at a time: the last band
    is most of T."""
    t_steps, l = lanes.shape
    dev = lanes.device
    nbins = num_ctx * nsym
    if nbins >= 2**31:
        raise DsrcException(f"ctx model of {num_ctx} x {nsym} bins: too wide")
    hist = torch.zeros(nbins + 1, dtype=torch.int64, device=dev)
    freq = torch.empty((t_steps, l), dtype=torch.int32, device=dev)
    cum = torch.empty((t_steps, l), dtype=torch.int32, device=dev)
    rows = max(1, -(-t_steps // 4))
    for b in range(len(edges) - 1):
        table = quantize_counts(hist[:nbins].view(num_ctx, nsym))  # [C, A]
        cumfull = cum_from_freqs(table)[:, :nsym].reshape(-1)
        for t0 in range(edges[b], edges[b + 1], rows):
            t1 = min(t0 + rows, edges[b + 1])
            sym = lanes[t0:t1]
            ok = _in_range(sym, nsym)
            flat = _rows(ctx[t0:t1]).clamp_(0, num_ctx - 1).mul_(nsym) \
                .add_(sym.clamp(0, nsym - 1))
            for out, src in ((freq, table.view(-1)), (cum, cumfull)):
                torch.index_select(src, 0, flat.view(-1),
                                   out=out[t0:t1].view(-1))
                out[t0:t1].masked_fill_(~ok, 0)
            if b + 2 < len(edges):
                # ok follows the lanes' (transposed) layout; K5 reads the
                # mask in the row-major layout of flat
                hist_count(hist, flat,
                           ok.logical_and_(active[t0:t1]).contiguous())
    return freq, cum


def encode_ctx_lanes(lanes: torch.Tensor, active: torch.Tensor,
                     ctx: torch.Tensor, num_ctx: int, nsym: int,
                     edges: Tuple[int, ...]):
    """Band-adaptive encode of [T, L] symbols (decode order) with [T, L]
    context ids: ctx_models, then K1.  Steps outside `active` are neither
    coded nor counted, whatever they hold.  Returns (payload [L, Wp],
    nwords [L], states [L])."""
    freq, cum = ctx_models(lanes, active, ctx, num_ctx, nsym, edges)
    return rans_encode_from_freqs(freq, cum, active.contiguous())


def decode_ctx_lanes(payload: torch.Tensor, states: torch.Tensor,
                     lengths: torch.Tensor, t_steps: int, num_ctx: int,
                     nsym: int, edges: Tuple[int, ...], mode: CtxMode,
                     aux=None) -> torch.Tensor:
    """Mirror of encode_ctx_lanes over a LEFT-aligned paired payload [L, W]
    (ops/streams.deserialize_rans); states [L] (u32 bits); lengths [L];
    mode and aux [L, T] (lane-major) as ops/ctx_kernels.CtxMode describes.
    Returns syms [T, L] int32 (a transposed view of a lane-major tensor).

    One K3 launch a band; between launches the band's table is rebuilt on
    the device from the histogram of the decoded (ctx, sym) pairs."""
    l = payload.shape[0]
    dev = payload.device
    if states.shape[0] != l or lengths.shape[0] != l:
        raise DsrcException("ctx decode: states/lengths must have one entry "
                            "per lane")
    payload = payload.to(torch.int32).contiguous()
    x = states.to(torch.int32).clone()
    wptr = torch.zeros(l, dtype=torch.int32, device=dev)
    carry = torch.zeros(l, dtype=torch.int32, device=dev)
    lens = lengths.to(torch.int32).contiguous()
    osym = torch.empty((l, t_steps), dtype=torch.int32, device=dev)
    octx = torch.empty((l, t_steps), dtype=torch.int32, device=dev)
    if aux is not None:
        aux = aux.to(torch.int32).contiguous()
    nbins = num_ctx * nsym
    hist = torch.zeros(nbins + 1, dtype=torch.int64, device=dev)
    for b in range(len(edges) - 1):
        t0, t1 = edges[b], edges[b + 1]
        cum = cum_from_freqs(quantize_counts(
            hist[:nbins].view(num_ctx, nsym))).contiguous()
        ctx_decode_band(payload, x, wptr, carry, lens, cum, aux, osym, octx,
                        t0, t1, mode)
        if b + 2 < len(edges):
            hist_count_ctx(hist, octx, osym, nsym, lens, t0, t1)
    return osym.T


def encode_orderk(syms: torch.Tensor, n: int, order: int, sym_bits: int,
                  nsym: int, num_lanes: int, edges: Tuple[int, ...],
                  hash_mul: int = 0):
    """Order-k context coding of a flat [cap] stream (first n valid) of
    any integer type."""
    _check_hash(hash_mul)
    lanes = lane_split(syms, num_lanes)
    t_steps = lanes.shape[0]
    lengths = lane_lengths(n, num_lanes, t_steps, syms.device)
    active = lane_active(t_steps, lengths)
    ctx = history_ctx_lanes(lanes, order, sym_bits)
    freq, cum = ctx_models(lanes, active, ctx, 1 << (order * sym_bits), nsym,
                           edges)
    del ctx
    payload, nwords, states = rans_encode_from_freqs(freq, cum,
                                                     active.contiguous())
    return dict(payload=payload, nwords=nwords, states=states)


def decode_orderk(payload, states, n: int, t_steps: int, order: int,
                  sym_bits: int, nsym: int, num_lanes: int,
                  edges: Tuple[int, ...], hash_mul: int = 0) -> torch.Tensor:
    """Inverse of encode_orderk: [T * L] symbols in stream order."""
    _check_hash(hash_mul)
    lengths = lane_lengths(n, num_lanes, t_steps, payload.device)
    mode = CtxMode(MODE_HISTORY, sbits=sym_bits,
                   cmask=(1 << (order * sym_bits)) - 1)
    syms = decode_ctx_lanes(payload, states, lengths, t_steps,
                            1 << (order * sym_bits), nsym, edges, mode)
    return lane_merge(syms, t_steps * num_lanes)


def decode_ctx_precomputed(payload, states, lengths, t_steps: int,
                           num_ctx: int, nsym: int, edges: Tuple[int, ...],
                           ctx_lanes: torch.Tensor) -> torch.Tensor:
    """Decode when every position's context is known in advance;
    ctx_lanes: [T, L]."""
    return decode_ctx_lanes(payload, states, lengths, t_steps, num_ctx,
                            nsym, edges, CtxMode(MODE_PRECOMPUTED),
                            aux=ctx_lanes.T)
