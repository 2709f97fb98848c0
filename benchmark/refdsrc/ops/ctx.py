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
from .hist_kernels import hist_count_ctx
from .rans import cum_from_freqs, lane_lengths, lane_merge, quantize_counts


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
