"""rANS constants, the lane layout and the shared model-table math (port of
the parts of dsrc_tpu/ops/rans.py that the positional and context-model
codecs use).

Probabilities are quantized to a power-of-two total (M = 2^14) so decoding
needs no division; renormalization moves at most one 16-bit word per
symbol.  The encode and decode loops themselves are the kernels in
ops/rans_kernels.py.  Table math is deterministic integer arithmetic, so
encoder and decoder build identical tables on any device.
"""
from __future__ import annotations

import torch

PROB_BITS = 14
M = 1 << PROB_BITS                 # total of every quantized model
RANS_L = 1 << 16                   # lower bound of the normalized interval
MASK = M - 1

# Wire-shaping constants of the encoder: the payload width of a stream of
# T symbols per lane is fixed by them (payload_pairs), and decoders reject
# wider payloads, so they stay as the reference chose them.
ENC_UNROLL = 32  # encode symbols per scan step of the reference encoder
TILE = 64        # payload tile, in u16 PAIRS


def payload_pairs(t_steps: int) -> int:
    """Canonical payload width, in i32 pairs of u16 words, of a lane that
    codes t_steps symbols (tile-aligned capacity of the reference encoder,
    dsrc_tpu/ops/rans.py:233-234)."""
    tp = -(-t_steps // ENC_UNROLL) * ENC_UNROLL
    return -(-(tp + ENC_UNROLL) // (2 * TILE)) * TILE


def lane_lengths(n: int, num_lanes: int, t_steps=None,
                 device=None) -> torch.Tensor:
    """Per-lane symbol counts (int32) when lane j codes symbols
    [j*T, (j+1)*T) of n; T defaults to ceil(n / num_lanes)."""
    t = t_steps if t_steps is not None else (-(-n // num_lanes) if n else 0)
    starts = torch.clamp(torch.arange(num_lanes, dtype=torch.int64,
                                      device=device) * t, max=n)
    return (torch.clamp(starts + t, max=n) - starts).to(torch.int32)


def lane_split(arr: torch.Tensor, num_lanes: int) -> torch.Tensor:
    """[n] -> [T, L] contiguous chunks (lane j covers [j*T, (j+1)*T)).  The
    result is the transpose of a contiguous [L, T] tensor: a view of arr
    when n is a multiple of num_lanes, else of a zero-padded copy."""
    n = arr.shape[0]
    t = -(-n // num_lanes) if n else 1
    if t * num_lanes != n:
        arr = torch.nn.functional.pad(arr, (0, t * num_lanes - n))
    return arr.reshape(num_lanes, t).T


def lane_merge(lanes: torch.Tensor, n: int) -> torch.Tensor:
    """[T, L] -> [n], inverse of lane_split."""
    return lanes.T.reshape(-1)[:n]


def quantize_counts(counts: torch.Tensor) -> torch.Tensor:
    """Quantize [..., A] integer counts to int32 freqs summing to M, all >= 1.

    Laplace-smoothed and sharpened exactly as the reference: observed
    counts outweigh the +1 floor 8:1; the total is shifted below 2^16 by a
    bit length found with compares (no floats); the deficit goes to the
    FIRST most frequent symbol (torch.argmax returns the first maximum, as
    jnp.argmax does).  Arithmetic runs in int64.  It equals the
    reference's int32 arithmetic wherever that does not overflow, i.e.
    while 8 * sum(counts) + A < 2^31; a block's per-position histograms
    stay far below."""
    a = counts.shape[-1]
    c = (counts.to(torch.int64) << 3) + 1
    tot = c.sum(-1, keepdim=True)
    shift = torch.zeros_like(tot)
    for k in range(16, 31):
        shift = shift + (tot >= (1 << k)).to(torch.int64)
    c = torch.clamp(c >> shift, min=1)
    tot = c.sum(-1, keepdim=True)
    q = torch.clamp((c * (M - a)) // tot, min=1)
    deficit = M - q.sum(-1, keepdim=True)
    top = torch.argmax(q, dim=-1, keepdim=True)
    q = q.scatter_add(-1, top, deficit)
    return q.to(torch.int32)


def cum_from_freqs(freqs: torch.Tensor) -> torch.Tensor:
    """[..., A] int32 freqs -> [..., A+1] int32 exclusive cumulative
    (cum[..., -1] = M for a full table)."""
    z = torch.zeros(freqs.shape[:-1] + (1,), dtype=torch.int32,
                    device=freqs.device)
    return torch.cat([z, torch.cumsum(freqs, dim=-1, dtype=torch.int32)],
                     dim=-1)
