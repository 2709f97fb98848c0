"""DNA stream codec of the GENERIC block class (port of
dsrc_tpu/models/dna.py; byte-identical sections).

  scheme PACK2  : <= 4 distinct symbols, order 0: 2-bit packing
  scheme CTX4   : <= 4 distinct, order >= 1: band-adaptive order-k rANS,
                  2-bit contexts (ops/ctx.py; decode through K3)
  scheme CTX8   : <= 8 distinct: dense remap + order min(k, 7), 3-bit ctx
  scheme CTX4P  : CTX4 on base PAIRS (A = 16) for order >= 4 and n >= 2^16
  scheme CTX8P  : CTX8 on base pairs (A = 64)
  scheme A19    : > 8 distinct: static-table order-0 rANS over the 19-symbol
                  alphabet; its decode is K4 (ops/a19_kernels.a19_decode),
                  the reference's order-0 wavefront with one slot table
  scheme RAW    : symbols outside the alphabet: verbatim bytes
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import DsrcException
from ..ops import ctx as C
from ..ops import packbits
from ..ops.rans import (cum_from_freqs, lane_active, lane_lengths,
                        lane_split, quantize_counts)
from ..ops.a19_kernels import a19_decode
from ..ops.rans_kernels import rans_encode_from_freqs
from ..ops.streams import (deserialize_rans, serialize_rans, stream_tensors,
                           to_numpy)
from ..ops.transform import DNA_NSYM, INVALID_SYM, histogram
from ..utils import trace
from ..utils.bitio import BitReader, BitWriter
from ..utils.npbits import np_pack_fixed, np_unpack_fixed

SCHEME_EMPTY = 0
SCHEME_PACK2 = 1
SCHEME_CTX4 = 2
SCHEME_CTX8 = 3
SCHEME_A19 = 4
SCHEME_RAW = 5
SCHEME_CTX4P = 6   # base-PAIR symbols (A=16), ctx = previous pairs
SCHEME_CTX8P = 7   # dense<=8 base-pair symbols (A=64)
SCHEME_NAMES = {SCHEME_EMPTY: "EMPTY", SCHEME_PACK2: "PACK2",
                SCHEME_CTX4: "CTX4", SCHEME_CTX8: "CTX8", SCHEME_A19: "A19",
                SCHEME_RAW: "RAW", SCHEME_CTX4P: "CTX4P",
                SCHEME_CTX8P: "CTX8P"}

MAX_ORDER8 = 7


def _a19_encode(syms: torch.Tensor, n: int, nsym: int, num_lanes: int,
                cap: int):
    """Masked static-table order-0 rANS over [cap] syms (first n valid).
    Returns (payload, nwords, states, freqs)."""
    dev = syms.device
    t = cap // num_lanes
    freqs = quantize_counts(histogram(syms[:n], nsym))
    cumfull = cum_from_freqs(freqs)
    active = lane_active(t, lane_lengths(n, num_lanes, t, dev))
    idx = torch.where(active, lane_split(syms[:cap], num_lanes), 0) \
        .to(torch.int32).contiguous().view(-1)
    payload, nwords, states = rans_encode_from_freqs(
        freqs.index_select(0, idx).view(t, num_lanes),
        cumfull.index_select(0, idx).view(t, num_lanes), active)
    return payload, nwords, states, freqs


def _a19_decode(payload: torch.Tensor, states: torch.Tensor, freqs,
                n: int, nsym: int, num_lanes: int, cap: int) -> torch.Tensor:
    """The reference's order-0 wavefront (lane j active while j*T + t < n,
    one shared table of nsym = 19 fields) through K4: [L*T] uint8 symbols,
    already in stream order.  freqs: the table's fields on the host (or a
    tensor, read back)."""
    t = cap // num_lanes
    wptr = torch.zeros(payload.shape[0], dtype=torch.int32,
                       device=payload.device)
    return a19_decode(payload.to(torch.int32).contiguous(),
                      states.to(torch.int32).contiguous(), wptr, freqs, n, t)


def _order4_eff(order: int, n: int) -> int:
    budget = max(0, (max(1, n // 4).bit_length() - 1 - 2)) // 2
    return max(0, min(order, 9, budget))


def _order8_eff(order: int, n: int) -> int:
    budget = max(1, (max(1, n // 8).bit_length() - 1 - 3)) // 3
    return max(1, min(max(order, 1), MAX_ORDER8, budget))


def _order4p_eff(order: int, npairs: int) -> int:
    budget = 1
    while 16 ** (budget + 2) <= max(1, npairs // 6) and budget < 2:
        budget += 1
    return max(1, min(order // 2, budget))


def _order8p_eff(order: int, npairs: int) -> int:
    budget = 1
    while 64 ** (budget + 2) <= max(1, npairs // 6) and budget < 3:
        budget += 1
    return max(1, min(order // 2, budget))


def _to_pairs(syms: torch.Tensor, n: int, cap: int, a: int) -> torch.Tensor:
    """[cap] base symbols -> [cap//2] int32 pair symbols hi*a + lo (bases
    past n zeroed)."""
    pairs = syms[0:cap:2].to(torch.int32)
    pairs[(n + 1) // 2:] = 0
    pairs.mul_(a)
    pairs[:n // 2] += syms[1:cap:2][:n // 2]
    return pairs


def _from_pairs(pairs: torch.Tensor, a: int) -> torch.Tensor:
    """Inverse of _to_pairs: [m] -> [2m] interleaved bases (uint8)."""
    out = torch.empty(2 * pairs.shape[0], dtype=torch.uint8,
                      device=pairs.device)
    out[0::2] = torch.div(pairs, a, rounding_mode="floor")
    out[1::2] = torch.remainder(pairs, a)
    return out


def dna_stats(syms: torch.Tensor, n: int, cap: int) -> torch.Tensor:
    """Histogram over the 20 symbol classes (19 + invalid)."""
    h = histogram(syms[:n], INVALID_SYM + 1)
    out = h[:DNA_NSYM + 1].clone()
    out[DNA_NSYM] += h[INVALID_SYM]
    return out


def _dense_lut(nz: np.ndarray, device) -> torch.Tensor:
    lut = np.zeros(DNA_NSYM, np.uint8)
    lut[nz] = np.arange(len(nz))
    return torch.from_numpy(lut).to(device)


def _dense(syms: torch.Tensor, nz: np.ndarray) -> torch.Tensor:
    """Symbols -> their index in nz (uint8; symbols above 18 read as
    18)."""
    return torch.index_select(_dense_lut(nz, syms.device), 0,
                              syms.to(torch.int32).clamp_(max=DNA_NSYM - 1))


def encode_dna(w: BitWriter, syms: torch.Tensor, n: int, order: int,
               hist: np.ndarray) -> str:
    """syms: [cap] dense DNA indices (zero past n).  Returns the name of
    the scheme written, and counts its n bases under "dna.<scheme>" in the
    recorder (utils/trace.py)."""
    scheme = _encode_dna(w, syms, n, order, hist)
    trace.count("dna." + scheme, n)
    return scheme


def _encode_dna(w: BitWriter, syms: torch.Tensor, n: int, order: int,
                hist: np.ndarray) -> str:
    cap = syms.shape[0]
    if n == 0:
        w.put_byte(SCHEME_EMPTY)
        return "EMPTY"
    if hist[DNA_NSYM] > 0:
        w.put_byte(SCHEME_RAW)
        w.put_varint(n)
        w.put_bytes(to_numpy(syms[:n]).astype(np.uint8).tobytes())
        return "RAW"
    nz = np.flatnonzero(hist[:DNA_NSYM])
    max_sym = int(nz[-1]) if len(nz) else 0
    nc = C.stream_cap(cap, n)
    num_lanes = C.pick_num_lanes(nc)
    edges = C.band_edges(nc // num_lanes)
    if max_sym < 4 and order == 0:
        w.put_byte(SCHEME_PACK2)
        w.put_varint(n)
        ncap = -(-n // 4) * 4
        packed = packbits.pack2(syms[:ncap])
        w.put_bytes(to_numpy(packed).tobytes())
        return "PACK2"
    npairs = (n + 1) // 2
    use_pairs = order >= 4 and n >= (1 << 16)
    if max_sym < 4 and use_pairs:
        w.put_byte(SCHEME_CTX4P)
        w.put_varint(n)
        pairs = _to_pairs(syms, n, cap, 4)
        ncp = C.stream_cap(cap // 2, npairs)
        lanes_p = C.pick_num_lanes(ncp)
        enc = C.encode_orderk(pairs[:ncp], npairs,
                              _order4p_eff(order, npairs), 4, 16, lanes_p,
                              C.band_edges(ncp // lanes_p))
        serialize_rans(w, npairs, enc["payload"], enc["nwords"],
                       enc["states"])
        return "CTX4P"
    if max_sym < 4:
        name = "CTX4"
        w.put_byte(SCHEME_CTX4)
        enc = C.encode_orderk(syms[:nc], n, _order4_eff(order, n), 2, 4,
                              num_lanes, edges)
    elif len(nz) <= 8 and use_pairs:
        w.put_byte(SCHEME_CTX8P)
        w.put_bits(int(sum(1 << int(i) for i in nz)), 19)
        w.put_varint(n)
        pairs = _to_pairs(_dense(syms, nz), n, cap, 8)
        ncp = C.stream_cap(cap // 2, npairs)
        lanes_p = C.pick_num_lanes(ncp)
        enc = C.encode_orderk(pairs[:ncp], npairs,
                              _order8p_eff(order, npairs), 6, 64, lanes_p,
                              C.band_edges(ncp // lanes_p))
        serialize_rans(w, npairs, enc["payload"], enc["nwords"],
                       enc["states"])
        return "CTX8P"
    elif len(nz) <= 8:
        name = "CTX8"
        w.put_byte(SCHEME_CTX8)
        w.put_bits(int(sum(1 << int(i) for i in nz)), 19)
        enc = C.encode_orderk(_dense(syms[:nc], nz), n,
                              _order8_eff(order, n), 3, 8,
                              num_lanes, edges)
    else:
        w.put_byte(SCHEME_A19)
        a19_lanes = C.pick_num_lanes(nc, target_per_lane=2048)
        payload, nwords, states, freqs = _a19_encode(
            syms[:nc], n, DNA_NSYM, a19_lanes, nc)
        w.put_bytes(np_pack_fixed(to_numpy(freqs).astype(np.uint64), 14))
        serialize_rans(w, n, payload, nwords, states)
        return "A19"
    serialize_rans(w, n, enc["payload"], enc["nwords"], enc["states"])
    return name


def _fit(dec: torch.Tensor, cap: int, n: int) -> torch.Tensor:
    """[m] decoded symbols -> uint8 [cap], zero past n."""
    m = min(dec.shape[0], cap, n)
    out = torch.zeros(cap, dtype=torch.uint8, device=dec.device)
    out[:m] = dec[:m]
    return out


def decode_dna(r: BitReader, cap: int, order: int,
               device) -> Tuple[torch.Tensor, int]:
    """Returns ([cap] uint8 dense DNA indices zero-padded, n), and counts
    the n bases under "dna.<scheme>" in the recorder (utils/trace.py)."""
    scheme = r.get_byte()
    dna, n = _decode_dna(r, scheme, cap, order, device)
    trace.count("dna." + SCHEME_NAMES[scheme], n)
    return dna, n


def _decode_dna(r: BitReader, scheme: int, cap: int, order: int,
                device) -> Tuple[torch.Tensor, int]:
    if scheme == SCHEME_EMPTY:
        return torch.zeros(cap, dtype=torch.uint8, device=device), 0
    if scheme == SCHEME_RAW:
        n = r.get_varint()
        raw = np.frombuffer(r.get_bytes(n), np.uint8).copy()
        return _fit(torch.from_numpy(raw).to(device), cap, n), n
    if scheme == SCHEME_PACK2:
        n = r.get_varint()
        packed = np.frombuffer(r.get_bytes(-(-n // 4)), np.uint8).copy()
        syms = packbits.unpack2(torch.from_numpy(packed).to(device))
        return _fit(syms, cap, n), n
    nz = None
    if scheme in (SCHEME_CTX8, SCHEME_CTX8P):
        bitmap = r.get_bits(19)
        nz = np.flatnonzero([(bitmap >> i) & 1 for i in range(19)])
    if scheme in (SCHEME_CTX4P, SCHEME_CTX8P):
        n = r.get_varint()
        npairs, payload, states, _ = deserialize_rans(r)
        if npairs != (n + 1) // 2:
            raise DsrcException("dna pair stream length mismatch")
        ncp = C.stream_cap(cap // 2, npairs)
        lanes_p = C.pick_num_lanes(ncp)
        edges_p = C.band_edges(ncp // lanes_p)
        pl, st = stream_tensors(payload, states, lanes_p, device)
        if scheme == SCHEME_CTX4P:
            pairs = C.decode_orderk(pl, st, npairs, ncp // lanes_p,
                                    _order4p_eff(order, npairs), 4, 16,
                                    lanes_p, edges_p)
            dec = _from_pairs(pairs[:ncp], 4)
        else:
            dense = C.decode_orderk(pl, st, npairs, ncp // lanes_p,
                                    _order8p_eff(order, npairs), 6, 64,
                                    lanes_p, edges_p)
            dec = _inverse(nz, _from_pairs(dense[:ncp], 8))
        return _fit(dec, cap, n), n
    freqs = None
    if scheme == SCHEME_A19:
        raw = r.get_bytes((DNA_NSYM * 14 + 7) // 8)
        freqs = np_unpack_fixed(np.frombuffer(raw, np.uint8),
                                DNA_NSYM, 14).astype(np.int32)
    n, payload, states, _ = deserialize_rans(r)
    nc = C.stream_cap(cap, n)
    if scheme == SCHEME_A19:
        num_lanes = C.pick_num_lanes(nc, target_per_lane=2048)
        pl, st = stream_tensors(payload, states, num_lanes, device)
        return _fit(_a19_decode(pl, st, freqs, n, DNA_NSYM, num_lanes, nc),
                    cap, n), n
    num_lanes = C.pick_num_lanes(nc)
    edges = C.band_edges(nc // num_lanes)
    t_steps = nc // num_lanes
    pl, st = stream_tensors(payload, states, num_lanes, device)
    if scheme == SCHEME_CTX4:
        dec = C.decode_orderk(pl, st, n, t_steps, _order4_eff(order, n), 2,
                              4, num_lanes, edges)
    elif scheme == SCHEME_CTX8:
        dense = C.decode_orderk(pl, st, n, t_steps, _order8_eff(order, n), 3,
                                8, num_lanes, edges)
        dec = _inverse(nz, dense)
    else:
        raise DsrcException(f"bad DNA scheme {scheme}")
    return _fit(dec[:nc], cap, n), n


def _inverse(nz: np.ndarray, dense: torch.Tensor) -> torch.Tensor:
    inv = np.zeros(8, np.uint8)
    inv[: len(nz)] = nz[:8]
    return torch.index_select(torch.from_numpy(inv).to(dense.device), 0,
                              dense.to(torch.int32).clamp_(0, 7))
