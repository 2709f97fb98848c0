"""Host-side vectorized fixed-width bit packing (numpy).

Used for small control vectors (record lengths, token lengths, numeric field
residues) where launching a device kernel per varying shape would thrash the
jit cache.  Bit order is MSB-first, matching utils/bitio.py.
"""
from __future__ import annotations

import numpy as np


def np_pack_fixed(vals: np.ndarray, width: int) -> np.ndarray:
    """[n] unsigned ints (< 2^width, width <= 63) -> packed uint8 array."""
    vals = np.asarray(vals, np.uint64)
    n = len(vals)
    out = np.zeros((n * width + 7) // 8, np.uint8)
    if n == 0 or width == 0:
        return out
    bitpos = np.arange(n, dtype=np.int64) * width
    for b in range(width):
        bp = bitpos + b
        bit = ((vals >> np.uint64(width - 1 - b)) & np.uint64(1)).astype(
            np.uint8)
        np.bitwise_or.at(out, bp >> 3, bit << (7 - (bp & 7)).astype(np.uint8))
    return out


def np_unpack_fixed(packed: np.ndarray, n: int, width: int) -> np.ndarray:
    """Inverse of np_pack_fixed -> [n] int64."""
    packed = np.asarray(packed, np.uint8)
    out = np.zeros(n, np.int64)
    if n == 0 or width == 0:
        return out
    bitpos = np.arange(n, dtype=np.int64) * width
    for b in range(width):
        bp = bitpos + b
        bit = (packed[bp >> 3] >> (7 - (bp & 7)).astype(np.uint8)) & 1
        out |= bit.astype(np.int64) << (width - 1 - b)
    return out


def zigzag(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, np.int64)
    return ((v << 1) ^ (v >> 63)).astype(np.uint64)
