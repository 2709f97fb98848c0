"""Host-side (de)serialization of device-coded rANS streams (port of
dsrc_tpu/ops/streams.py; byte-identical output).

A coded stream is (payload [L, W] u16 words, nwords [L], states [L] u32) plus
the symbol count n.  On disk it becomes:

    varint n; varint num_lanes; [L] u32 states; pack_ints nwords;
    concatenated u16-LE payload words (lane-major).

Bulk bytes stay numpy; only tiny control fields go through BitWriter.
Counterpart of the reference's per-stream BitMemory blobs
(BlockCompressor.cpp:223-259).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.bitio import BitReader
from ..utils.npbits import np_unpack_fixed


def to_numpy(x) -> np.ndarray:
    """Host numpy view of a tensor (any device) or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def deserialize_rans(r: BitReader) -> Tuple[int, np.ndarray, np.ndarray,
                                            np.ndarray]:
    """Returns (n, payload [L, W], states [L] u32, nwords [L])."""
    n = r.get_varint()
    l = r.get_varint()
    if n == 0:
        return 0, np.zeros((l, 1), np.int32), \
            np.zeros((l,), np.uint32), np.zeros((l,), np.int32)
    states = np.frombuffer(r.get_bytes(4 * l), dtype="<u4").astype(np.uint32)
    nwords = unpack_ints(r).astype(np.int32)
    if len(nwords) != l or (nwords < 0).any():
        raise ValueError("rANS stream: bad lane word counts")
    total_words = int(nwords.sum())
    flat = np.frombuffer(r.get_bytes(2 * total_words), dtype="<u2")
    wmax = int(nwords.max()) if l else 0
    wmax = max(2, wmax + (wmax & 1))                  # even u16 capacity
    u16 = np.zeros((l, wmax), "<u2")
    u16[np.arange(wmax)[None, :] < nwords[:, None]] = flat
    # little-endian u16 pairs -> the paired i32 layout (words LEFT-aligned,
    # so decoders start at word pointer 0)
    payload = u16.view("<u4").view(np.int32)
    return n, payload, states, nwords


def stream_tensors(payload: np.ndarray, states: np.ndarray, num_lanes: int,
                   device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A deserialized stream as int32 tensors on `device`: the payload with
    zero rows added up to num_lanes, the u32 states as int32 bits."""
    if payload.shape[0] < num_lanes:
        payload = np.pad(payload,
                         ((0, num_lanes - payload.shape[0]), (0, 0)))
    return (torch.from_numpy(np.ascontiguousarray(payload, np.int32))
            .to(device),
            torch.from_numpy(np.ascontiguousarray(states).view(np.int32))
            .to(device))


def unpack_ints(r: BitReader) -> np.ndarray:
    n = r.get_varint()
    if n == 0:
        return np.zeros(0, np.int64)
    vmin = r.get_svarint()
    width = r.get_byte()
    if width == 0:
        return np.full(n, vmin, np.int64)
    nbytes = (n * width + 7) // 8
    raw = np.frombuffer(r.get_bytes(nbytes), np.uint8)
    return np_unpack_fixed(raw, n, width) + vmin
