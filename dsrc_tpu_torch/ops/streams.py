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

from ..utils import trace
from ..utils.bitio import BitReader, BitWriter
from ..utils.npbits import np_pack_fixed, np_unpack_fixed


def to_numpy(x, copy: bool = False) -> np.ndarray:
    """Host numpy view of a tensor (any device) or array-like; copy: a
    copy also of a host tensor.  A tensor's read is one codec.sync of the
    recorder (utils/trace.py)."""
    if isinstance(x, torch.Tensor):
        with trace.sync(x):
            return x.detach().to("cpu", copy=copy).numpy()
    return np.asarray(x)


def item(x):
    """The Python number of a one-element tensor (any device; one
    codec.sync of the recorder), or x itself."""
    if isinstance(x, torch.Tensor):
        with trace.sync(x):
            return x.item()
    return x


def _payload_tail(payload, nwords: np.ndarray) -> np.ndarray:
    """Rightmost live u16 columns of a paired payload as a host array.

    For a device payload only the rightmost wkeep pairs cross to the host
    (sliced on the device), not the padded [L, Wp] array.  Returns u16
    [L, 2*wkeep] equal to the rightmost columns of the canonical layout
    (2*wkeep >= max(nwords))."""
    wp = payload.shape[1]
    wkeep = min(wp, (int(nwords.max()) // 2 + 1 + 63) // 64 * 64)
    tail_pairs = to_numpy(payload[:, wp - wkeep:])
    u16 = np.ascontiguousarray(tail_pairs.astype("<i4")).view("<u2") \
        .reshape(payload.shape[0], -1)
    return u16


def serialize_rans(w: BitWriter, n: int, payload, nwords, states) -> None:
    nwords = to_numpy(nwords)
    states = to_numpy(states)
    l = states.shape[0]
    w.put_varint(int(n))
    w.put_varint(l)
    if n == 0:
        return
    # states are u32 bits (the port keeps them in int32 tensors)
    w.put_bytes(states.astype("<i4").view("<u4").tobytes())
    # nwords cluster tightly around the per-lane mean: min/width packing
    # (pack_ints) stores ~1 byte per lane instead of 2
    pack_ints(w, nwords.astype(np.int64))
    # compact payload rows: payload is the paired i32 layout; a little-endian
    # u16 view recovers the word-slot matrix, where row j's words sit
    # RIGHT-aligned at [2*Wp - nwords[j], 2*Wp) in decode order
    u16 = _payload_tail(payload, nwords)
    cols = np.arange(u16.shape[1])[None, :]
    w.put_bytes(u16[cols >= (u16.shape[1] - nwords[:, None])].tobytes())


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


def pack_ints(w: BitWriter, vals: np.ndarray) -> None:
    """Bit-packed (count, min, width, payload) integer vector — the
    reference's bit_length(max-min) trick for varying lengths
    (BlockCompressor.cpp:458-488).  Width 0 = all values equal vmin.
    Negative values allowed (min is zigzag-coded)."""
    vals = np.asarray(vals, np.int64)
    n = len(vals)
    w.put_varint(n)
    if n == 0:
        return
    vmin, vmax = int(vals.min()), int(vals.max())
    w.put_svarint(vmin)
    width = int(vmax - vmin).bit_length()
    w.put_byte(width)
    if width == 0:
        return
    w.put_bytes(np_pack_fixed((vals - vmin).astype(np.uint64), width))


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
