"""K4: the static order-0 rANS decode of DNA scheme A19, its wrapper and
its plain PyTorch version.

  K4 a19_decode   csrc/a19_dec.cu   (TPU: dsrc_tpu/ops/rans.py:rans_decode
                                     as models/dna.py:_a19_decode runs it)

One shared table of 19 frequencies (14-bit fields, as the archive carries
them); lane j decodes records j*T + t while they are below n, and the
output [L*T] uint8 is lane-major, which is stream order.  It is K2's
function at P = 1 (ops/rans_kernels.rans_decode with the table's cum row
and group T, reshaped to [L*T]), narrowed to uint8, and the symbol rule is
K2's: s = min(#{i in 1..19 : cum[i] <= slot}, 18).  Both versions read the
state update from a slot table (slot_table): for each of the 2^14 slots,
f = cum[s+1] - cum[s] and bias = slot - cum[s], so a step is
x = f * (x >> 14) + bias.

The wrapper takes its plain version only for tensors that lie on the CPU;
for CUDA tensors it launches the kernel or raises.  Each launch adds one to
LAUNCHES["a19_decode"].
"""
from __future__ import annotations

import ctypes
import itertools
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ..config import DsrcException
from .rans import M, MASK, PROB_BITS, RANS_L
from .rans_kernels import LAUNCHES, _check, _entry, _stream
from .streams import to_numpy

NSYM = 19
# lanes a block of K4 decodes (its other threads only build the table):
# 2,048 lanes are 128 blocks, half a warp of work on each of 128 SMs (at
# 32, the warp's shared loads conflict more; k4_variants.py)
LANES_PER_BLOCK = 16
_U32 = 0xFFFFFFFF
_FIELDS = ctypes.c_int * NSYM

Freqs = Union[torch.Tensor, np.ndarray, Sequence[int]]


def table_fields(freqs: Freqs) -> Tuple[int, ...]:
    """The 19 frequency fields as host ints; raises unless each lies in
    [0, 2^14), what the archive's 14-bit fields can carry.  (A tensor on
    the card is read back: callers pass the host's table.)"""
    fields = tuple(int(v) for v in to_numpy(freqs).reshape(-1))
    if len(fields) != NSYM:
        raise DsrcException(f"a19_decode: {len(fields)} frequency fields, "
                            f"expected {NSYM}")
    if any(not 0 <= v < M for v in fields):
        raise DsrcException(f"a19_decode: a frequency field outside "
                            f"[0, 2^{PROB_BITS}): {fields}")
    return fields


def slot_table(freqs: Freqs, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4's slot table: (f, bias, sym), int64 [2^14] each, on `device`.
    sym[slot] is K2's symbol rule on the table's cum row; f and bias are
    both in [0, 2^14) for every table of 14-bit fields (cum[sym] <= slot)."""
    cum = torch.tensor((0,) + tuple(itertools.accumulate(
        table_fields(freqs))), dtype=torch.int64, device=device)
    slots = torch.arange(M, dtype=torch.int64, device=device)
    sym = torch.clamp((cum[1:] <= slots[:, None]).sum(1), max=NSYM - 1)
    base = cum[sym]
    return cum[sym + 1] - base, slots - base, sym


def a19_decode_plain(payload: torch.Tensor, states: torch.Tensor,
                     wptr: torch.Tensor, freqs: Freqs, n: int,
                     t: int) -> torch.Tensor:
    """Plain version of K4 (same signature and output as a19_decode): a
    Python loop over the T steps on [L] vectors through the slot table."""
    lanes, w = payload.shape
    dev = payload.device
    f, bias, sym = slot_table(freqs, dev)
    row_words = 2 * w
    words = (payload.view(torch.int16).to(torch.int64) & 0xFFFF) \
        .view(lanes, row_words)
    x = states.to(torch.int64) & _U32
    ptr = wptr.to(torch.int64)
    length = torch.clamp(n - torch.arange(lanes, dtype=torch.int64,
                                          device=dev) * t, 0, t)
    out = torch.empty((t, lanes), dtype=torch.uint8, device=dev)
    for step in range(t):
        act = step < length
        slot = x & MASK
        out[step] = sym[slot].to(torch.uint8)
        xn = (f[slot] * (x >> PROB_BITS) + bias[slot]) & _U32
        need = act & (xn < RANS_L)
        inb = (ptr >= 0) & (ptr < row_words)
        wd = torch.gather(words, 1, torch.clamp(
            ptr, 0, max(row_words - 1, 0))[:, None])[:, 0] if row_words \
            else ptr
        xn = torch.where(need, ((xn << 16) | torch.where(inb, wd, 0)) & _U32,
                         xn)
        x = torch.where(act, xn, x)
        ptr = ptr + need.to(torch.int64)
    return out.t().reshape(-1)


def a19_decode(payload: torch.Tensor, states: torch.Tensor,
               wptr: torch.Tensor, freqs: Freqs, n: int,
               t: int) -> torch.Tensor:
    """Static order-0 rANS decode of L lanes of t steps each.

    payload: [L, W] int32 pairs of u16 words; states: [L] int32 (u32
    bits); wptr: [L] int32 start word per lane; freqs: the 19 frequency
    fields (host values, each in [0, 2^14)); n: the stream's symbols.
    Returns [L*t] uint8: lane j's symbols at j*t, those of records >= n
    decoded from the held state."""
    dev = payload.device
    _check(payload, "payload", torch.int32, 2, dev)
    _check(states, "states", torch.int32, 1, dev)
    _check(wptr, "wptr", torch.int32, 1, dev)
    lanes = payload.shape[0]
    if states.shape[0] != lanes or wptr.shape[0] != lanes:
        raise DsrcException("a19_decode: states/wptr must have one entry "
                            "per payload row")
    if not 0 <= t < 2**31:
        raise DsrcException(f"a19_decode: bad step count {t}")
    fields = table_fields(freqs)
    if dev.type == "cpu":
        return a19_decode_plain(payload, states, wptr, fields, n, t)
    if dev.type != "cuda":
        raise DsrcException(f"a19_decode: unsupported device {dev}")
    out = torch.empty(lanes * t, dtype=torch.uint8, device=dev)
    if lanes == 0 or t == 0:
        return out
    idx = payload.get_device()
    rc = _entry("dsrc_a19_decode")(
        payload.data_ptr(), payload.shape[1], states.data_ptr(),
        wptr.data_ptr(), _FIELDS(*fields), int(n), t, lanes,
        LANES_PER_BLOCK, out.data_ptr(), idx, _stream(idx))
    if rc != 0:
        raise DsrcException(f"a19_decode kernel launch failed: CUDA error "
                            f"{rc}")
    LAUNCHES["a19_decode"].add()
    return out
