"""The work that each kernel's algorithm needs, the table of peaks, and a
kernel's share of its roofline.

A kernel's least time for one call is the larger of its bytes over the
HBM rate and its integer operations over the int32 rate.  The bytes are
each input read once and each output written once, as the call's shapes
and data need them, each value at the bytes its range needs, not at the
width of the tensor that carries it (a symbol of an alphabet of at most
256 is one byte; a model table entry, at most 2^PROB_BITS, two), and of a
payload only the words its lanes hold, not the padding of its rows; the
operations are the rANS arithmetic of each coded symbol, with nothing
charged for how a kernel finds a symbol in its table (a search, a compare
per entry or a slot table are the kernel's choice, not the algorithm's).
The share of a roofline is the summed least time over the summed device
time of the kernel in the trace.

A count may depend on the data (how many steps are active, how many words
a lane emitted); such a term is a 0-d tensor computed where the call's
tensors live, and read once the window has closed.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

# NVIDIA H100 SXM5 80 GB data sheet: HBM3 at 3.35 TB/s.
HBM_BYTES_PER_S = 3.35e12
# The int32 rate is derived, not published: SMs x 64 INT32 lanes an SM
# (Hopper) x the SM clock nvidia-smi reports as the card's maximum.
INT32_LANES_PER_SM = 64

# the model tables' probability bits (dsrc_tpu_torch/ops/rans.py): a
# frequency or cumulative entry lies in [0, 2^PROB_BITS]
PROB_BITS = 14

# integer operations a coded symbol (the counts chip_smoke.py used):
# encode: emit test (shift, compare, and), divide, remainder, shift, two
# adds; decode: mask, multiply, shift, add, subtract, renormalisation
# compare, shift-or; the context-model decode adds the context and carry
# update (shift, or, and, select)
ENC_OPS_PER_SYM = 8
DEC_OPS_PER_SYM = 7
CTX_OPS_PER_SYM = DEC_OPS_PER_SYM + 4

# a term: (count, bytes a unit, operations a unit); count is an int or a
# 0-d tensor
Term = Tuple[object, int, int]


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A hand-written kernel as the trace and its callers see it.

    sites: (module, attribute) where the program's callers look the
    kernel's Python entry point up; device: the names of its __global__
    functions in the device trace; count(args, kwargs, result) -> [Term]:
    the work its algorithm needs for one call."""
    name: str
    sites: Tuple[Tuple[str, str], ...]
    device: Tuple[str, ...]
    count: Callable[[tuple, dict, object], List[Term]]

    def matches(self, event_name: str) -> bool:
        return any(re.search(r"\b%s\b" % re.escape(d), event_name)
                   for d in self.device)


def _arg(args, kwargs, i: int, name: str):
    return args[i] if len(args) > i else kwargs[name]


def value_bytes(n: int) -> int:
    """The whole bytes that hold every value in [0, n)."""
    return max(1, (max(1, int(n) - 1).bit_length() + 7) // 8)


TABLE_BYTES = value_bytes((1 << PROB_BITS) + 1)


def lane_words(payload, start=None):
    """The u16 words the lanes of payload [L, W] (int32 pairs of u16
    words) hold: from each lane's start word (start [L], or word 0) to
    its last non-zero word.  A zero word at a lane's end is not charged,
    so the count can only fall short, never over."""
    import torch
    lanes, w = payload.shape
    if lanes == 0 or w == 0:
        return 0
    nz = payload.view(torch.int16).view(lanes, 2 * w) != 0
    pos = torch.arange(1, 2 * w + 1, dtype=torch.int64,
                       device=payload.device)
    end = torch.where(nz, pos, 0).amax(1)
    if start is not None:
        end = end - start.to(torch.int64)
    return end.clamp(min=0).sum()


def k1_count(args, kwargs, result) -> List[Term]:
    """rans_encode_from_freqs(freq, cum, active) -> (payload, nwords,
    states), all [T, L]: the active flags read, freq and cum of each
    active step read (table entries), the words each lane emitted written
    as u16, each lane's word count and state written."""
    freq = _arg(args, kwargs, 0, "freq")
    active = _arg(args, kwargs, 2, "active")
    t_steps, lanes = freq.shape
    nwords = result[1]
    return [(t_steps * lanes, 1, 0),
            (active.sum(), 2 * TABLE_BYTES, ENC_OPS_PER_SYM),
            (nwords.sum(), 2, 0),
            (lanes, 8, 0)]


def k2_count(args, kwargs, result) -> List[Term]:
    """rans_decode(payload, states, wptr, cum, num_rec, group) -> [L*G, P]:
    the u16 words the lanes hold (from each lane's start word), each
    lane's state and start word, the cum table read; the symbols of the
    decoded records written, a byte each (the alphabet is at most 256)."""
    payload = _arg(args, kwargs, 0, "payload")
    wptr = _arg(args, kwargs, 2, "wptr")
    cum = _arg(args, kwargs, 3, "cum")
    num_rec = int(_arg(args, kwargs, 4, "num_rec"))
    group = int(_arg(args, kwargs, 5, "group"))
    lanes = payload.shape[0]
    n = max(0, min(num_rec, lanes * group)) * cum.shape[0]
    return [(lane_words(payload, wptr), 2, 0),
            (lanes * 8 + cum.numel() * TABLE_BYTES, 1, 0),
            (n, value_bytes(cum.shape[1] - 1), DEC_OPS_PER_SYM)]


def k3_count(args, kwargs, result) -> List[Term]:
    """ctx_decode_band(payload, x, wptr, carry, lengths, cum, aux, osym,
    octx, t0, t1, mode): the band's active steps (lane lengths past t0)
    each read aux where the mode reads it (a value below 2C) and write a
    symbol (a byte) and a context id (below C); each lane's state, word
    pointer and carry read and written and its length read; the table
    read; the u16 words the lanes hold (each from word 0, where
    ops/ctx.py starts them), counted once for the stream, at its first
    band (t0 = 0)."""
    payload = _arg(args, kwargs, 0, "payload")
    lengths = _arg(args, kwargs, 4, "lengths")
    cum = _arg(args, kwargs, 5, "cum")
    t0 = int(_arg(args, kwargs, 9, "t0"))
    t1 = int(_arg(args, kwargs, 10, "t1"))
    mode = _arg(args, kwargs, 11, "mode")
    lanes = payload.shape[0]
    nctx, nsym = cum.shape[0], cum.shape[1] - 1
    per_step = value_bytes(nsym) + value_bytes(nctx) + \
        (value_bytes(2 * nctx) if mode.uses_aux else 0)
    active = (lengths - t0).clamp(0, t1 - t0).sum()
    terms = [(lanes * 28 + cum.numel() * TABLE_BYTES, 1, 0),
             (active, per_step, CTX_OPS_PER_SYM)]
    if t0 == 0:
        terms.append((lane_words(payload), 2, 0))
    return terms


K1 = Kernel("k1", (("dsrc_tpu_torch.ops.ctx", "rans_encode_from_freqs"),
                   ("dsrc_tpu_torch.parallel.uniform_pipeline",
                    "rans_encode_from_freqs"),
                   ("dsrc_tpu_torch.models.dna", "rans_encode_from_freqs"),
                   ("dsrc_tpu_torch.models.quality",
                    "rans_encode_from_freqs")),
            ("rans_encode_kernel",), k1_count)
K2 = Kernel("k2", (("dsrc_tpu_torch.parallel.uniform_pipeline",
                    "rans_decode"),),
            ("rans_decode_kernel",), k2_count)
K3 = Kernel("k3", (("dsrc_tpu_torch.ops.ctx", "ctx_decode_band"),),
            ("ctx_decode_kernel",), k3_count)


def totals(terms: Iterable[Term]) -> Tuple[int, int]:
    """(bytes, operations) of resolved terms."""
    nbytes = nops = 0
    for count, b, o in terms:
        c = int(count)
        nbytes += c * b
        nops += c * o
    return nbytes, nops


@dataclasses.dataclass(frozen=True)
class Peaks:
    hbm_bytes_per_s: float
    int32_ops_per_s: float

    @staticmethod
    def of_card(sms: int, max_sm_clock_mhz: float) -> "Peaks":
        return Peaks(HBM_BYTES_PER_S,
                     sms * INT32_LANES_PER_SM * max_sm_clock_mhz * 1e6)


def least_seconds(nbytes: float, nops: float, peaks: Peaks
                  ) -> Tuple[float, float]:
    """(bytes bound, operations bound) of one call, in seconds."""
    return nbytes / peaks.hbm_bytes_per_s, nops / peaks.int32_ops_per_s


def roofline(calls: Sequence[Tuple[int, int]], device_s: float,
             peaks: Peaks) -> Optional[Tuple[float, str]]:
    """(share of the roofline in %, the bound that dominates) of calls
    [(bytes, operations)] that took device_s seconds on the device; None
    when there is nothing to read."""
    if not calls or device_s <= 0:
        return None
    tb = to = least = 0.0
    for nbytes, nops in calls:
        b, o = least_seconds(nbytes, nops, peaks)
        tb += b
        to += o
        least += max(b, o)
    return 100.0 * least / device_s, ("bytes" if tb >= to else "operations")
