"""The two kernels of the positional rANS codec, their wrappers and their
plain PyTorch versions.

  K1 rans_encode_from_freqs  csrc/rans_enc.cu   (TPU: rans_pallas._enc_kernel)
  K2 rans_decode             csrc/rans_dec.cu   (TPU: rans_pallas._dec_kernel)

A wrapper takes its plain version only for tensors that lie on the CPU; for
CUDA tensors it launches the kernel or raises.  The plain versions repeat
the kernels' integer arithmetic step by step on [L] vectors (u32 state held
in int64 and masked), so they are the reference the kernels are held to on
the card, and what the CPU tests run.

Every launch adds one to its kernel's count in LAUNCHES (thread-safe: the
whole-file pipeline runs worker threads), so a run can show that its main
path went through the kernels.

A kernel runs on the card of its tensors, on that card's current stream.
Each launch is made under torch.cuda.device(dev), which gives the calling
thread back its current CUDA device afterwards (the C entry point sets
`dev` and does not restore it): the mesh path launches on several cards
from one thread, and later work that names no card index must not land on
the last card used.  K5's entry point (hist_kernels) does the same in C:
it makes the card current only when it is not, and sets it back.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Tuple

import torch

from ..config import DsrcException
from . import cuda_build
from .rans import ENC_SHIFT, MASK, PROB_BITS, RANS_L, payload_pairs

_U32 = 0xFFFFFFFF


class LaunchCounter:
    """Thread-safe count of kernel launches."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        return self._n


LAUNCHES: Dict[str, LaunchCounter] = {
    "rans_encode": LaunchCounter(), "rans_decode": LaunchCounter(),
    "ctx_decode": LaunchCounter(), "hist": LaunchCounter()}


def reset_launch_counts() -> None:
    for c in LAUNCHES.values():
        c.reset()


def launch_counts() -> Dict[str, int]:
    return {k: c.count for k, c in LAUNCHES.items()}


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise DsrcException(f"{name}: expected {ndim}-d {dtype}, got "
                            f"{t.dim()}-d {t.dtype}")
    if t.device != device:
        raise DsrcException(f"{name} on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise DsrcException(f"{name} must be contiguous")


_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points (csrc/*.cu): library, argument types; each returns the
# cudaError_t of its launch
_SIGNATURES = {
    "dsrc_rans_encode": ("rans_enc", (_P, _P, _P, _I, _I, _I, _P, _P, _P,
                                      _I, _P)),
    "dsrc_rans_decode": ("rans_dec", (_P, _I, _P, _P, _P, _I, _I, _I, _I,
                                      _I, _I, _I, _I, _P, _I, _P)),
    "dsrc_ctx_decode": ("ctx_dec", (_P, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                                    _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                    _I, _I, _I, _I, _I, _P, _P, _I, _P)),
    # one packed argument struct (hist_kernels._ARGS), which ctypes
    # passes for less host time than 17 converted arguments
    "dsrc_hist": ("hist", (ctypes.c_char_p,)),
}


@functools.lru_cache(maxsize=None)
def _entry(fn_name: str):
    """The typed ctypes function of a kernel's C entry point (the library
    is built at first use; the function is made once)."""
    source, argtypes = _SIGNATURES[fn_name]
    fn = getattr(cuda_build.load(source), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same bit pattern."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


# --------------------------------------------------------------------------
# K1: encode
# --------------------------------------------------------------------------

def rans_encode_plain(freq: torch.Tensor, cum: torch.Tensor,
                      active: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K1 (same signature and outputs as
    rans_encode_from_freqs): a Python loop over the T steps in reverse."""
    t_steps, lanes = freq.shape
    dev = freq.device
    wmax = 2 * payload_pairs(t_steps)
    words = torch.zeros(lanes * wmax + 1, dtype=torch.int64, device=dev)
    dump = lanes * wmax                      # slot for lanes that emit nothing
    row0 = torch.arange(lanes, dtype=torch.int64, device=dev) * wmax
    x = torch.full((lanes,), RANS_L, dtype=torch.int64, device=dev)
    b = torch.zeros(lanes, dtype=torch.int64, device=dev)
    for t in range(t_steps - 1, -1, -1):
        a = active[t]
        f = torch.where(a, freq[t].to(torch.int64), 1)
        c = cum[t].to(torch.int64)
        emit = a & (x >= (f << ENC_SHIFT))
        words.scatter_(0, torch.where(emit, row0 + wmax - 1 - b, dump),
                       x & 0xFFFF)
        b = b + emit.to(torch.int64)
        x = torch.where(emit, x >> 16, x)
        xn = ((torch.div(x, f, rounding_mode="floor") << PROB_BITS)
              + c + torch.remainder(x, f)) & _U32
        x = torch.where(a, xn, x)
    w16 = words[:dump].view(lanes, wmax)
    pairs = w16[:, 0::2] | (w16[:, 1::2] << 16)     # low half first
    return _u32_to_i32(pairs).contiguous(), b.to(torch.int32), _u32_to_i32(x)


def _mulhi(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """High 32 bits of the u32 product x * m (int64 values in [0, 2^32)),
    in 16-bit halves so that no int64 product overflows."""
    return ((x >> 16) * m + (((x & 0xFFFF) * m) >> 16)) >> 16


def enc_recip(f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's reciprocal of a divisor f in [1, 2^14] (int64): (m, l) with
    l = ceil(log2 f) and the Granlund-Montgomery magic number
    m = floor(2^32 (2^l - f) / f) + 1 < 2^32."""
    l = ((f - 1)[..., None] >> torch.arange(15, device=f.device)).gt(0) \
        .sum(-1)
    return (((1 << l) - f) << 32) // f + 1, l


def recip_divmod_plain(x: torch.Tensor, f: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's divide: (x // f, x % f) for u32 x (int64 values in [0, 2^32))
    and f in [1, 2^14], as (x + mulhi(x, m)) >> l with the sum in 33 bits
    and x - q f; exact for every such x and f."""
    m, l = enc_recip(f)
    q = (x + _mulhi(x, m)) >> l
    return q, x - q * f


def rans_encode_from_freqs(freq: torch.Tensor, cum: torch.Tensor,
                           active: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Reverse rANS over per-symbol models in decode order.

    freq, cum: [T, L] int32 (freq in [1, M) where active); active: [T, L]
    bool.  Returns (payload [L, Wp] int32 pairs of u16 words, nwords [L]
    int32, states [L] int32 holding the u32 state bits), bit-equal to
    dsrc_tpu's rans_encode_from_freqs: lane j's words sit right-aligned in
    the u16 view, [2*Wp - nwords[j], 2*Wp), in decode order; Wp =
    payload_pairs(T)."""
    dev = freq.device
    if freq.dim() != 2:
        raise DsrcException("rans_encode: freq must be [T, L]")
    for t, name, dt in ((freq, "freq", torch.int32), (cum, "cum", torch.int32),
                        (active, "active", torch.bool)):
        _check(t, name, dt, 2, dev)
        if t.shape != freq.shape:
            raise DsrcException(f"rans_encode: {name} shape {tuple(t.shape)}"
                                f" != {tuple(freq.shape)}")
    if dev.type == "cpu":
        return rans_encode_plain(freq, cum, active)
    if dev.type != "cuda":
        raise DsrcException(f"rans_encode: unsupported device {dev}")
    t_steps, lanes = freq.shape
    wp = payload_pairs(t_steps)
    # the kernel writes every pair, zeros left of a lane's words
    payload = torch.empty((lanes, wp), dtype=torch.int32, device=dev)
    nwords = torch.empty(lanes, dtype=torch.int32, device=dev)
    states = torch.empty(lanes, dtype=torch.int32, device=dev)
    if lanes == 0:
        return payload, nwords, states
    with torch.cuda.device(dev):        # restores the thread's device
        rc = _entry("dsrc_rans_encode")(
            freq.data_ptr(), cum.data_ptr(), active.data_ptr(), t_steps,
            lanes, wp, payload.data_ptr(), nwords.data_ptr(),
            states.data_ptr(), dev.index or 0, _stream(dev))
    if rc != 0:
        raise DsrcException(f"rans_encode kernel launch failed: CUDA error "
                            f"{rc}")
    LAUNCHES["rans_encode"].add()
    return payload, nwords, states


# --------------------------------------------------------------------------
# K2: decode
# --------------------------------------------------------------------------

def _top_step(nsym: int) -> int:
    """Largest power of two below nsym: the first stride of the binary
    symbol search (0 when there is one symbol)."""
    return 1 << ((nsym - 1).bit_length() - 1) if nsym > 1 else 0


# K2's shared memory for the cum table, per block (the C entry point opts
# in above the default 48 KB)
DEC_SMEM_BUDGET = 64 * 1024
_INT32_MAX = 2**31 - 1


def dec_layout(nsym: int, p: int,
               budget: int = DEC_SMEM_BUDGET) -> Tuple[int, int, int]:
    """K2's shared-memory layout: (ne, stride, tile_rows).

    Each of a warp's 32 threads compares ne entries of a row with the slot
    (ceil((nsym-1)/32), rounded up to a power of two up to 16); a row holds
    cum[0..nsym] padded to stride = max(nsym+1, 32*ne+1) ints; a tile holds
    tile_rows positions, as many as the budget takes (at least one; a
    row beyond the card's shared memory fails the launch, which raises)."""
    e = -(-(nsym - 1) // 32)
    ne = e if e <= 2 or e > 16 else 1 << (e - 1).bit_length()
    stride = max(nsym + 1, 32 * ne + 1)
    return ne, stride, max(1, min(p, budget // (4 * stride)))


def count_search_plain(cum: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """K2's symbol rule in plain PyTorch: on rows padded as dec_layout lays
    them out, count the entries 1 .. 32*ne that are <= slot and take
    min(count, nsym-1).  cum [P, nsym+1], slot [..., P] in [0, 2^14) ->
    s [..., P] int64.  Equals the binary search of rans_decode_plain on
    non-decreasing rows."""
    p, nsym = cum.shape[0], cum.shape[1] - 1
    ne, stride, _ = dec_layout(nsym, p)
    rows = torch.full((p, stride), _INT32_MAX, dtype=torch.int64,
                      device=cum.device)
    rows[:, :nsym + 1] = cum.to(torch.int64)
    keys = rows[:, 1:1 + 32 * ne]
    count = (keys <= slot.to(torch.int64)[..., None]).sum(-1)
    return torch.clamp(count, max=nsym - 1)


def rans_decode_plain(payload: torch.Tensor, states: torch.Tensor,
                      wptr: torch.Tensor, cum: torch.Tensor, num_rec: int,
                      group: int) -> torch.Tensor:
    """Plain version of K2 (same signature and output as rans_decode): a
    Python loop over the T steps, the same branchless binary search."""
    lanes, w = payload.shape
    p, nsym = cum.shape[0], cum.shape[1] - 1
    dev = payload.device
    row_words = 2 * w
    words = (payload.view(torch.int16).to(torch.int64) & 0xFFFF) \
        .view(lanes, row_words)
    cum64 = cum.to(torch.int64)
    x = states.to(torch.int64) & _U32
    ptr = wptr.to(torch.int64)
    rec0 = torch.arange(lanes, dtype=torch.int64, device=dev) * group
    top = _top_step(nsym)
    out = torch.empty((group * p, lanes), dtype=torch.int32, device=dev)
    for t in range(group * p):
        pos = t % p
        act = rec0 + t // p < num_rec
        crow = cum64[pos]
        slot = x & MASK
        s = torch.zeros(lanes, dtype=torch.int64, device=dev)
        step = top
        while step:
            nxt = s + step
            ok = (nxt < nsym) & (crow[torch.clamp(nxt, max=nsym - 1)] <= slot)
            s = torch.where(ok, nxt, s)
            step >>= 1
        out[t] = s.to(torch.int32)
        c = crow[s]
        f = (crow[s + 1] - c) & _U32
        xn = (f * (x >> PROB_BITS) + slot - c) & _U32
        need = act & (xn < RANS_L)
        inb = (ptr >= 0) & (ptr < row_words)
        wd = torch.gather(words, 1,
                          torch.clamp(ptr, 0, row_words - 1)[:, None])[:, 0]
        xn = torch.where(need, ((xn << 16) | torch.where(inb, wd, 0)) & _U32,
                         xn)
        x = torch.where(act, xn, x)
        ptr = ptr + need.to(torch.int64)
    # [T, L] -> [L*G, P]: out[g*P + p, l] is record l*G + g, position p
    return out.view(group, p, lanes).permute(2, 0, 1).reshape(lanes * group,
                                                              p)


def rans_decode(payload: torch.Tensor, states: torch.Tensor,
                wptr: torch.Tensor, cum: torch.Tensor, num_rec: int,
                group: int) -> torch.Tensor:
    """Forward positional rANS decode of L lanes of `group` records each.

    payload: [L, W] int32 pairs of u16 words; states: [L] int32 (u32 bits);
    wptr: [L] int32 start word per lane; cum: [P, nsym+1] int32 cumulative
    model rows (row p models position p).  Returns [L*group, P] int32
    symbols; records >= num_rec are not decoded (their state is held)."""
    dev = payload.device
    _check(payload, "payload", torch.int32, 2, dev)
    _check(states, "states", torch.int32, 1, dev)
    _check(wptr, "wptr", torch.int32, 1, dev)
    _check(cum, "cum", torch.int32, 2, dev)
    lanes = payload.shape[0]
    if states.shape[0] != lanes or wptr.shape[0] != lanes:
        raise DsrcException("rans_decode: states/wptr must have one entry "
                            "per payload row")
    if cum.shape[1] < 2 or group < 1:
        raise DsrcException("rans_decode: empty model table or bad group")
    if dev.type == "cpu":
        return rans_decode_plain(payload, states, wptr, cum, num_rec, group)
    if dev.type != "cuda":
        raise DsrcException(f"rans_decode: unsupported device {dev}")
    p, nsym = cum.shape[0], cum.shape[1] - 1
    out = torch.empty((lanes * group, p), dtype=torch.int32, device=dev)
    if lanes == 0 or p == 0:
        return out
    ne, stride, tile_rows = dec_layout(nsym, p)
    with torch.cuda.device(dev):        # restores the thread's device
        rc = _entry("dsrc_rans_decode")(
            payload.data_ptr(), payload.shape[1], states.data_ptr(),
            wptr.data_ptr(), cum.data_ptr(), p, nsym, ne, stride, tile_rows,
            group, lanes, max(0, min(int(num_rec), lanes * group)),
            out.data_ptr(), dev.index or 0, _stream(dev))
    if rc != 0:
        raise DsrcException(f"rans_decode kernel launch failed: CUDA error "
                            f"{rc}")
    LAUNCHES["rans_decode"].add()
    return out
