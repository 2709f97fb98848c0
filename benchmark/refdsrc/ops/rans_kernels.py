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

A kernel runs on the card of its tensors, on that card's current stream
(read raw, torch._C._cuda_getCurrentRawStream).  The C entry points of
K1-K5 share one convention (csrc/launch.cuh): each makes the card current
only when it is not and sets the thread's earlier device back, so a
wrapper needs no torch.cuda.device context: the mesh path launches on
several cards from one thread, and later work that names no card index
must not land on the last card used.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Tuple

import torch

from ..config import DsrcException
from . import cuda_build
from .rans import MASK, PROB_BITS, RANS_L

_U32 = 0xFFFFFFFF


class LaunchCounter:
    """Thread-safe count of kernel launches."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def count(self) -> int:
        return self._n


LAUNCHES: Dict[str, LaunchCounter] = {
    "rans_encode": LaunchCounter(), "rans_decode": LaunchCounter(),
    "ctx_decode": LaunchCounter(), "hist": LaunchCounter(),
    "a19_decode": LaunchCounter()}


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
    "dsrc_a19_decode": ("a19_dec", (_P, _I, _P, _P, ctypes.POINTER(_I),
                                    ctypes.c_longlong, _I, _I, _I, _P, _I,
                                    _P)),
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


def _stream(idx: int) -> int:
    """The raw current stream of card idx."""
    return torch._C._cuda_getCurrentRawStream(idx)


# --------------------------------------------------------------------------
# K1: encode
# --------------------------------------------------------------------------


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
    idx = payload.get_device()
    rc = _entry("dsrc_rans_decode")(
        payload.data_ptr(), payload.shape[1], states.data_ptr(),
        wptr.data_ptr(), cum.data_ptr(), p, nsym, ne, stride, tile_rows,
        group, lanes, max(0, min(int(num_rec), lanes * group)),
        out.data_ptr(), idx, _stream(idx))
    if rc != 0:
        raise DsrcException(f"rans_decode kernel launch failed: CUDA error "
                            f"{rc}")
    LAUNCHES["rans_decode"].add()
    return out
