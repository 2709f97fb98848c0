"""K3, the band decode of the context-model rANS codec: its wrapper and its
plain PyTorch version.

  K3 ctx_decode_band  csrc/ctx_dec.cu   (TPU: the lax.scan of
                                         dsrc_tpu/ops/ctx.py:decode_ctx_lanes)

One call decodes the steps [t0, t1) of every lane with one table, and
carries each lane's rANS state, word pointer and context carry in tensors
that the call updates in place, so ops/ctx.py can rebuild the table on the
device between bands without a host sync.  The wrapper takes the plain
version only for tensors on the CPU; for CUDA tensors it launches the kernel
or raises.  Each launch adds one to LAUNCHES["ctx_decode"].
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..config import DsrcException
from .rans import MASK, PROB_BITS, RANS_L
from .rans_kernels import LAUNCHES, _check, _entry, _stream

_U32 = 0xFFFFFFFF
MODE_HISTORY = 0       # ctx = carry (order-k packed history)
MODE_PRECOMPUTED = 1   # ctx = aux[lane, t]
MODE_QUALITY = 2       # ctx = coarse(history since the record start) | bucket

# K3 reads a table as rows of packed words, entry j of row r being
# cum[r][j] | cum[r][j + 1] << 16 for j < A and 0xFFFFFFFF after
# (row_layout(A) gives the threads a lane and the entries a thread; a row
# has their product).  Where the rows live (ctx_route):
#   "shared":  packed into each block's shared memory by the kernel, when
#              they take at most CTX_SMEM_BUDGET bytes;
#   "global":  in device memory (rows_packed, one torch pass a band), where
#              L2 holds them.
# The budget leaves two blocks of 8 warps on an SM (2 x 96 KB of 227 KB),
# so the 2,048 lanes of a stream stay resident on 132 SMs.
CTX_SMEM_BUDGET = 96 * 1024
ROUTES = ("shared", "global")
MAX_NSYM = 256


@dataclasses.dataclass(frozen=True)
class CtxMode:
    """How a step's context id and carry follow from the decoded symbols.

    kind MODE_HISTORY:     ctx = carry; carry' = ((carry << sbits) | s) & cmask
    kind MODE_PRECOMPUTED: ctx = aux[lane, t]; no carry
    kind MODE_QUALITY:     h = 0 if aux & 1 (record start) else carry;
                           ctx = coarse(h) | (aux >> 1) << hb;
                           carry' = ((h << sbits) | s) & cmask, sbits = qbits
    coarse(h): for lag k of width w (lags, at most 4), the top w of the
    qbits bits of symbol k of h (newest lowest), packed oldest-last; a lag
    wider than qbits adds w zero bits (the reference's right shift by a
    negative amount, which gives 0 there)."""
    kind: int
    sbits: int = 0
    cmask: int = 0
    hb: int = 0
    lags: Tuple[int, ...] = ()

    @property
    def uses_aux(self) -> bool:
        return self.kind != MODE_HISTORY


def coarse_ctx(h: torch.Tensor, qbits: int, lags: Tuple[int, ...]
               ) -> torch.Tensor:
    """The coarse context of an exact-history carry (CtxMode's coarse):
    lag k's top c of the qbits bits of symbol k, (h >> (k * qbits +
    qbits - c)) & (2^c - 1), packed oldest-last.  One result and one
    scratch tensor, updated in place."""
    ctx = torch.zeros_like(h)
    part = torch.empty_like(h)
    for k, c in enumerate(lags):
        ctx.bitwise_left_shift_(c)
        if c <= qbits:
            torch.bitwise_right_shift(h, k * qbits + qbits - c, out=part)
            ctx.bitwise_or_(part.bitwise_and_((1 << c) - 1))
    return ctx


def ctx_decode_band_plain(payload: torch.Tensor, x: torch.Tensor,
                          wptr: torch.Tensor, carry: torch.Tensor,
                          lengths: torch.Tensor, cum: torch.Tensor,
                          aux, osym: torch.Tensor, octx: torch.Tensor,
                          t0: int, t1: int, mode: CtxMode) -> None:
    """Plain version of K3 (same arguments and effects as ctx_decode_band):
    a Python loop over the band's steps on [L] vectors."""
    lanes, w = payload.shape
    nctx, nsym = cum.shape[0], cum.shape[1] - 1
    row_words = 2 * w
    words = (payload.view(torch.int16).to(torch.int64) & 0xFFFF) \
        .view(lanes, row_words)
    cum64 = cum.to(torch.int64)
    xs = x.to(torch.int64) & _U32
    ptr = wptr.to(torch.int64)
    cr = carry.to(torch.int64)
    lens = lengths.to(torch.int64)
    for t in range(t0, t1):
        act = t < lens
        h = cr
        if mode.kind == MODE_HISTORY:
            ctx = cr
        else:
            a = aux[:, t].to(torch.int64)
            if mode.kind == MODE_PRECOMPUTED:
                ctx = a
            else:
                h = torch.where((a & 1) == 1, 0, cr)
                ctx = coarse_ctx(h, mode.sbits, mode.lags) | \
                    ((a >> 1) << mode.hb)
        ctx = torch.clamp(ctx, 0, nctx - 1)
        rows = cum64[ctx]                                  # [L, A+1]
        slot = xs & MASK
        s = torch.clamp((rows[:, 1:] <= slot[:, None]).sum(1), max=nsym - 1)
        c = rows.gather(1, s[:, None])[:, 0]
        f = rows.gather(1, (s + 1)[:, None])[:, 0] - c
        xn = (f * (xs >> PROB_BITS) + slot - c) & _U32
        need = act & (xn < RANS_L)
        inb = (ptr >= 0) & (ptr < row_words)
        wd = torch.gather(words, 1,
                          torch.clamp(ptr, 0, row_words - 1)[:, None])[:, 0]
        xn = torch.where(need, ((xn << 16) | torch.where(inb, wd, 0)) & _U32,
                         xn)
        xs = torch.where(act, xn, xs)
        ptr = ptr + need.to(torch.int64)
        if mode.kind != MODE_PRECOMPUTED:
            cr = torch.where(act, ((h << mode.sbits) | s) & mode.cmask, cr)
        osym[:, t] = s.to(torch.int32)
        octx[:, t] = ctx.to(torch.int32)
    x.copy_((xs - ((xs >> 31) << 32)).to(torch.int32))
    wptr.copy_(ptr.to(torch.int32))
    carry.copy_(cr.to(torch.int32))


def row_layout(nsym: int) -> Tuple[int, int]:
    """(threads a lane, packed entries a thread) of K3 at an alphabet of
    nsym symbols: 8 threads (4 lanes a warp) up to 8 symbols, 16 (2 lanes)
    up to 64, else 32; entries the power of two that covers nsym."""
    threads = 8 if nsym <= 8 else (16 if nsym <= 64 else 32)
    g = -(-nsym // threads)
    return threads, 1 << (g - 1).bit_length()


def route_smem_bytes(route: str, nctx: int, nsym: int) -> int:
    """Shared memory a K3 block asks for on a route."""
    threads, entries = row_layout(nsym)
    return nctx * 4 * threads * entries if route == "shared" else 0


def ctx_route(nctx: int, nsym: int) -> str:
    """Where K3 reads the rows of a [nctx, nsym + 1] table: "shared" when
    they fit CTX_SMEM_BUDGET, else "global"."""
    if route_smem_bytes("shared", nctx, nsym) <= CTX_SMEM_BUDGET:
        return "shared"
    return "global"


def rows_packed(cum: torch.Tensor, width: int) -> torch.Tensor:
    """K3's rows of a [C, A+1] int32 table, `width` >= A entries a row:
    [C, width] int32 holding the u32 bits of cum[:, j] | cum[:, j+1] << 16,
    then 0xFFFFFFFF (-1)."""
    nsym = cum.shape[1] - 1
    packed = cum[:, :-1] | (cum[:, 1:] << 16)
    return torch.nn.functional.pad(packed, (0, width - nsym),
                                   value=-1).contiguous()


def ctx_decode_band(payload: torch.Tensor, x: torch.Tensor,
                    wptr: torch.Tensor, carry: torch.Tensor,
                    lengths: torch.Tensor, cum: torch.Tensor, aux,
                    osym: torch.Tensor, octx: torch.Tensor, t0: int, t1: int,
                    mode: CtxMode, route: Optional[str] = None) -> None:
    """Decode steps [t0, t1) of every lane with the table cum.

    payload [L, W] int32 (u16 word pairs, low half first); x, wptr, carry
    [L] int32 (x holds u32 bits), updated in place; lengths [L] int32;
    cum [C, A+1] int32, non-decreasing rows with cum[:, 0] = 0 and entries
    below 2^16; aux [L, T] int32 for the modes that read it (None
    otherwise); osym, octx [L, T] int32 receive the band's symbols and
    context ids.  route: where the kernel reads the rows (ROUTES; default
    ctx_route(C, A)); a route the card refuses raises."""
    dev = payload.device
    _check(payload, "payload", torch.int32, 2, dev)
    for t, name in ((x, "x"), (wptr, "wptr"), (carry, "carry"),
                    (lengths, "lengths")):
        _check(t, name, torch.int32, 1, dev)
    _check(cum, "cum", torch.int32, 2, dev)
    _check(osym, "osym", torch.int32, 2, dev)
    _check(octx, "octx", torch.int32, 2, dev)
    lanes = payload.shape[0]
    t_steps = osym.shape[1]
    if any(t.shape[0] != lanes for t in (x, wptr, carry, lengths, osym)) \
            or octx.shape != osym.shape:
        raise DsrcException("ctx_decode: per-lane tensors must have one "
                            "entry per payload row")
    nctx, nsym = cum.shape[0], cum.shape[1] - 1
    if not 2 <= nsym <= MAX_NSYM or nctx < 1:
        raise DsrcException(f"ctx_decode: table [{nctx}, {nsym + 1}] out of "
                            f"range")
    if not 0 <= t0 <= t1 <= t_steps:
        raise DsrcException("ctx_decode: bad band")
    if mode.uses_aux:
        if aux is None:
            raise DsrcException("ctx_decode: this mode needs aux")
        _check(aux, "aux", torch.int32, 2, dev)
        if aux.shape != osym.shape:
            raise DsrcException("ctx_decode: aux must be [L, T]")
    if len(mode.lags) > 4:
        raise DsrcException("ctx_decode: at most 4 lags")
    route = ctx_route(nctx, nsym) if route is None else route
    if route not in ROUTES:
        raise DsrcException(f"ctx_decode: unknown route {route!r}")
    if dev.type == "cpu":
        ctx_decode_band_plain(payload, x, wptr, carry, lengths, cum, aux,
                              osym, octx, t0, t1, mode)
        return
    if dev.type != "cuda":
        raise DsrcException(f"ctx_decode: unsupported device {dev}")
    if lanes == 0 or t0 == t1:
        return
    lags = sum(c << (8 * k) for k, c in enumerate(mode.lags))
    threads, entries = row_layout(nsym)
    rows = rows_packed(cum, threads * entries) if route == "global" else None
    idx = payload.get_device()
    rc = _entry("dsrc_ctx_decode")(
        payload.data_ptr(), payload.shape[1], x.data_ptr(), wptr.data_ptr(),
        carry.data_ptr(), lengths.data_ptr(), cum.data_ptr(),
        None if rows is None else rows.data_ptr(), nctx, nsym,
        aux.data_ptr() if mode.uses_aux else None, t0, t1, t_steps, lanes,
        mode.kind, mode.sbits, mode.cmask, mode.hb,
        mode.sbits if mode.kind == MODE_QUALITY else 0, len(mode.lags), lags,
        threads, entries, ROUTES.index(route), osym.data_ptr(),
        octx.data_ptr(), idx, _stream(idx))
    if rc != 0:
        raise DsrcException(f"ctx_decode kernel launch failed: CUDA error "
                            f"{rc}")
    LAUNCHES["ctx_decode"].add()
