"""K5, the masked integer histogram: its wrapper and its plain PyTorch
versions.

  K5 hist_count, hist_count_ctx, pos_hist   csrc/hist.cu
      (TPU: the matrix-unit histograms dsrc_tpu/ops/ctx.py:_hist_mxu and
       dsrc_tpu/parallel/uniform_pipeline.py:_pos_hist, int8 one-hot
       matmuls, no Pallas)

One function in three forms, each adding the counts of the kept elements
into an int64 histogram:

  flat        hist_count      bin = ids[i], kept where mask[i] and
                              0 <= ids[i] < nbins (the block codec's
                              value histograms, the context-model encode)
  context     hist_count_ctx  bin = clamp(ctx, 0, C - 1) * A + sym over
                              the columns [t0, t1) of [L, T] tensors, kept
                              where 0 <= sym < A and t < lengths[l] (the
                              context-model decode's band)
  positional  pos_hist        bin = p * A + mat[r, p] over the first
                              num_rec rows of mat [Rpad, P] (the UNIFORM and
                              SEMI positional tables)

The flat and context forms add into the caller's hist of nbins + 1 bins:
hist[:nbins] takes the counts and hist[nbins] is scratch, where the plain
versions drop the elements they do not keep (the kernel issues nothing
for them).  The wrappers take the plain versions only for tensors on the
CPU; for CUDA tensors they launch the kernel or raise.  Each launch adds
one to LAUNCHES["hist"].

Routes (hist_route picks one before the launch; a route the card refuses
raises, and no other is tried):
  shared   a block's u32 copy of nbins * 4 bytes within HIST_SMEM_BUDGET,
           at least SHARED_MIN_PER_BIN elements a bin
  global   64-bit global atomics: anything wider or sparser
The card's tests and chip_smoke.py force either through _ROUTE.
k5_variants.py times two alternatives that were faster at no call of the
main paths on an H100 (PERF.md, section 6): a copy of the bins for each
warp, and one copy spread over a thread-block cluster.
A flat call is read by 16-byte vector loads from the first element whose
value and mask are both 16-byte aligned (vector_head), and a context band
4 steps of a lane at a time where it is aligned so, except on the global
route, which takes an element a thread.  launch_plan gives a route's
launch arguments; flat_bin_ids, ctx_bin_ids and pos_bin_keys build the
plain versions' bin ids.
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple

import torch

from ..config import DsrcException
from .rans_kernels import LAUNCHES, _entry, _stream

# dynamic shared memory a block may use: all of the 227 KB an H100 block
# can opt in to
HIST_SMEM_BUDGET = 227 * 1024
# the shared route's floor (see hist_route): elements a bin below which a
# block's zeroing and flushing of its private copy cost more than global
# atomics
SHARED_MIN_PER_BIN = 16
ROUTES = ("shared", "global")
# the route of every launch in place of hist_route's choice when set (the
# card's tests and chip_smoke.py set it to drive each route)
_ROUTE: Optional[str] = None
VALUE_TYPES = (torch.uint8, torch.int16, torch.int32, torch.int64)
# a value type's code in the C entry point and its bytes
_VTYPE = {t: (i, t.itemsize) for i, t in enumerate(VALUE_TYPES)}
_FLAT, _COLUMN, _CONTEXT = 0, 1, 2
# the C entry point's packed arguments (csrc/hist.cu HistArgs): vals, ctx,
# mask, lengths, hist, stream (0 for none), ld, then vtype, t0, rows,
# cols, hi_kind, nsym, nctx, nbins, route, device and the launch_plan
# (vec head, quads)
_ARGS = struct.Struct("<6Qq12i")


def route_holds(route: str, nbins: int) -> bool:
    """Whether a launch on `route` can hold nbins bins."""
    if route == "shared":
        return nbins * 4 <= HIST_SMEM_BUDGET
    return route == "global"


def hist_route(nbins: int, n: Optional[int] = None) -> str:
    """"shared" when a u32 copy of nbins bins fits HIST_SMEM_BUDGET and the
    call counts at least SHARED_MIN_PER_BIN elements a bin (n; None: any
    number); else "global".  A block of the shared route zeroes and
    flushes every bin; the global route costs a launch and one atomic an
    element, at a rate each SM bounds.  SHARED_MIN_PER_BIN is the least
    of chip_smoke.py's route sweep's crossovers on an H100 for skewed ids
    at every width from 4,096 to 58,112 bins (uniform ids cross at 32)."""
    if nbins * 4 > HIST_SMEM_BUDGET:
        return "global"
    if n is not None and n < SHARED_MIN_PER_BIN * nbins:
        return "global"
    return "shared"


def vector_head(n: int, vals_addr: int, esize: int,
                mask_addr: Optional[int] = None) -> int:
    """The first element of a flat call's vector reads: the least i with
    vals_addr + i * esize and mask_addr + i both 16-byte aligned (at most
    15); -1 when no i is (the two addresses disagree) or the n elements
    hold no whole chunk of 16 from i on."""
    if mask_addr is None:
        head = (-vals_addr % 16) // esize
    else:
        head = -mask_addr % 16
        if (vals_addr + head * esize) % 16:
            return -1
    return head if head + 16 <= n else -1


def read_plan(n: int, hi_kind: int, vals_addr: int, esize: int,
              mask_addr: Optional[int] = None, ctx_addr: int = 0,
              t0: int = 0, cols: int = 0, ld: int = 0) -> Tuple[int, int]:
    """How a block reads a call: (vec_head, quads).  vec_head: a flat
    call's first vector chunk (vector_head), -1 for a call read otherwise;
    quads 1: a context band read 4 steps at a time (t0, cols and ld
    multiples of 4, the symbols' and contexts' addresses 16-byte
    aligned)."""
    if hi_kind == _FLAT:
        return vector_head(n, vals_addr, esize, mask_addr), 0
    if hi_kind == _CONTEXT:
        return -1, int((t0 | cols | ld) % 4 == 0
                       and (vals_addr | ctx_addr) % 16 == 0)
    return -1, 0


def launch_plan(route: str, nbins: int, n: int, hi_kind: int,
                vals_addr: int, esize: int, mask_addr: Optional[int] = None,
                ctx_addr: int = 0, t0: int = 0, cols: int = 0, ld: int = 0
                ) -> Tuple[int, int]:
    """The launch arguments a call adds to its view and bins on `route`:
    (vec_head, quads), read_plan's on the shared route.  The global route
    reads element by element (-1, 0): vector chunks would leave most of
    its threads, and the SMs they run on, without work.  Raises when the
    route cannot hold the bins."""
    if route == "global":
        return -1, 0
    if route not in ROUTES or not route_holds(route, nbins):
        raise DsrcException(f"K5 route {route!r} cannot hold {nbins} bins")
    return read_plan(n, hi_kind, vals_addr, esize, mask_addr, ctx_addr, t0,
                     cols, ld)


# The checks below run on every launch, so they read the cheapest tensor
# attributes: numel() and dim() stand for shapes where they suffice.

def _check_hist(hist: torch.Tensor, name: str) -> int:
    """The bins of a [nbins + 1] int64 histogram (the last is scratch)."""
    if hist.dtype != torch.int64 or hist.dim() != 1 \
            or not hist.is_contiguous() or hist.numel() < 2:
        raise DsrcException(f"{name}: hist must be a contiguous 1-d int64 "
                            f"tensor of nbins + 1 entries")
    return hist.numel() - 1


def _check_device(t: torch.Tensor, name: str, hist: torch.Tensor) -> None:
    if t.device != hist.device:
        raise DsrcException(f"{name} on {t.device}, expected {hist.device}")


def _launch(name: str, hist: torch.Tensor, vals: torch.Tensor, ld: int,
            t0: int, rows: int, cols: int, hi_kind: int, nsym: int,
            nctx: int, nbins: int, ctx: Optional[torch.Tensor] = None,
            mask: Optional[torch.Tensor] = None,
            lengths: Optional[torch.Tensor] = None) -> None:
    """One K5 launch over the [rows, cols] view of vals at row stride ld
    and first column t0, adding into hist[:nbins], on the current stream
    of hist's card (the C entry point makes that card current for the
    launch only)."""
    idx = hist.get_device()
    if idx < 0:
        raise DsrcException(f"{name}: unsupported device {hist.device}")
    n = rows * cols
    if n >= 2**31 or nbins >= 2**31:
        raise DsrcException(f"{name}: {rows} x {cols} elements into "
                            f"{nbins} bins: too many")
    if n == 0:
        return
    vtype, esize = _VTYPE[vals.dtype]
    vals_addr = vals.data_ptr()
    mask_addr = None if mask is None else mask.data_ptr()
    ctx_addr = 0 if ctx is None else ctx.data_ptr()
    route = _ROUTE or hist_route(nbins, n)
    plan = launch_plan(route, nbins, n, hi_kind, vals_addr, esize, mask_addr,
                       ctx_addr, t0, cols, ld)
    rc = _entry("dsrc_hist")(_ARGS.pack(
        vals_addr, ctx_addr, mask_addr or 0,
        0 if lengths is None else lengths.data_ptr(), hist.data_ptr(),
        _stream(idx), ld, vtype, t0, rows, cols,
        hi_kind, nsym, nctx, nbins, ROUTES.index(route), idx, *plan))
    if rc != 0:
        raise DsrcException(f"{name} kernel launch failed ({route} route): "
                            f"CUDA error {rc}")
    LAUNCHES["hist"].add()


# --------------------------------------------------------------------------
# Flat form
# --------------------------------------------------------------------------

def _index_add(hist: torch.Tensor, ids: torch.Tensor) -> None:
    hist.index_add_(0, ids.reshape(-1), torch.ones(
        1, dtype=torch.int64, device=hist.device).expand(ids.numel()))


# --------------------------------------------------------------------------
# Context form
# --------------------------------------------------------------------------

def ctx_bin_ids(ctx: torch.Tensor, sym: torch.Tensor, nsym: int,
                lengths: torch.Tensor, t0: int, t1: int,
                nbins: int) -> torch.Tensor:
    """The context form's int32 bin ids [L, t1 - t0] of the band [t0, t1),
    the dropped ones (t >= lengths[l], sym outside [0, nsym)) set to the
    scratch bin nbins."""
    s = sym[:, t0:t1]
    ids = ctx[:, t0:t1].clamp(0, nbins // nsym - 1).mul_(nsym).add_(s)
    keep = torch.arange(t0, t1, dtype=torch.int32, device=ids.device)[
        None, :] < lengths[:, None]
    keep &= (s >= 0) & (s < nsym)
    return ids.masked_fill_(~keep, nbins)


def hist_count_ctx_plain(hist: torch.Tensor, ctx: torch.Tensor,
                         sym: torch.Tensor, nsym: int, lengths: torch.Tensor,
                         t0: int, t1: int) -> None:
    """Plain version of hist_count_ctx: the band's int32 bin ids, then one
    index_add_, the dropped ones sent to the scratch bin."""
    _index_add(hist, ctx_bin_ids(ctx, sym, nsym, lengths, t0, t1,
                                 hist.shape[0] - 1))


def hist_count_ctx(hist: torch.Tensor, ctx: torch.Tensor, sym: torch.Tensor,
                   nsym: int, lengths: torch.Tensor, t0: int,
                   t1: int) -> None:
    """hist[:nbins] += counts of clamp(ctx, 0, C - 1) * nsym + sym over the
    steps [t0, t1) of every lane l with t < lengths[l] and 0 <= sym < nsym,
    C = nbins // nsym, nbins = hist.shape[0] - 1 (a multiple of nsym);
    hist[nbins] is scratch.  ctx, sym: [L, T] int32, contiguous; lengths
    [L] int32."""
    nbins = _check_hist(hist, "hist_count_ctx")
    for t, name in ((ctx, "ctx"), (sym, "sym")):
        if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous():
            raise DsrcException(f"hist_count_ctx: {name} must be a "
                                f"contiguous [L, T] int32 tensor")
        _check_device(t, f"hist_count_ctx {name}", hist)
    if ctx.shape != sym.shape:
        raise DsrcException("hist_count_ctx: ctx and sym differ in shape")
    lanes, t_steps = sym.shape
    if lengths.dtype != torch.int32 or lengths.dim() != 1 \
            or lengths.numel() != lanes or not lengths.is_contiguous():
        raise DsrcException("hist_count_ctx: lengths must be [L] int32")
    _check_device(lengths, "hist_count_ctx lengths", hist)
    if nsym < 1 or nbins % nsym != 0:
        raise DsrcException(f"hist_count_ctx: {nbins} bins are no whole "
                            f"number of rows of {nsym}")
    if not 0 <= t0 <= t1 <= t_steps:
        raise DsrcException("hist_count_ctx: bad band")
    if hist.is_cpu:
        hist_count_ctx_plain(hist, ctx, sym, nsym, lengths, t0, t1)
        return
    _launch("hist_count_ctx", hist, sym, t_steps, t0, lanes, t1 - t0,
            _CONTEXT, nsym, nbins // nsym, nbins, ctx=ctx,
            lengths=lengths)


# --------------------------------------------------------------------------
# Positional form
# --------------------------------------------------------------------------


