"""Record transforms of the GENERIC block class (port of
dsrc_tpu/ops/transform.py): DNA chars <-> dense indices, ambiguity folding
into the quality stream (a base with index > 3 and quality < 7 leaves the
DNA stream and is coded in its quality value, reference
RecordsProcessor.cpp:230-243), lossy Illumina 8-bin quality with N <-> bin 0
folding (RecordsProcessor.cpp:318-427), and the stream helpers the quality
codec uses.  Bulk tensor ops on whole block streams; the reference's
scatters with mode="drop" become scatters into one spare slot that is cut
off.
"""
from __future__ import annotations

import torch

from .hist_kernels import hist_count

DNA_CHARS = b"ACGTNRWSKMDVHBYXU.-"
DNA_NSYM = len(DNA_CHARS)  # 19
COLOR_CHARS = b"0123."      # SOLiD colour-space digits (+ unknown)
INVALID_SYM = 31

LOSSY_BOUNDS = (2, 10, 20, 25, 30, 35, 40)       # bin = #bounds <= q
LOSSY_REPS = (0, 6, 15, 22, 27, 33, 37, 40)      # representative per bin

FOLD_BASE = 128   # folded-base marker region in the quality stream
HASH_QUAL = 2     # quality value of '#' at offset 33 (truncation symbol)


def _lut(chars: bytes, fill: int) -> torch.Tensor:
    lut = torch.full((256,), fill, dtype=torch.uint8)
    for i, ch in enumerate(chars):
        lut[ch] = i
    return lut


_DNA_LUT = _lut(DNA_CHARS, INVALID_SYM)
_DNA_UNLUT = torch.tensor(list(DNA_CHARS), dtype=torch.uint8)
_COLOR_LUT = _lut(COLOR_CHARS, INVALID_SYM)
_COLOR_UNLUT = torch.tensor(list(COLOR_CHARS), dtype=torch.uint8)


def _remap(data: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    return torch.index_select(lut.to(data.device), 0,
                              data.to(torch.int32))


def _unmap(syms: torch.Tensor, unlut: torch.Tensor) -> torch.Tensor:
    """Dense indices -> uint8 chars; an index outside the alphabet gives
    0."""
    n = len(unlut)
    chars = torch.index_select(unlut.to(syms.device), 0,
                               syms.to(torch.int32).clamp_(0, n - 1))
    return chars.masked_fill_((syms < 0) | (syms >= n), 0)


def dna_remap(data: torch.Tensor) -> torch.Tensor:
    """uint8 bytes -> dense DNA indices (INVALID_SYM outside the
    alphabet), uint8."""
    return _remap(data, _DNA_LUT)


def dna_unmap(syms: torch.Tensor) -> torch.Tensor:
    return _unmap(syms, _DNA_UNLUT)


def color_remap(data: torch.Tensor) -> torch.Tensor:
    """uint8 colour-space bytes -> indices into "0123." (INVALID_SYM
    outside it), uint8."""
    return _remap(data, _COLOR_LUT)


def color_unmap(syms: torch.Tensor) -> torch.Tensor:
    return _unmap(syms, _COLOR_UNLUT)


def compact(values: torch.Tensor, keep: torch.Tensor, size: int):
    """Stream compaction: values[keep] left-packed into zeros of length
    size.  Returns (packed, count).  The kept positions come from one
    nonzero (int64, as long as the count; a host sync)."""
    sel = torch.nonzero(keep).view(-1)
    count = sel.shape[0]
    out = torch.zeros(size, dtype=values.dtype, device=values.device)
    torch.index_select(values, 0, sel, out=out[:count])
    return out, count


def expand_positions(keep: torch.Tensor) -> torch.Tensor:
    """For each position, its index in the compacted stream (int32; valid
    where keep).  The scan runs in place: cumsum with a wider dtype would
    copy its input first."""
    return keep.to(torch.int32).cumsum_(0).sub_(1)


def pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    """x zero-padded to length n."""
    return torch.nn.functional.pad(x, (0, n - x.shape[0]))


def take_clip(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[idx] for a 1-D idx, indices clipped into range (jnp.take
    mode="clip"), gathered with int32 or int64 indices as given."""
    return torch.index_select(arr, 0, torch.clamp(idx, 0, arr.shape[0] - 1))


# --------------------------------------------------------------------------
# Lossless forward / backward (ambiguity folding)
# --------------------------------------------------------------------------
# The forward transforms take the n live positions of a block's streams
# and return int16 quality values (a folded value can exceed 255 when a
# symbol outside the alphabet folds) and the uint8 DNA stream packed into
# `cap` zeros.

def forward_lossless(seq_sym: torch.Tensor, qual: torch.Tensor, cap: int):
    """seq_sym uint8 [n], qual int16 [n] (consumed: folded in place).
    Returns (dna uint8 [cap] left-packed, dna_total, qual)."""
    fold = (seq_sym > 3) & (qual < 7)
    add = seq_sym.to(torch.int16)
    add.sub_(2).mul_(8).add_(FOLD_BASE - 16).mul_(fold)
    qual += add
    del add
    dna, dna_total = compact(seq_sym, fold.logical_not_(), cap)
    return dna, dna_total, qual


def backward_lossless(dna: torch.Tensor, qual_enc: torch.Tensor):
    """Invert forward_lossless on the n live positions: dna [>= kept]
    symbols, qual_enc int16 [n] (consumed: unfolded in place).  Returns
    (seq_sym uint8 [n], qual)."""
    fold = qual_enc >= FOLD_BASE
    idx_folded = qual_enc.sub(FOLD_BASE - 16).bitwise_right_shift_(3) \
        .add_(2).mul_(fold)
    qual_enc.sub_(idx_folded.sub(2).mul_(8).add_(FOLD_BASE - 16).mul_(fold))
    seq_sym = idx_folded.to(torch.uint8)
    del idx_folded
    keep = fold.logical_not_()
    src = expand_positions(keep)
    seq_sym.add_(take_clip(dna, src).mul_(keep))
    return seq_sym, qual_enc


# --------------------------------------------------------------------------
# Lossy forward / backward (Illumina binning + N <-> bin-0 folding)
# --------------------------------------------------------------------------

def quality_bin(qual: torch.Tensor) -> torch.Tensor:
    """Bin of each quality value, int16."""
    b = torch.zeros(qual.shape, dtype=torch.int16, device=qual.device)
    for t in LOSSY_BOUNDS:
        b.add_(qual >= t)
    return b


def quality_unbin(bins: torch.Tensor) -> torch.Tensor:
    """Representative of each bin in [0, 8), int16 (others give 0)."""
    reps = torch.tensor(LOSSY_REPS + (0,), dtype=torch.int16,
                        device=bins.device)
    return torch.index_select(reps, 0, bins.to(torch.int32).clamp_(0, 8)
                              .masked_fill_(bins < 0, 8))


def forward_lossy(seq_sym: torch.Tensor, qual: torch.Tensor, cap: int):
    """Quality -> 8 bins; ambiguous bases force bin 0 and leave the DNA
    stream; any bin-0 position decodes as N (lossy by design).  Returns
    (dna uint8 [cap], dna_total, bins int16 [n])."""
    bins = quality_bin(qual).masked_fill_(seq_sym > 3, 0)
    dna, dna_total = compact(seq_sym, bins != 0, cap)
    return dna, dna_total, bins


def backward_lossy(dna: torch.Tensor, bins: torch.Tensor):
    """Inverse on the n live positions: (seq_sym uint8 [n], qual int16
    [n])."""
    keep = bins != 0
    src = expand_positions(keep)
    seq_sym = take_clip(dna, src).to(torch.uint8)
    del src
    seq_sym.masked_fill_(keep.logical_not_(), 4)               # N
    return seq_sym, quality_unbin(bins)


# --------------------------------------------------------------------------
# Stats for scheme selection
# --------------------------------------------------------------------------

SCATTER_SLICE = 1 << 25


def segment_max(values: torch.Tensor, seg_ids: torch.Tensor,
                num_seg: int) -> torch.Tensor:
    """Per-segment max, floored at 0 (the reference's zero-initialised
    scatter-max); ids outside [0, num_seg) are dropped.  The scatter takes
    an int64 index, so a long stream goes in slices of SCATTER_SLICE."""
    out = torch.zeros(num_seg + 1, dtype=values.dtype, device=values.device)
    for a in range(0, values.shape[0], SCATTER_SLICE):
        ids = seg_ids[a:a + SCATTER_SLICE]
        idx = ids.to(torch.int64).masked_fill_((ids < 0) | (ids >= num_seg),
                                               num_seg)
        out.scatter_reduce_(0, idx, values[a:a + SCATTER_SLICE],
                            reduce="amax", include_self=True)
    return out[:num_seg]


def histogram(values: torch.Tensor, nsym: int,
              active: torch.Tensor = None) -> torch.Tensor:
    """Counts (int64) of the values in [0, nsym) (of the active ones, when
    a mask is given): K5's flat form (ops/hist_kernels.hist_count)."""
    out = torch.zeros(nsym + 1, dtype=torch.int64, device=values.device)
    hist_count(out, values.contiguous(),
               None if active is None else active.contiguous())
    return out[:nsym]
