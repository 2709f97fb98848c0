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

DNA_CHARS = b"ACGTNRWSKMDVHBYXU.-"
DNA_NSYM = len(DNA_CHARS)  # 19
COLOR_CHARS = b"0123."      # SOLiD colour-space digits (+ unknown)
INVALID_SYM = 31

LOSSY_BOUNDS = (2, 10, 20, 25, 30, 35, 40)       # bin = #bounds <= q
LOSSY_REPS = (0, 6, 15, 22, 27, 33, 37, 40)      # representative per bin

FOLD_BASE = 128   # folded-base marker region in the quality stream
HASH_QUAL = 2     # quality value of '#' at offset 33 (truncation symbol)


def _lut(chars: bytes, fill: int) -> torch.Tensor:
    lut = torch.full((256,), fill, dtype=torch.int32)
    for i, ch in enumerate(chars):
        lut[ch] = i
    return lut


_DNA_LUT = _lut(DNA_CHARS, INVALID_SYM)
_DNA_UNLUT = torch.tensor(list(DNA_CHARS), dtype=torch.uint8)
_COLOR_LUT = _lut(COLOR_CHARS, INVALID_SYM)
_COLOR_UNLUT = torch.tensor(list(COLOR_CHARS), dtype=torch.uint8)


def _unmap(syms: torch.Tensor, unlut: torch.Tensor) -> torch.Tensor:
    """Dense indices -> uint8 chars; an index outside the alphabet gives
    0."""
    s = syms.to(torch.int64)
    ok = (s >= 0) & (s < len(unlut))
    chars = unlut.to(syms.device)[torch.clamp(s, 0, len(unlut) - 1)]
    return torch.where(ok, chars, torch.zeros_like(chars))


def dna_remap(data: torch.Tensor) -> torch.Tensor:
    """uint8 bytes -> dense DNA indices (INVALID_SYM outside the
    alphabet), int32."""
    return _DNA_LUT.to(data.device)[data.to(torch.int64)]


def dna_unmap(syms: torch.Tensor) -> torch.Tensor:
    return _unmap(syms, _DNA_UNLUT)


def color_remap(data: torch.Tensor) -> torch.Tensor:
    """uint8 colour-space bytes -> indices into "0123." (INVALID_SYM
    outside it), int32."""
    return _COLOR_LUT.to(data.device)[data.to(torch.int64)]


def color_unmap(syms: torch.Tensor) -> torch.Tensor:
    return _unmap(syms, _COLOR_UNLUT)


def compact(values: torch.Tensor, keep: torch.Tensor):
    """Stream compaction: values[keep] left-packed, zero-padded.  Returns
    (packed [n], count as a 0-dim int64 tensor)."""
    n = values.shape[0]
    k = keep.to(torch.int64)
    pos = torch.where(keep, torch.cumsum(k, 0) - k, n)
    out = torch.zeros(n + 1, dtype=values.dtype, device=values.device)
    out.scatter_(0, pos, values)
    return out[:n], k.sum()


def expand_positions(keep: torch.Tensor) -> torch.Tensor:
    """For each position, its index in the compacted stream (valid where
    keep)."""
    k = keep.to(torch.int64)
    return torch.cumsum(k, 0) - k


def take_clip(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[idx] with indices clipped into range (jnp.take mode="clip")."""
    return arr[torch.clamp(idx, 0, arr.shape[0] - 1)]


# --------------------------------------------------------------------------
# Lossless forward / backward (ambiguity folding)
# --------------------------------------------------------------------------

def forward_lossless(seq_sym: torch.Tensor, qual: torch.Tensor,
                     active: torch.Tensor):
    """Returns (dna [S] left-packed indices, dna_total, qual_out [S],
    fold [S])."""
    fold = (seq_sym > 3) & (qual < 7) & active
    qual_out = torch.where(fold, qual + FOLD_BASE + ((seq_sym - 2) << 3) - 16,
                           qual)
    dna, dna_total = compact(seq_sym, active & ~fold)
    return dna, dna_total, qual_out, fold


def backward_lossless(dna: torch.Tensor, qual_enc: torch.Tensor,
                      active: torch.Tensor):
    """Invert forward_lossless.  Returns (seq_sym [S], qual [S])."""
    fold = (qual_enc >= FOLD_BASE) & active
    idx_folded = ((qual_enc - FOLD_BASE + 16) >> 3) + 2
    qual = torch.where(fold,
                       qual_enc - FOLD_BASE - ((idx_folded - 2) << 3) + 16,
                       qual_enc)
    src = expand_positions(active & ~fold)
    seq_sym = torch.where(fold, idx_folded, take_clip(dna, src))
    return torch.where(active, seq_sym, 0), qual


# --------------------------------------------------------------------------
# Lossy forward / backward (Illumina binning + N <-> bin-0 folding)
# --------------------------------------------------------------------------

def quality_bin(qual: torch.Tensor) -> torch.Tensor:
    b = torch.zeros(qual.shape, dtype=torch.int32, device=qual.device)
    for t in LOSSY_BOUNDS:
        b = b + (qual >= t).to(torch.int32)
    return b


def quality_unbin(bins: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(bins.shape, dtype=torch.int32, device=bins.device)
    for i, rep in enumerate(LOSSY_REPS):
        out = torch.where(bins == i, rep, out)
    return out


def forward_lossy(seq_sym: torch.Tensor, qual: torch.Tensor,
                  active: torch.Tensor):
    """Quality -> 8 bins; ambiguous bases force bin 0 and leave the DNA
    stream; any bin-0 position decodes as N (lossy by design)."""
    bins = quality_bin(qual)
    bins = torch.where((seq_sym > 3) & active, 0, bins)
    dna, dna_total = compact(seq_sym, active & (bins != 0))
    return dna, dna_total, bins


def backward_lossy(dna: torch.Tensor, bins: torch.Tensor,
                   active: torch.Tensor):
    keep = active & (bins != 0)
    src = expand_positions(keep)
    seq_sym = torch.where(keep, take_clip(dna, src), 4)          # N
    seq_sym = torch.where(active, seq_sym, 0)
    qual = torch.where(active, quality_unbin(bins), 0)
    return seq_sym, qual


# --------------------------------------------------------------------------
# Stats for scheme selection
# --------------------------------------------------------------------------

def segment_max(values: torch.Tensor, seg_ids: torch.Tensor,
                num_seg: int) -> torch.Tensor:
    """Per-segment max, floored at 0 (the reference's zero-initialised
    scatter-max); ids outside [0, num_seg) are dropped."""
    ok = (seg_ids >= 0) & (seg_ids < num_seg)
    idx = torch.where(ok, seg_ids.to(torch.int64), num_seg)
    out = torch.zeros(num_seg + 1, dtype=values.dtype, device=values.device)
    out.scatter_reduce_(0, idx, values, reduce="amax", include_self=True)
    return out[:num_seg]


def segment_sum(values: torch.Tensor, seg_ids: torch.Tensor,
                num_seg: int) -> torch.Tensor:
    ok = (seg_ids >= 0) & (seg_ids < num_seg)
    idx = torch.where(ok, seg_ids.to(torch.int64), num_seg)
    out = torch.zeros(num_seg + 1, dtype=values.dtype, device=values.device)
    out.scatter_add_(0, idx, values)
    return out[:num_seg]


def histogram(values: torch.Tensor, nsym: int,
              active: torch.Tensor) -> torch.Tensor:
    """Counts (int64) of the active values in [0, nsym)."""
    return segment_sum(active.to(torch.int64),
                       torch.where(active, values.to(torch.int64), nsym),
                       nsym)
