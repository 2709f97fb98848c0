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

LOSSY_REPS = (0, 6, 15, 22, 27, 33, 37, 40)      # representative per bin

FOLD_BASE = 128   # folded-base marker region in the quality stream


def _lut(chars: bytes, fill: int) -> torch.Tensor:
    lut = torch.full((256,), fill, dtype=torch.uint8)
    for i, ch in enumerate(chars):
        lut[ch] = i
    return lut


_DNA_UNLUT = torch.tensor(list(DNA_CHARS), dtype=torch.uint8)
_COLOR_UNLUT = torch.tensor(list(COLOR_CHARS), dtype=torch.uint8)


def _unmap(syms: torch.Tensor, unlut: torch.Tensor) -> torch.Tensor:
    """Dense indices -> uint8 chars; an index outside the alphabet gives
    0."""
    n = len(unlut)
    chars = torch.index_select(unlut.to(syms.device), 0,
                               syms.to(torch.int32).clamp_(0, n - 1))
    return chars.masked_fill_((syms < 0) | (syms >= n), 0)


def dna_unmap(syms: torch.Tensor) -> torch.Tensor:
    return _unmap(syms, _DNA_UNLUT)


def color_unmap(syms: torch.Tensor) -> torch.Tensor:
    return _unmap(syms, _COLOR_UNLUT)


def expand_positions(keep: torch.Tensor) -> torch.Tensor:
    """For each position, its index in the compacted stream (int32; valid
    where keep).  The scan runs in place: cumsum with a wider dtype would
    copy its input first."""
    return keep.to(torch.int32).cumsum_(0).sub_(1)


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


def quality_unbin(bins: torch.Tensor) -> torch.Tensor:
    """Representative of each bin in [0, 8), int16 (others give 0)."""
    reps = torch.tensor(LOSSY_REPS + (0,), dtype=torch.int16,
                        device=bins.device)
    return torch.index_select(reps, 0, bins.to(torch.int32).clamp_(0, 8)
                              .masked_fill_(bins < 0, 8))


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


