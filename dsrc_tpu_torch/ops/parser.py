"""Vectorized FASTQ parsing on the device (port of
dsrc_tpu/ops/parser.py).

A block's byte tensor is parsed with mask/cumsum/scatter ops: newline
detection, line tables and the record field table are bulk tensor
operations.  A block must contain only whole 4-line records and end with a
newline (guaranteed by io/chunker.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .transform import take_clip

NEWLINE = 10
CR = 13


class ParsedBlock(NamedTuple):
    """Per-record field table (all [max_records], zero past num_records)."""
    num_records: torch.Tensor    # 0-dim int64
    valid: torch.Tensor          # 0-dim bool: structure checks passed
    title_start: torch.Tensor    # position of '@' + 1 (title text)
    title_len: torch.Tensor
    seq_start: torch.Tensor
    seq_len: torch.Tensor
    plus_len: torch.Tensor       # length of '+' line minus 1
    qual_start: torch.Tensor
    qual_len: torch.Tensor


def parse_block(data: torch.Tensor, nbytes: int,
                max_records: int) -> ParsedBlock:
    """Parse a record-aligned FASTQ block into a record field table.

    data: uint8 [cap] (bytes past nbytes must be zero)."""
    cap = data.shape[0]
    dev = data.device
    max_lines = 4 * max_records
    idx = torch.arange(cap, dtype=torch.int64, device=dev)
    nl = (data == NEWLINE) & (idx < nbytes)
    nl_cum = torch.cumsum(nl, dim=0)                      # inclusive, int64
    num_lines = nl_cum[-1] if cap else torch.zeros((), dtype=torch.int64,
                                                   device=dev)
    # ends[k] = byte position of the k-th newline.  Non-newlines and
    # newlines past max_lines go to the spare slot ends[max_lines], which
    # no record reads (the reference's scatter mode="drop").
    line_id = torch.where(nl & (nl_cum - 1 < max_lines), nl_cum - 1,
                          max_lines)
    ends = torch.zeros(max_lines + 1, dtype=torch.int64, device=dev) \
        .scatter_(0, line_id, idx)
    starts = torch.cat([ends.new_zeros(1), ends[:-1] + 1])
    # strip trailing CR from line content
    prev_is_cr = take_clip(data, ends - 1) == CR
    content_ends = torch.where(prev_is_cr & (ends > starts), ends - 1, ends)
    line_len = content_ends - starts

    num_records = num_lines // 4
    r = torch.arange(max_records, dtype=torch.int64, device=dev)
    rec_mask = r < num_records

    def line(k):
        return starts[4 * r + k], line_len[4 * r + k]

    t_start, t_len = line(0)
    s_start, s_len = line(1)
    p_start, p_len = line(2)
    q_start, q_len = line(3)

    first_t = take_clip(data, t_start)
    first_p = take_clip(data, p_start)
    rec_ok = (first_t == ord("@")) & (first_p == ord("+")) & \
        (t_len >= 1) & (s_len >= 1) & (q_len >= 1)
    ok = ((rec_ok | ~rec_mask).all() & (num_lines % 4 == 0)
          & (num_records <= max_records))

    def live(v):
        return torch.where(rec_mask, v, torch.zeros_like(v))

    return ParsedBlock(
        num_records=num_records, valid=ok,
        title_start=live(t_start + 1), title_len=live(t_len - 1),
        seq_start=live(s_start), seq_len=live(s_len),
        plus_len=live(p_len - 1),
        qual_start=live(q_start), qual_len=live(q_len))


def _rec_of(lens: torch.Tensor, total_cap: int):
    """(cum, rec_of [total_cap]): the record of each stream position of the
    concatenated per-record ranges (searchsorted side="right")."""
    cum = torch.cumsum(lens.to(torch.int64), 0)
    j = torch.arange(total_cap, dtype=torch.int64, device=lens.device)
    return cum, j, torch.searchsorted(cum, j, right=True)


def gather_stream(data: torch.Tensor, starts: torch.Tensor,
                  lens: torch.Tensor, total_cap: int):
    """Concatenate per-record byte ranges into one contiguous stream.

    Returns (stream uint8 [total_cap] zero-padded, total (0-dim int64),
    offsets [R] int64: start of each record's range in the stream)."""
    cum, j, rec_of = _rec_of(lens, total_cap)
    offsets = cum - lens
    total = cum[-1] if lens.shape[0] else cum.new_zeros(())
    src = take_clip(starts.to(torch.int64), rec_of) + \
        (j - take_clip(offsets, rec_of))
    out = torch.where(j < total, take_clip(data, src), 0)
    return out.to(torch.uint8), total, offsets


def scatter_stream(stream: torch.Tensor, offsets: torch.Tensor,
                   lens: torch.Tensor, dst_starts: torch.Tensor, cap: int):
    """Inverse of gather_stream: stream[offsets[r]:offsets[r]+lens[r]]
    written at dst_starts[r] of a zeroed uint8 [cap]."""
    cum, j, rec_of = _rec_of(lens, stream.shape[0])
    total = cum[-1] if lens.shape[0] else cum.new_zeros(())
    dst = take_clip(dst_starts.to(torch.int64), rec_of) + \
        (j - take_clip(cum - lens, rec_of))
    dst = torch.where((j < total) & (dst >= 0) & (dst < cap), dst, cap)
    out = torch.zeros(cap + 1, dtype=torch.uint8, device=stream.device)
    out.scatter_(0, dst, stream.to(torch.uint8))
    return out[:cap]


def analyze_block(data: torch.Tensor, parsed: ParsedBlock) -> dict:
    """Dataset-type detection from the first block (reference
    FastqParser::Analyze, FastqParser.cpp:27-138): quality offset by min/max
    scan, colour space by 2nd sequence char in '0123.', '+'-line repetition
    by non-empty '+' lines.  Returns a dict of 0-dim tensors."""
    dev = data.device
    r = torch.arange(parsed.title_start.shape[0], dtype=torch.int64,
                     device=dev)
    rec_mask = r < parsed.num_records
    cap = data.shape[0]
    # mask of quality bytes via the interval-difference trick; slot `cap`
    # collects the masked-out records
    qstarts = torch.where(rec_mask, parsed.qual_start, cap).clamp(max=cap)
    qends = torch.where(rec_mask, parsed.qual_start + parsed.qual_len,
                        cap).clamp(max=cap)
    qmask = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    qmask.index_add_(0, qstarts, torch.ones_like(qstarts))
    qmask.index_add_(0, qends, -torch.ones_like(qends))
    qmask = torch.cumsum(qmask[:-1], dim=0) > 0
    qvals = data.to(torch.int64)
    qmin = torch.where(qmask, qvals, 255).min()
    qmax = torch.where(qmask, qvals, 0).max()
    # reference offset rules (FastqParser.cpp:111-135)
    offset = torch.where(
        (qmax <= 74) & (qmin >= 33), 33,
        torch.where((qmax <= 105) & (qmin >= 64), 64,
                    torch.where(qmin >= 59, 59, 33)))

    second = take_clip(data, parsed.seq_start + 1)
    is_cs_char = ((second >= ord("0")) & (second <= ord("3"))) | \
        (second == ord("."))
    has_rec = parsed.num_records > 0
    color_space = ((is_cs_char & (parsed.seq_len >= 2)) | ~rec_mask).all() \
        & has_rec
    plus_rep = ((parsed.plus_len > 0) | ~rec_mask).all() & has_rec
    plus_none = ((parsed.plus_len == 0) | ~rec_mask).all()
    return dict(quality_offset=offset, color_space=color_space,
                plus_repetition=plus_rep, plus_consistent=plus_rep | plus_none,
                qmin=qmin, qmax=qmax)
