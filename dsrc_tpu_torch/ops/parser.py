"""Vectorized FASTQ parsing on the device (port of
dsrc_tpu/ops/parser.py).

A block's byte tensor is parsed with bulk tensor operations: the newline
positions come from one nonzero, the line tables and the record field
table are int32 gathers.  A block must contain only whole 4-line records
and end with a newline (guaranteed by io/chunker.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .streams import item
from .transform import take_clip

NEWLINE = 10
CR = 13


class ParsedBlock(NamedTuple):
    """Per-record field table (all int32 [max_records], zero past
    num_records)."""
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

    data: uint8 [>= nbytes]; only data[:nbytes] is read.  The newline
    positions come from one nonzero (int64, one entry a line; a host
    sync); the line and record tables are int32."""
    dev = data.device
    max_lines = 4 * max_records
    nl_pos = torch.nonzero(data[:nbytes] == NEWLINE).view(-1)
    num_lines = nl_pos.shape[0]
    # ends[k] = byte position of the k-th newline; newlines past max_lines
    # are dropped and the spare slot ends[max_lines] is read by no record
    # (the reference's scatter mode="drop")
    ends = torch.zeros(max_lines + 1, dtype=torch.int32, device=dev)
    k = min(num_lines, max_lines)
    ends[:k] = nl_pos[:k]
    del nl_pos
    starts = torch.zeros_like(ends)
    torch.add(ends[:-1], 1, out=starts[1:])
    # strip trailing CR from line content
    strip = (take_clip(data, ends - 1) == CR) & (ends > starts)
    line_len = ends.sub_(starts).sub_(strip.to(torch.int8))
    del strip

    num_records = num_lines // 4
    rec_mask = torch.arange(max_records, dtype=torch.int32,
                            device=dev) < num_records

    def line(k):
        return (starts[:max_lines].view(max_records, 4)[:, k],
                line_len[:max_lines].view(max_records, 4)[:, k])

    t_start, t_len = line(0)
    s_start, s_len = line(1)
    p_start, p_len = line(2)
    q_start, q_len = line(3)

    first_t = take_clip(data, t_start)
    first_p = take_clip(data, p_start)
    rec_ok = (first_t == ord("@")) & (first_p == ord("+")) & \
        (t_len >= 1) & (s_len >= 1) & (q_len >= 1)
    ok = (rec_ok | ~rec_mask).all() & (num_lines % 4 == 0) \
        & (num_records <= max_records)

    def live(v):
        return torch.where(rec_mask, v, 0)

    return ParsedBlock(
        num_records=torch.full((), num_records, dtype=torch.int64,
                               device=dev),
        valid=ok,
        title_start=live(t_start + 1), title_len=live(t_len - 1),
        seq_start=live(s_start), seq_len=live(s_len),
        plus_len=live(p_len - 1),
        qual_start=live(q_start), qual_len=live(q_len))


def gather_stream(data: torch.Tensor, starts: torch.Tensor,
                  lens: torch.Tensor, total_cap: int):
    """Concatenate per-record byte ranges into one contiguous stream.

    Returns (stream uint8 [total_cap] zero-padded, total (int; a host
    sync), offsets [R] int32: start of each record's range in the
    stream).  Positions are int32 and only the first `total` are
    computed: every capacity is below 2^31 (models/block.BlockShape)."""
    cum = torch.cumsum(lens, 0, dtype=torch.int32)
    offsets = cum - lens
    total = min(item(cum[-1]), total_cap) if lens.shape[0] else 0
    out = torch.zeros(total_cap, dtype=torch.uint8, device=data.device)
    if total:
        j = torch.arange(total, dtype=torch.int32, device=data.device)
        src = torch.index_select(
            (starts - offsets).to(torch.int32), 0,
            torch.searchsorted(cum, j, right=True, out_int32=True))
        src.add_(j).clamp_(0, data.shape[0] - 1)
        del j
        torch.index_select(data, 0, src, out=out[:total])
    return out, total, offsets


def scatter_stream(stream: torch.Tensor, offsets: torch.Tensor,
                   lens: torch.Tensor, dst_starts: torch.Tensor, cap: int):
    """Inverse of gather_stream: stream[offsets[r]:offsets[r]+lens[r]]
    written at dst_starts[r] of a zeroed uint8 [cap]."""
    cum = torch.cumsum(lens, 0, dtype=torch.int32)
    total = min(item(cum[-1]), stream.shape[0]) if lens.shape[0] else 0
    out = torch.zeros(cap + 1, dtype=torch.uint8, device=stream.device)
    if total:
        j = torch.arange(total, dtype=torch.int32, device=stream.device)
        dst = torch.index_select(
            (dst_starts - (cum - lens)).to(torch.int32), 0,
            torch.searchsorted(cum, j, right=True, out_int32=True))
        dst.add_(j)
        dst.masked_fill_((dst < 0) | (dst >= cap), cap)
        out.scatter_(0, dst.to(torch.int64), stream[:total].to(torch.uint8))
    return out[:cap]


def analyze_block(data: torch.Tensor, parsed: ParsedBlock) -> dict:
    """Dataset-type detection from the first block (reference
    FastqParser::Analyze, FastqParser.cpp:27-138): quality offset by min/max
    scan, colour space by 2nd sequence char in '0123.', '+'-line repetition
    by non-empty '+' lines.  Returns a dict of 0-dim tensors."""
    dev = data.device
    rec_mask = torch.arange(parsed.title_start.shape[0], dtype=torch.int32,
                            device=dev) < parsed.num_records
    n = data.shape[0]
    # mask of quality bytes via the interval-difference trick over the
    # live records (a host sync for their count): +1 at each range's start,
    # -1 at its end; slot n takes ends at the last byte.  The int8 running
    # sum stays in {0, 1}: a block's quality ranges are disjoint.
    nrec = item(parsed.num_records)
    qs = parsed.qual_start[:nrec].clamp(max=n)
    qe = (parsed.qual_start[:nrec] + parsed.qual_len[:nrec]).clamp_(max=n)
    edge = torch.zeros(n + 1, dtype=torch.int8, device=dev)
    for idx, step in ((qs, 1), (qe, -1)):
        edge.index_add_(0, idx, torch.full((1,), step, dtype=torch.int8,
                                           device=dev).expand(nrec))
    del qs, qe
    qmask = torch.cumsum(edge[:-1], 0, dtype=torch.int8) > 0
    del edge
    qmin = torch.where(qmask, data, 255).min().to(torch.int64)
    qmax = torch.where(qmask, data, 0).max().to(torch.int64)
    del qmask
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
