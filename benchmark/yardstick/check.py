"""What decides `correct`: the window's answers against the generated input
and against the benchmark's plain reference decoder (refdsrc, a frozen
copy of the port's CPU decode path that imports nothing of the program).

Every number here is a count of faults, and every limit is 0: a lossless
codec gives the input back exactly, and writes the same archive for the
same input every time.
"""
from __future__ import annotations

import io
import struct
from typing import Dict, List, Sequence

import numpy as np

# every generator of yardstick/gen.py writes Sanger (Phred+33) qualities
QUALITY_OFFSET = 33
ALL_FIELDS = 0xFFFFFFFFFFFFFFFF


def record_offsets(data: bytes) -> np.ndarray:
    """Byte offset of each record's start, and the end: [n + 1]."""
    nl = np.flatnonzero(np.frombuffer(data, np.uint8) == 10)[3::4]
    return np.concatenate([[0], nl + 1]).astype(np.int64)


def bytes_wrong(want: bytes, got: bytes) -> int:
    """Bytes that differ, and the difference in length."""
    n = min(len(want), len(got))
    a = np.frombuffer(want, np.uint8, n)
    b = np.frombuffer(got, np.uint8, n)
    return int(np.count_nonzero(a != b)) + abs(len(want) - len(got))


def expected_settings(params: dict) -> dict:
    """The footer settings that InputParameters(**params) states: DNA order
    3 x level, quality order = level (lossless), no lossy binning, CRC as
    asked, every title field kept."""
    return {"dna_order": 3 * int(params.get("dna_compression_level", 0)),
            "quality_order": int(params.get("quality_compression_level", 0)),
            "lossy_quality": False,
            "calculate_crc32": bool(params.get("calculate_crc32", False)),
            "tag_preserve_mask": ALL_FIELDS}


def block_size(params: dict) -> int:
    return int(params.get("fastq_block_size_bytes")
               or int(params.get("fastq_block_size_mb", 8)) << 20)


def container_faults(archive: bytes, params: dict, n_records: int
                     ) -> List[str]:
    """The ways the archive's container departs from what the
    configuration and the input state: header, footer, block index."""
    from refdsrc.io.archive import HEADER_SIZE, ArchiveReader
    try:
        r = ArchiveReader(io.BytesIO(archive))
    except Exception as e:                        # noqa: BLE001
        return [f"unreadable: {e}"]
    faults = []
    footer_offset, footer_size = struct.unpack("<QI", archive[8:20])
    if HEADER_SIZE + sum(r.block_sizes) != footer_offset:
        faults.append("blocks do not end at the footer")
    if footer_offset + footer_size != len(archive):
        faults.append("footer does not end the archive")
    if r.total_records != n_records or sum(r.block_records) != n_records:
        faults.append(f"records {r.total_records} / "
                      f"{sum(r.block_records)}, input {n_records}")
    if r.block_size_bytes != block_size(params):
        faults.append(f"block size {r.block_size_bytes}")
    for k, v in expected_settings(params).items():
        if getattr(r.settings, k) != v:
            faults.append(f"{k} {getattr(r.settings, k)}, stated {v}")
    ds = r.dataset
    if (ds.quality_offset, ds.plus_repetition, ds.color_space) != (
            QUALITY_OFFSET, False, False):
        faults.append(f"dataset {ds}")
    return faults


def reference_block_bytes_wrong(archive: bytes, data: bytes,
                                offsets: np.ndarray,
                                blocks: Sequence[int]) -> Dict[int, int]:
    """Decode each listed block of the archive with the reference, on the
    CPU, and count its bytes that differ from the input's records that
    the block index gives it (a block that does not decode counts all of
    its input bytes)."""
    from refdsrc.io.archive import ArchiveReader
    from refdsrc.models.block import BlockCodec, BlockShape
    r = ArchiveReader(io.BytesIO(archive))
    codec = BlockCodec(BlockShape.for_block_size(r.block_size_bytes),
                       r.settings, r.dataset, "cpu")
    first = np.concatenate([[0], np.cumsum(r.block_records)]).astype(
        np.int64)
    out = {}
    for b in blocks:
        lo = int(offsets[min(first[b], len(offsets) - 1)])
        hi = int(offsets[min(first[b + 1], len(offsets) - 1)])
        want = data[lo:hi]
        try:
            got = codec.decompress(r.read_block(b)).tobytes()
        except Exception:                         # noqa: BLE001
            got = b""
        out[b] = bytes_wrong(want, got)
    return out
