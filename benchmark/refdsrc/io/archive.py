"""`.xfqz` archive container — block-indexed, self-describing.

Information-equivalent to the reference `.dsrc` format (DsrcFile.h:26-75,
DsrcFile.cpp:38-254): a fixed header written last (so the writer streams
blocks first), concatenated compressed blocks in order, and a footer with the
per-block size index plus all settings needed for flag-free decompression.
Improvements over the reference: per-block *record counts* are stored (the
reference reserves but never fills recordsCount, DsrcFile.cpp:88), enabling
true random access and resumable/multi-host runs (SURVEY.md §5.4).

Header (32 bytes, offset 0):
  magic "XFQZ", version u8=2, flags u8, reserved u16,
  footer_offset u64, footer_size u32, block_count u64, pad u32
Footer:
  varint block_size_bytes (codec capacity)
  varint total_records
  settings: dna_order u8, quality_order u8, flags u8 {lossy, crc32},
            tag_preserve_mask u64
  dataset: quality_offset u8, flags u8 {plus_repetition, color_space}
  block index: block_count × (varint comp_size, varint rec_count)
"""
from __future__ import annotations

import io
import struct
from typing import BinaryIO, Iterator, List, Union


from ..config import CompressionSettings, DatasetType, DsrcException

MAGIC = b"XFQZ"
# v3: uniform/semi block headers carry their wire-format layout parameters
# (lane groups, alphabets, PROB_BITS) so decoder retuning cannot break old
# archives; v2 blocks relied on build constants that have since changed.
VERSION = 3
HEADER_SIZE = 32

_SET_LOSSY = 1
_SET_CRC = 2
_DS_PLUS_REP = 1
_DS_COLOR = 2


def _read_varint(f: BinaryIO) -> int:
    v, shift = 0, 0
    while True:
        b = f.read(1)
        if not b:
            raise DsrcException("archive truncated (varint)")
        v |= (b[0] & 0x7F) << shift
        if not b[0] & 0x80:
            return v
        shift += 7


class ArchiveReader:
    """Random-access block reader (reference DsrcFileReader,
    DsrcFile.cpp:186-254)."""

    def __init__(self, src: Union[str, BinaryIO]):
        self._own = isinstance(src, str)
        self._f: BinaryIO = open(src, "rb") if self._own else src
        f = self._f
        head = f.read(HEADER_SIZE)
        if len(head) < HEADER_SIZE or head[:4] != MAGIC:
            raise DsrcException("not an XFQZ archive")
        version = head[4]
        if version != VERSION:
            hint = (" (written by an older build whose block layout "
                    "constants differ; re-compress the source FASTQ)"
                    if version < VERSION else "")
            raise DsrcException(
                f"unsupported archive version {version}{hint}")
        footer_offset, footer_size, block_count, _ = struct.unpack(
            "<QIQI", head[8:32])
        f.seek(footer_offset)
        footer = f.read(footer_size)
        if len(footer) != footer_size:
            raise DsrcException("archive truncated (footer)")
        buf = io.BytesIO(footer)
        self.block_size_bytes = _read_varint(buf)
        self.total_records = _read_varint(buf)
        d, q, sflags = struct.unpack("<BBB", buf.read(3))
        (mask,) = struct.unpack("<Q", buf.read(8))
        self.settings = CompressionSettings(
            dna_order=d, quality_order=q,
            lossy_quality=bool(sflags & _SET_LOSSY),
            tag_preserve_mask=mask,
            calculate_crc32=bool(sflags & _SET_CRC))
        off, dflags = struct.unpack("<BB", buf.read(2))
        self.dataset = DatasetType(
            quality_offset=off,
            plus_repetition=bool(dflags & _DS_PLUS_REP),
            color_space=bool(dflags & _DS_COLOR))
        self.block_sizes: List[int] = []
        self.block_records: List[int] = []
        for _ in range(block_count):
            self.block_sizes.append(_read_varint(buf))
            self.block_records.append(_read_varint(buf))
        self._offsets = [HEADER_SIZE]
        for s in self.block_sizes:
            self._offsets.append(self._offsets[-1] + s)

    @property
    def num_blocks(self) -> int:
        return len(self.block_sizes)

    def read_block(self, i: int) -> bytes:
        if not 0 <= i < self.num_blocks:
            raise DsrcException(f"block index {i} out of range")
        self._f.seek(self._offsets[i])
        blob = self._f.read(self.block_sizes[i])
        if len(blob) != self.block_sizes[i]:
            raise DsrcException("archive truncated (block)")
        return blob

    def __iter__(self) -> Iterator[bytes]:
        for i in range(self.num_blocks):
            yield self.read_block(i)

    def close(self) -> None:
        if self._own:
            self._f.close()
