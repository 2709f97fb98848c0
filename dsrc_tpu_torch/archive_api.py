"""Record-at-a-time archive API of the port — the counterpart of
dsrc_tpu/archive_api.py and of the reference's `dsrc::lib::DsrcArchive`
(DsrcArchive.h:25, DsrcArchive.cpp:144-234) and `FastqRecord`/`FastqFile`
(FastqRecord.h:34, FastqFile.cpp).

Write path: records are appended to a text buffer; when it reaches the
FASTQ block size the buffer is compressed as one block on the archive's
device and streamed to the archive (reference: flush when ChunkSize() >
fastqBufferSize, DsrcArchive.cpp:144-168).  Read path: blocks are
decompressed on demand and split into records; the per-block record counts
of the archive index give random access to record i.  The device defaults
to "cuda"; "cpu" runs the kernels' plain PyTorch versions.
"""
from __future__ import annotations

import dataclasses
from typing import BinaryIO, Iterator, Optional, Union

import numpy as np

from .config import DsrcException, InputParameters
from .io.archive import ArchiveReader, ArchiveWriter
from .models.block import BlockCodec, BlockShape
from .utils.device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass
class FastqRecord:
    """One FASTQ record as strings (reference FastqRecord.h:22-33).

    `tag` excludes the leading '@'; `plus` excludes the leading '+'.
    """
    tag: str = ""
    sequence: str = ""
    plus: str = ""
    quality: str = ""

    def to_bytes(self) -> bytes:
        return (f"@{self.tag}\n{self.sequence}\n+{self.plus}\n"
                f"{self.quality}\n").encode()


class DsrcArchive:
    """Record-level archive writer/reader with the reference's method
    surface: StartCompress/WriteNextRecord/FinishCompress and
    StartDecompress/ReadNextRecord/FinishDecompress, on one device."""

    def __init__(self, params: Optional[InputParameters] = None,
                 device=DEFAULT_DEVICE):
        self.params = params or InputParameters()
        self.device = resolve_device(device)
        self._writer: Optional[ArchiveWriter] = None
        self._reader: Optional[ArchiveReader] = None
        self._codec: Optional[BlockCodec] = None
        self._shape: Optional[BlockShape] = None
        self._compressing = False
        self._buf = bytearray()
        self._buf_records = 0
        self._block_size = 0
        self._read_iter: Optional[Iterator[FastqRecord]] = None
        # (block index, first record, records) of the last block read_record
        # decoded; belongs to the open archive only
        self._seek_cache = None

    # ------------------------------------------------------------ write
    def start_compress(self, path: Union[str, BinaryIO]) -> None:
        if self._compressing or self._reader:
            raise DsrcException("archive already open")
        self.params.validate()
        self._block_size = self.params.fastq_block_size_bytes or \
            (self.params.fastq_block_size_mb << 20)
        self._shape = BlockShape.for_block_size(self._block_size)
        self._dest = path
        self._writer = None  # created on the first flush, after analysis
        self._compressing = True
        self._buf = bytearray()
        self._buf_records = 0

    def write_next_record(self, rec: FastqRecord) -> None:
        if not self._compressing:
            raise DsrcException("StartCompress was not called")
        data = rec.to_bytes()
        if len(data) > self._shape.cap:
            raise DsrcException(
                "FASTQ record larger than the block size; "
                "increase the block size (FastqBufferSizeMB)")
        # flush before appending a record that would push the buffer past
        # the block size: BlockShape.cap has only a little slack above it
        if self._buf and len(self._buf) + len(data) > self._block_size:
            self._flush_block()
        self._buf += data
        self._buf_records += 1
        if len(self._buf) >= self._block_size:
            self._flush_block()

    def finish_compress(self) -> None:
        if not self._compressing:
            raise DsrcException("StartCompress was not called")
        if self._buf:
            self._flush_block()
        if self._writer is None:
            raise DsrcException("no records written")
        self._writer.finish()
        self._writer = None
        self._codec = None
        self._compressing = False

    def _flush_block(self) -> None:
        from .api import analyze_first_block
        block = np.frombuffer(bytes(self._buf), np.uint8)
        if self._codec is None:
            settings = self.params.to_settings()
            dataset = analyze_first_block(block, self._shape,
                                          self.params.quality_offset,
                                          self.device)
            self._codec = BlockCodec(self._shape, settings, dataset,
                                     self.device)
            self._writer = ArchiveWriter(self._dest, settings, dataset,
                                         self._block_size)
        blob, _ = self._codec.compress(block)
        self._writer.write_block(blob, self._buf_records)
        self._buf = bytearray()
        self._buf_records = 0

    # ------------------------------------------------------------ read
    def start_decompress(self, path: Union[str, BinaryIO]) -> None:
        if self._writer or self._reader:
            raise DsrcException("archive already open")
        self._reader = ArchiveReader(path)
        shape = BlockShape.for_block_size(self._reader.block_size_bytes)
        self._codec = BlockCodec(shape, self._reader.settings,
                                 self._reader.dataset, self.device)
        self._read_iter = self._records()
        self._seek_cache = None

    def read_next_record(self) -> Optional[FastqRecord]:
        """Next record, or None at end (reference returns false)."""
        if self._read_iter is None:
            raise DsrcException("StartDecompress was not called")
        return next(self._read_iter, None)

    def finish_decompress(self) -> None:
        if self._reader:
            self._reader.close()
        self._reader = None
        self._codec = None
        self._read_iter = None
        self._seek_cache = None

    def _records(self) -> Iterator[FastqRecord]:
        for blob in self._reader:
            yield from iter_fastq_text(self._codec.decompress(blob).tobytes())

    # ------------------------------------------- record random access
    @property
    def record_count(self) -> int:
        """Total records in the open archive (the archive index stores
        per-block counts; the reference reserves recordsCount but never
        fills it, DsrcFile.cpp:88)."""
        if self._reader is None:
            raise DsrcException("StartDecompress was not called")
        return self._reader.total_records

    def read_record(self, i: int) -> FastqRecord:
        """Record i (0-based): seek the owning block through the per-block
        record counts of the archive index and decompress only that block
        (kept for the next call)."""
        recs, first = self._block_records_for(i)
        return recs[i - first]

    def read_records(self, start: int, stop: int) -> Iterator[FastqRecord]:
        """Records [start, stop) by index; decompresses only the blocks
        that overlap the range."""
        for i in range(start, stop):
            yield self.read_record(i)

    def _block_records_for(self, i: int):
        if self._reader is None or self._codec is None:
            raise DsrcException("StartDecompress was not called")
        if not 0 <= i < self._reader.total_records:
            raise DsrcException(
                f"record index {i} out of range "
                f"[0, {self._reader.total_records})")
        counts = self._reader.block_records
        if self._seek_cache is not None:
            bi, first, recs = self._seek_cache
            if first <= i < first + counts[bi]:
                return recs, first
        first = 0
        for bi, n in enumerate(counts):
            if i < first + n:
                break
            first += n
        text = self._codec.decompress(self._reader.read_block(bi)).tobytes()
        recs = list(iter_fastq_text(text))
        if len(recs) != counts[bi]:
            raise DsrcException("archive index record count mismatch")
        self._seek_cache = (bi, first, recs)
        return recs, first

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        # finish by mode, not by whether a writer exists: the ArchiveWriter
        # is created on the first block flush, so a compress session smaller
        # than one block would otherwise exit without writing anything
        if self._compressing:
            if exc and exc[0] is not None:
                self._compressing = False   # do not mask the exception
            elif self._buf or self._writer is not None:
                self.finish_compress()
            else:
                self._compressing = False   # opened but nothing written
        if self._reader is not None:
            self.finish_decompress()


def iter_fastq_text(text: bytes) -> Iterator[FastqRecord]:
    lines = text.split(b"\n")
    for i in range(0, len(lines) - 3, 4):
        yield FastqRecord(
            tag=lines[i][1:].decode(),
            sequence=lines[i + 1].decode(),
            plus=lines[i + 2][1:].decode(),
            quality=lines[i + 3].decode())


class FastqFile:
    """Buffered FASTQ text file reader/writer (reference FastqFile.cpp).

    Modes: 'r' to read records, 'w' to write records.
    """

    def __init__(self, path: Union[str, BinaryIO], mode: str = "r"):
        if mode not in ("r", "w"):
            raise DsrcException(f"invalid FastqFile mode {mode!r}")
        self.mode = mode
        self._own = isinstance(path, str)
        self._f = open(path, mode + "b") if self._own else path

    def read_next_record(self) -> Optional[FastqRecord]:
        if self.mode != "r":
            raise DsrcException("file not open for reading")
        lines = []
        for _ in range(4):
            ln = self._f.readline()
            if not ln:
                if lines:
                    raise DsrcException("truncated FASTQ record")
                return None
            lines.append(ln.rstrip(b"\r\n"))
        if not lines[0].startswith(b"@") or not lines[2].startswith(b"+"):
            raise DsrcException("malformed FASTQ record")
        return FastqRecord(tag=lines[0][1:].decode(),
                           sequence=lines[1].decode(),
                           plus=lines[2][1:].decode(),
                           quality=lines[3].decode())

    def write_next_record(self, rec: FastqRecord) -> None:
        if self.mode != "w":
            raise DsrcException("file not open for writing")
        self._f.write(rec.to_bytes())

    def __iter__(self) -> Iterator[FastqRecord]:
        while True:
            rec = self.read_next_record()
            if rec is None:
                return
            yield rec

    def close(self) -> None:
        if self._own:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
