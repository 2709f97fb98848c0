"""Host-side FASTQ chunking into record-aligned blocks.

Counterpart of the reference's IFastqStreamReader::ReadNextChunk
(FastqStream.cpp:18-98), which scans backward near the chunk end for a record
start using '@'/'+' heuristics.  We use a simpler *exact* rule instead:
FASTQ records are 4 lines, and the chunker reads sequentially, so the running
newline count identifies record boundaries unambiguously — a chunk ends after
the last newline whose cumulative line index is a multiple of 4.  The cut
tail is carried into the next chunk.

Each block is read once: into a buffer of its own (`readinto`, or `read` and
one copy for a source without it), behind the tail the previous block left,
and returned as a view.  The native library's record scan (utils/native.py)
gives the cut and the block's line count.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from ..config import DsrcException
from ..utils.native import scan_records as _count_and_last_boundary

_EMPTY = np.empty(0, np.uint8)


class FastqChunker:
    """Split a byte stream of FASTQ text into record-aligned blocks.

    Feed with `read(n)`-style source; yields numpy uint8 arrays, each
    containing whole records and ending with a newline.
    """

    def __init__(self, source, block_size: int):
        self._source = source
        self._readinto = getattr(source, "readinto", None)
        self._block_size = max(block_size, 1 << 12)
        self._tail = _EMPTY
        self._lines_seen = 0
        self._eof = False

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            chunk = self.next_block()
            if chunk is None:
                return
            yield chunk

    def next_block(self) -> Optional[np.ndarray]:
        got = self.next_with_count()
        return None if got is None else got[0]

    def next_with_count(self) -> Optional[Tuple[np.ndarray, int]]:
        """The next block and the number of records in it, or None at the
        end of the input."""
        if self._eof and not len(self._tail):
            return None
        # the spare byte holds the final newline when the input lacks one
        buf = np.empty(self._block_size + 1, np.uint8)
        size = len(self._tail)
        buf[:size] = self._tail
        while size < self._block_size and not self._eof:
            n = self._fill(buf[size:self._block_size])
            if not n:
                self._eof = True
                break
            size += n
        if not size:
            return None
        if self._eof:
            if buf[size - 1] != 10:
                buf[size] = 10  # terminate final record
                size += 1
            arr = buf[:size]
            nl, _ = _count_and_last_boundary(arr, self._lines_seen)
            if (self._lines_seen + nl) % 4 != 0:
                raise DsrcException(
                    "malformed FASTQ: total line count not a multiple of 4")
            self._lines_seen += nl
            self._tail = _EMPTY
            return arr, nl // 4
        arr = buf[:size]
        nl, cut = _count_and_last_boundary(arr, self._lines_seen)
        if cut < 0:
            # no full record in a whole block: grow by retrying with a
            # larger effective block (pathological ultra-long records)
            self._tail = arr
            self._block_size *= 2
            return self.next_with_count()
        # the lines up to the cut: the scan's count less the tail's, which
        # are fewer than a record's
        cut_lines = nl - (self._lines_seen + nl) % 4
        self._tail = arr[cut:]
        self._lines_seen += cut_lines
        return arr[:cut], cut_lines // 4

    def _fill(self, view: np.ndarray) -> int:
        """Read at most len(view) bytes of the source into view; 0 at the
        end of the input."""
        if self._readinto is not None:
            return self._readinto(memoryview(view)) or 0
        data = self._source.read(len(view)) or b""
        view[:len(data)] = np.frombuffer(data, np.uint8)
        return len(data)
