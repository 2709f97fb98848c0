"""The port's FastqChunker (dsrc_tpu_torch/io/chunker.py) against
dsrc_tpu's, block for block.

The port reads each block once into a buffer of its own and returns a view,
with the block's record count from the record scan; dsrc_tpu joins the
source's reads and copies.  Each case gives both the same bytes (the port's
through an odd source where the case says so): equal blocks, each record
count equal to the block's newlines / 4, and the same DsrcException where
the input is malformed.
"""
import io

import numpy as np
import pytest

from dsrc_tpu.config import DsrcException as JaxDsrcException
from dsrc_tpu.io.chunker import FastqChunker as JaxChunker
from dsrc_tpu_torch.config import DsrcException
from dsrc_tpu_torch.io.chunker import FastqChunker
from dsrc_tpu_torch.utils.synth import make_fastq_realistic
from torch_threads import one_torch_thread  # noqa: F401

DATA = make_fastq_realistic(1000, 100, seed=21)


class ShortReads(io.RawIOBase):
    """A source whose readinto and read return at most 1,000 bytes."""

    def __init__(self, data: bytes):
        self._src = io.BytesIO(data)

    def readable(self):
        return True

    def readinto(self, buf):
        view = memoryview(buf)[:1000]
        return self._src.readinto(view)


class ReadOnly:
    """A source with read and no readinto."""

    def __init__(self, data: bytes):
        self._src = io.BytesIO(data)

    def read(self, n: int = -1) -> bytes:
        return self._src.read(n)


def _long_record() -> bytes:
    """Two short records round one of 20,000 bases, longer than a 4,096-byte
    block: the chunker grows its block until the record fits."""
    short = b"\n".join(DATA.split(b"\n", 4)[:4]) + b"\n"
    seq = bytes(np.random.default_rng(5).choice(list(b"ACGT"), 20000)
                .astype(np.uint8))
    return short + b"@long\n" + seq + b"\n+\n" + b"I" * 20000 + b"\n" + short


CASES = {
    "block_4096": (DATA, 4096, io.BytesIO),
    "block_6000": (DATA, 6000, io.BytesIO),
    "block_64k": (DATA, 1 << 16, io.BytesIO),
    "block_whole_file": (DATA, 1 << 20, io.BytesIO),
    "short_reads": (DATA, 6000, ShortReads),
    "no_readinto": (DATA, 6000, ReadOnly),
    "no_final_newline": (DATA[:-1], 6000, io.BytesIO),
    "record_longer_than_block": (_long_record(), 4096, io.BytesIO),
    "line_count_not_multiple_of_4": (DATA + b"@extra\nACGT\n", 6000,
                                     io.BytesIO),
}


def _reference(data: bytes, block_size: int):
    """dsrc_tpu's blocks, or its exception's message."""
    try:
        return [b.tobytes() for b in JaxChunker(io.BytesIO(data),
                                                block_size)]
    except JaxDsrcException as e:
        return str(e)


def _port(data: bytes, block_size: int, source):
    """The port's blocks with their record counts, or its exception's
    message."""
    chunker = FastqChunker(source(data), block_size)
    out = []
    try:
        while (got := chunker.next_with_count()) is not None:
            out.append(got)
    except DsrcException as e:
        return str(e)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_blocks_and_counts_equal_dsrc_tpus(case):
    data, block_size, source = CASES[case]
    ref = _reference(data, block_size)
    got = _port(data, block_size, source)
    if case == "line_count_not_multiple_of_4":
        assert isinstance(ref, str) and got == ref
        return
    assert isinstance(ref, list) and len(ref) >= 1
    if case.startswith("block_") and block_size < len(data):
        assert len(ref) >= 3
    assert [b.tobytes() for b, _ in got] == ref
    for block, nrec in got:
        assert block.dtype == np.uint8 and block[-1] == 10
        assert nrec == int(np.count_nonzero(block == 10)) // 4 > 0
    if case == "record_longer_than_block":
        assert max(len(b) for b in ref) > 40000
    # next_block gives the same blocks
    blocks = list(FastqChunker(source(data), block_size))
    assert [b.tobytes() for b in blocks] == ref
