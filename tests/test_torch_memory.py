"""Peak device memory of one GENERIC block of the port, per byte of block
capacity, on the CPU (tests/torch_memtrack.py counts the live tensor
storages as the card would hold them).

Every case runs analyze_first_block, BlockCodec.compress and
BlockCodec.decompress on one block that fills its capacity, at two sizes
(the second twice the records of the first).  The bound is on the slope,
(peak(cap2) - peak(cap1)) / (cap2 - cap1): the model tables (a quality
context histogram is up to 4,096 x 64 int64 bins) do not grow with the
capacity and would decide a per-byte figure at these sizes.  24 bytes a
byte of capacity keeps two 1 GB blocks in flight inside an 80 GB card.
Each case also round-trips its blocks byte-exactly (-l: on its lossy
fixed point).
"""
import numpy as np
import pytest

from dsrc_tpu_torch.api import analyze_first_block
from dsrc_tpu_torch.config import InputParameters
from dsrc_tpu_torch.models.block import BlockCodec, BlockShape
from dsrc_tpu_torch.utils.synth import make_fastq, make_fastq_realistic
from torch_memtrack import peak_bytes
from torch_threads import one_torch_thread  # noqa: F401

BYTES_PER_CAP = 24
RECORDS = 3000          # the smaller block; the larger has twice as many

CASES = {
    "d2q2": (lambda n: make_fastq_realistic(n, 100, seed=1),
             dict(dna_compression_level=2, quality_compression_level=2)),
    "d3q2": (lambda n: make_fastq_realistic(n, 100, seed=2),
             dict(dna_compression_level=3, quality_compression_level=2)),
    "d1q1": (lambda n: make_fastq_realistic(n, 100, seed=3),
             dict(dna_compression_level=1, quality_compression_level=1)),
    "d0q0_variable": (lambda n: make_fastq(n, 100, variable_length=True,
                                           seed=4), dict()),
    "lossy": (lambda n: make_fastq_realistic(n, 100, seed=5,
                                             platform="novaseq"),
              dict(lossy_quality=True, quality_compression_level=2)),
    "colour_crc": (lambda n: make_fastq(n, 50, color_space=True, seed=7),
                   dict(dna_compression_level=2, quality_compression_level=2,
                        calculate_crc32=True)),
}


def _block_peaks(data: bytes, kw: dict, lossy: bool):
    """(capacity, peak bytes of analysis, compress, decompress) of one
    block holding all of data."""
    shape = BlockShape.for_block_size(len(data))
    block = np.frombuffer(data, np.uint8)
    ds, analyze = peak_bytes(
        lambda: analyze_first_block(block, shape, device="cpu"))
    codec = BlockCodec(shape, InputParameters(**kw).to_settings(), ds,
                       device="cpu")
    (blob, _info), comp = peak_bytes(lambda: codec.compress(block))
    text, decomp = peak_bytes(lambda: codec.decompress(blob))
    if lossy:
        # the lossy fixed point: its archive decodes to itself
        data = text.tobytes()
        text = codec.decompress(codec.compress(text)[0])
    assert text.tobytes() == data
    return shape.cap, analyze.peak, comp.peak, decomp.peak


@pytest.mark.parametrize("case", list(CASES))
def test_generic_block_memory_per_byte_of_capacity(case):
    gen, kw = CASES[case]
    lossy = kw.get("lossy_quality", False)
    small = _block_peaks(gen(RECORDS), kw, lossy)
    large = _block_peaks(gen(2 * RECORDS), kw, lossy)
    dcap = large[0] - small[0]
    for k, stage in enumerate(("analyze", "compress", "decompress"), 1):
        slope = (large[k] - small[k]) / dcap
        assert slope <= BYTES_PER_CAP, \
            f"{case} {stage}: {slope:.2f} bytes a byte of capacity"
        assert large[k] > 0
