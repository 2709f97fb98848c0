"""The -m2 preset of the port (-d3 -q2 at 256 MB blocks) against dsrc_tpu
on the CPU, where K1, K2 and K3 run their plain versions.

- (a) The CLI's -m2, alone and with -b / -d / -q before or after it, gives
  the same InputParameters, CompressionSettings and BlockShape in both
  packages; BlockShape at 256 and 1024 MB too.
- (b) A file of three -m2-settings blocks (a small block size, the last
  block short) compresses to the reference's bytes, and each package
  decodes the other's archive (the reference's decode compiles for about
  25 s, so it is a test of its own).
- (c) quantize_counts on 19-symbol count vectors (the A19 DNA table, built
  from a whole block's counts) equals the reference's up to a sum of
  268,435,440.  At a sum of 4e8 the reference's int32 arithmetic
  overflows and its table collapses; the port's (int64) stays a valid
  table.  The test asserts that they differ, so the reference's fault
  stays visible.

chip_smoke.py's `m2` phase runs the preset at 256 MB blocks on the card.
"""
import dataclasses
import functools
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsrc_tpu import cli as JCLI
from dsrc_tpu.api import DsrcModule as JaxModule
from dsrc_tpu.config import InputParameters as JaxParams
from dsrc_tpu.models import block as JB
from dsrc_tpu.ops import rans as JR
from dsrc_tpu_torch import cli as TCLI
from dsrc_tpu_torch.api import DsrcModule
from dsrc_tpu_torch.config import InputParameters
from dsrc_tpu_torch.io.archive import ArchiveReader
from dsrc_tpu_torch.io.chunker import FastqChunker
from dsrc_tpu_torch.models import block as TB
from dsrc_tpu_torch.ops.rans import M, quantize_counts
from dsrc_tpu_torch.utils.synth import make_fastq
from torch_jax_codec import jax_codec  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

MB = 1 << 20


def _block_bytes(p) -> int:
    return p.fastq_block_size_bytes or (p.fastq_block_size_mb << 20)


# --------------------------------------------------------------------------
# (a) CLI parsing and block shapes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("opts", [
    ["-m2"], ["-m2", "-b64"], ["-m2", "-b1024"], ["-m2", "-d1"],
    ["-m2", "-q0"], ["-m2", "-b8", "-d2", "-q1"], ["-b16", "-d0", "-m2"],
    ["-m2", "-l", "-c", "-t4"]])
def test_m2_cli_parses_as_the_reference(opts):
    argv = ["c", *opts, "in.fastq", "out.xfqz"]
    jmode, jp, jin, jout = JCLI.parse_args(argv)
    tmode, tp, tin, tout = TCLI.parse_args(argv)
    assert (tmode, tin, tout) == (jmode, jin, jout)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert dataclasses.asdict(tp.to_settings()) == \
        dataclasses.asdict(jp.to_settings())
    assert dataclasses.astuple(TB.BlockShape.for_block_size(
        _block_bytes(tp))) == dataclasses.astuple(
            JB.BlockShape.for_block_size(_block_bytes(jp)))
    if opts == ["-m2"]:
        assert (tp.dna_compression_level, tp.quality_compression_level,
                tp.fastq_block_size_mb) == (3, 2, 256)
        assert (tp.to_settings().dna_order,
                tp.to_settings().quality_order) == (9, 2)


@pytest.mark.parametrize("mb,cap,rcap", [(256, 268_451_840, 16_778_240),
                                         (1024, 1_073_758_208, 67_109_888)])
def test_block_shape_at_256_and_1024_mb(mb, cap, rcap):
    shape = TB.BlockShape.for_block_size(mb * MB)
    assert (shape.cap, shape.rcap) == (cap, rcap)
    assert dataclasses.astuple(shape) == dataclasses.astuple(
        JB.BlockShape.for_block_size(mb * MB))
    # every [cap] index of the port's device code fits int32
    assert cap < 1 << 31


# --------------------------------------------------------------------------
# (b) three -m2-settings blocks, the last one short
# --------------------------------------------------------------------------

M2_BLOCK = 1 << 17
M2_KW = dict(dna_compression_level=3, quality_compression_level=2,
             fastq_block_size_bytes=M2_BLOCK)


@functools.lru_cache(maxsize=1)
def _m2_file():
    """(data, the port's archive of it at the -m2 settings with M2_BLOCK,
    its StreamsInfo).  Three blocks; the last is short, but long enough
    for its streams to take the full blocks' power-of-two lengths, so the
    reference compiles one shape."""
    data = make_fastq(1450, 100, seed=99, markov=True)
    arch = io.BytesIO()
    info = DsrcModule(InputParameters(**M2_KW), device="cpu").compress(
        io.BytesIO(data), arch)
    return data, arch.getvalue(), info


def test_three_m2_blocks_equal_the_reference_and_decode_its_archive(
        jax_codec):
    data, tarch, info = _m2_file()
    sizes = [len(b) for b in FastqChunker(io.BytesIO(data), M2_BLOCK)]
    assert ArchiveReader(io.BytesIO(tarch)).num_blocks == len(sizes) == 3
    assert sizes[-1] < 0.8 * sizes[0]
    assert info.schemes == [("CTX4", "CTX")] * 3
    jarch = io.BytesIO()
    with jax_codec():
        JaxModule(JaxParams(**M2_KW)).compress(io.BytesIO(data), jarch)
    assert tarch == jarch.getvalue()
    out = io.BytesIO()
    DsrcModule(InputParameters(**M2_KW), device="cpu").decompress(
        io.BytesIO(jarch.getvalue()), out)
    assert out.getvalue() == data


def test_reference_decodes_the_ports_three_m2_blocks():
    data, tarch, _ = _m2_file()
    out = io.BytesIO()
    JaxModule(JaxParams(**M2_KW)).decompress(io.BytesIO(tarch), out)
    assert out.getvalue() == data


# --------------------------------------------------------------------------
# (c) quantize_counts of the A19 table: the reference's int32 overflow
# --------------------------------------------------------------------------

def _a19_counts(total: int, seed: int) -> np.ndarray:
    """19 symbol counts summing to `total`: ACGT most, N and the IUPAC
    codes rare, a few absent."""
    rng = np.random.default_rng(seed)
    p = np.concatenate([rng.dirichlet(np.full(4, 20.0)) * 0.99,
                        rng.dirichlet(np.full(15, 0.5)) * 0.01])
    p[[11, 17]] = 0
    c = np.floor(p / p.sum() * total).astype(np.int64)
    c[0] += total - c.sum()
    return c


def _jax_table(counts: np.ndarray) -> np.ndarray:
    return np.asarray(JR.quantize_counts(jnp.asarray(counts, jnp.int32)))


def _port_table(counts: np.ndarray) -> np.ndarray:
    return quantize_counts(torch.from_numpy(counts)).numpy()


@pytest.mark.parametrize("total", [19, 1000, 10**6, 10**8, 2**27,
                                   268_435_440])
def test_a19_table_equals_the_reference_below_the_overflow(total):
    counts = _a19_counts(total, seed=total % 1000)
    assert counts.sum() == total
    got = _port_table(counts)
    assert got.sum() == M and got.min() >= 1
    np.testing.assert_array_equal(got, _jax_table(counts))


@pytest.mark.parametrize("total", [400_000_000, 402_653_184])
def test_a19_table_of_a_larger_block_differs_from_the_collapsed_reference(
        total):
    counts = _a19_counts(total, seed=total % 1000)
    got, ref = _port_table(counts), _jax_table(counts)
    assert got.sum() == M and got.min() >= 1
    # the port's table follows the counts: ACGT take the most of M
    assert got[:4].min() > M // 10
    # the reference's int32 sum wrapped: one symbol holds nearly all of M
    assert not np.array_equal(got, ref)
    assert ref.max() >= M - 19
