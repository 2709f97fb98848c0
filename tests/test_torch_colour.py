"""Colour space (SOLiD reads: a primer base, then one colour digit of
"0123." per quality value) on the port's GENERIC path against dsrc_tpu on
the CPU, where K1 and K3 run their plain versions.

- color_remap / color_unmap equal the reference's on every byte and index.
- Archives equal the reference's, and the port decodes the reference's
  archive: lossless at a sample of -d0..3 -q0..2, reads with and without
  '.', variable read lengths, -c (CRC of the digits, the primer left out)
  and -l (a colour above 3 forces bin 0, and bin 0 decodes as '.').  Equal
  bytes make "the reference decodes the port's archive" the reference
  decoding its own.

No golden colour-space archive exists: the reference's archive is built
here (tests/torch_jax_codec.py), with 1 << 17-byte blocks.
"""
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsrc_tpu.api import DsrcModule as JaxModule
from dsrc_tpu.config import InputParameters as JaxParams
from dsrc_tpu.ops import transform as JT
from dsrc_tpu_torch.api import DsrcModule
from dsrc_tpu_torch.config import InputParameters
from dsrc_tpu_torch.ops import transform as TT
from dsrc_tpu_torch.utils.synth import make_fastq
from torch_jax_codec import jax_codec  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

BLOCK = 1 << 17


def test_color_remap_and_unmap_equal_jax():
    data = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(
        TT.color_remap(torch.from_numpy(data)).numpy(),
        np.asarray(JT.color_remap(jnp.asarray(data))))
    syms = np.arange(-3, 40, dtype=np.int32)
    np.testing.assert_array_equal(
        TT.color_unmap(torch.from_numpy(syms)).numpy(),
        np.asarray(JT.color_unmap(jnp.asarray(syms))))
    assert TT.COLOR_CHARS == JT.COLOR_CHARS
    assert TT.color_remap(torch.tensor([ord("A")], dtype=torch.uint8)) \
        .item() == TT.INVALID_SYM


def _solid(name: str) -> bytes:
    """SOLiD reads of 50 colours ('.' where a base call failed, about 2%
    of them, unless the case says "nodots")."""
    seed = sum(name.encode())
    if name == "variable":
        return make_fastq(500, 50, color_space=True, variable_length=True,
                          n_base_prob=0.02, seed=seed)
    dots = 0.0 if name.endswith("nodots") else 0.02
    return make_fastq(500, 50, color_space=True, n_base_prob=dots,
                      seed=seed)


CASES = {
    "d0q0": dict(),
    "d0q0_nodots": dict(),
    "d1q1": dict(dna_compression_level=1, quality_compression_level=1),
    "d2q2": dict(dna_compression_level=2, quality_compression_level=2),
    "d3q0": dict(dna_compression_level=3),
    "d2q1_nodots": dict(dna_compression_level=2,
                        quality_compression_level=1),
    "variable": dict(dna_compression_level=1),
    "crc": dict(dna_compression_level=2, quality_compression_level=2,
                calculate_crc32=True),
    "lossy": dict(lossy_quality=True, dna_compression_level=1,
                  quality_compression_level=1),
}


def _lossy_fixed_point(data: bytes) -> bytes:
    """What a lossy archive of SOLiD data decodes to: titles and primers
    kept; each quality binned to its bin's representative; a colour whose
    bin is 0 (a quality below 2, or a colour above 3) decodes as '.'."""
    lines = data.split(b"\n")
    for i in range(1, len(lines) - 1, 4):
        q = np.frombuffer(lines[i + 2], np.uint8).astype(np.int64) - 33
        col = np.frombuffer(lines[i][1:], np.uint8)
        bins = np.searchsorted(TT.LOSSY_BOUNDS, q, side="right")
        bins[col == ord(".")] = 0
        reps = np.asarray(TT.LOSSY_REPS)[bins] + 33
        lines[i] = lines[i][:1] + np.where(bins == 0, ord("."), col).astype(
            np.uint8).tobytes()
        lines[i + 2] = reps.astype(np.uint8).tobytes()
    return b"\n".join(lines)


@pytest.mark.parametrize("name", list(CASES))
def test_colour_space_archives_equal_jax(jax_codec, name):
    data, kw = _solid(name), CASES[name]
    has_dots = b"." in b"".join(data.split(b"\n")[1::4])
    assert has_dots == (not name.endswith("nodots"))
    params = dict(fastq_block_size_bytes=BLOCK, **kw)
    jarch = io.BytesIO()
    with jax_codec():
        JaxModule(JaxParams(**params)).compress(io.BytesIO(data), jarch)
    tmod = DsrcModule(InputParameters(**params), device="cpu")
    tarch = io.BytesIO()
    info = tmod.compress(io.BytesIO(data), tarch)
    dna_scheme = info.schemes[0][0]
    if not has_dots and kw.get("dna_compression_level", 0) == 0:
        assert dna_scheme == "PACK2"
    else:
        assert dna_scheme in ("CTX4", "CTX8"), dna_scheme
        assert (dna_scheme == "CTX8") == has_dots
    assert tarch.getvalue() == jarch.getvalue()
    out = io.BytesIO()
    tmod.decompress(io.BytesIO(jarch.getvalue()), out)
    want = _lossy_fixed_point(data) if kw.get("lossy_quality") else data
    assert out.getvalue() == want
