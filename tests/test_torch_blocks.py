"""Block-level parity of the PyTorch port with dsrc_tpu: for every block of
the golden UNIFORM and SEMI inputs, the port's BlockCodec writes the JAX
BlockCodec's exact blob, and the compressed-block dicts cross between the
two packages' device codecs through dsrc_tpu_torch.convert.

Block size 1 << 17, as tests/test_golden_archive.py compresses them, so
the JAX side compiles the same small shapes.
"""
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsrc_tpu import api as JAPI
from dsrc_tpu.io.chunker import FastqChunker
from dsrc_tpu.models import block as JB
from dsrc_tpu.models import tag as JTAG
from dsrc_tpu.parallel import uniform_pipeline as JUP
from dsrc_tpu_torch import api as TAPI
from dsrc_tpu_torch import convert
from dsrc_tpu_torch.config import InputParameters
from dsrc_tpu_torch.models import block as TB
from dsrc_tpu_torch.parallel import uniform_pipeline as TUP
from torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
BLOCK = 1 << 17
CPU = torch.device("cpu")


def _blocks(name):
    data = open(os.path.join(DATA, name + ".fastq"), "rb").read()
    ch = FastqChunker(io.BytesIO(data), BLOCK)
    return list(ch)


def _codecs(first):
    settings = InputParameters().to_settings()
    jshape = JB.BlockShape.for_block_size(BLOCK)
    tshape = TB.BlockShape.for_block_size(BLOCK)
    assert (jshape.cap, jshape.rcap) == (tshape.cap, tshape.rcap)
    jds = JAPI.analyze_first_block(first, jshape)
    tds = TAPI.analyze_first_block(first, tshape, device="cpu")
    assert (jds.quality_offset, jds.plus_repetition, jds.color_space) == \
        (tds.quality_offset, tds.plus_repetition, tds.color_space)
    return (JB.BlockCodec(jshape, settings, jds),
            TB.BlockCodec(tshape, settings, tds, device="cpu"))


@pytest.mark.parametrize("name,scheme", [("golden_uniform", TB.BLOCK_UNIFORM),
                                         ("golden_semi", TB.BLOCK_SEMI)])
def test_port_blobs_equal_jax_blobs(name, scheme):
    blocks = _blocks(name)
    assert len(blocks) == 3
    jcodec, tcodec = _codecs(blocks[0])
    for i, block in enumerate(blocks):
        jblob, jinfo = jcodec.compress(block)
        tblob, tinfo = tcodec.compress(block)
        assert tblob[0] == scheme
        assert tblob == jblob, f"{name} block {i}: blobs differ"
        assert (tinfo.raw, tinfo.comp) == (jinfo.raw, jinfo.comp)
        np.testing.assert_array_equal(tcodec.decompress(jblob), block)


def _semi_inputs(block):
    """Staged SEMI mode-2 device inputs of one block, shared by both
    packages: (vpad, v0, qm, sm, num_rec, pcs, read_len, rpad)."""
    read_len, num_rec, qm, sm, tstream, tl = TB.stage_semi_raw(block)
    rpad = TB._rpad_bucket(num_rec) + 256
    vmat, _meta = JTAG.analyze_value_fields(np.asarray(tstream, np.uint8),
                                            np.asarray(tl))
    v0, pcs = TB.semi_tok_planes(vmat, num_rec)
    vpad = np.zeros((rpad, vmat.shape[1]), np.int32)
    vpad[:num_rec] = vmat
    return (vpad, v0, np.ascontiguousarray(qm[:rpad]),
            np.ascontiguousarray(sm[:rpad]), num_rec, pcs, read_len, rpad)


def test_semi_comp_crosses_between_packages():
    """JAX compress_semi_tok -> convert -> port decompress, and port
    compress -> convert -> JAX decompress, both exact."""
    vpad, v0, qm, sm, num_rec, pcs, read_len, rpad = \
        _semi_inputs(_blocks("golden_semi")[0])
    jcomp = JUP.compress_semi_tok(
        jnp.asarray(vpad), jnp.asarray(v0), jnp.asarray(qm), jnp.asarray(sm),
        jnp.int32(num_rec), pcs, read_len, rpad)
    tcomp = TUP.compress_semi_tok(
        torch.from_numpy(vpad), torch.from_numpy(v0), torch.from_numpy(qm),
        torch.from_numpy(sm), num_rec, pcs, read_len, rpad)
    jnp_comp = {k: v for k, v in jcomp.items() if k != "comp_bytes"}
    tnp_comp = convert.comp_to_numpy(tcomp)
    for key in ("title", "qual"):
        for a, b in zip(tnp_comp[key], jnp_comp[key]):
            np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(tnp_comp["dna"], jnp_comp["dna"]):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert int(tnp_comp["qual_mode"]) == int(jcomp["qual_mode"])

    want = (vpad[:num_rec], qm[:num_rec], sm[:num_rec])
    got_t = TUP.decompress_semi_tok(
        convert.comp_from_numpy(jnp_comp, CPU), torch.from_numpy(v0), pcs,
        read_len, rpad)
    got_j = JUP.decompress_semi_tok(
        {k: (tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple)
             else jnp.asarray(v)) for k, v in tnp_comp.items()},
        jnp.asarray(v0), pcs, read_len, rpad)
    for got in (got_t, got_j):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g)[:num_rec], w)
