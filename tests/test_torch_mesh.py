"""The port's mesh path on the CPU: parallel/mesh.py and the mesh branches
of api.py, over device lists that name the CPU more than once.

- dryrun round-trips UNIFORM and title mode 2 SEMI batches over 2 and 4
  entries.
- MeshUniformCodec and MeshSemiCodec write the port's BlockCodec blobs and
  dsrc_tpu's MeshUniformCodec / MeshSemiCodec blobs (JAX on two of its
  virtual CPU devices) for the same blocks.
- DsrcModule with a mesh of [cpu] * 4 writes the one-device archive and
  decodes it byte-exactly: a SEMI file, a UNIFORM + SEMI file, and a file
  with title mode 0 blocks, whose blobs are each parsed once on decode.
- The seeding order: a block that passes the host staging but fails the
  uniformity check, then a semi block, give the one-device bytes.
"""
import io
import threading

import jax
import numpy as np
import pytest
import torch

from dsrc_tpu.parallel import mesh as JM
from dsrc_tpu_torch import api as TAPI
from dsrc_tpu_torch.api import DsrcModule
from dsrc_tpu_torch.config import InputParameters
from dsrc_tpu_torch.io.archive import ArchiveReader
from dsrc_tpu_torch.io.chunker import FastqChunker
from dsrc_tpu_torch.models import block as TB
from dsrc_tpu_torch.models import tag as TTAG
from dsrc_tpu_torch.parallel import mesh as TM
from dsrc_tpu_torch.utils.synth import make_fastq_fast
from test_torch_blocks import _blocks, _codecs
from test_torch_semi0 import _regime_file, _semi_modes
from torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun(n):
    TM.dryrun([CPU] * n, records_per_block=32, read_len=20)


def test_on_devices_threads_for_cards_keep_order_and_raise():
    """A list of cards runs on one thread an entry (fn here touches no
    card, so the descriptors need none), results in order, the first
    error raised; CPU entries run on the calling thread."""
    seen = set()

    def fn(device, x):
        seen.add(threading.get_ident())
        if x == 3:
            raise ValueError("device 3 failed")
        return x * 10

    cards = [torch.device("cuda", i) for i in range(4)]
    assert TM.on_devices(cards[:3], fn, [0, 1, 2]) == [0, 10, 20]
    assert threading.get_ident() not in seen
    with pytest.raises(ValueError, match="device 3"):
        TM.on_devices(cards, fn, [0, 1, 2, 3])
    seen.clear()
    assert TM.on_devices([CPU] * 2, fn, [1, 2]) == [10, 20]
    assert seen == {threading.get_ident()}


def test_local_device_mesh_needs_two_cards():
    assert TM.local_device_mesh("cpu") is None
    if torch.cuda.device_count() < 2:
        assert TM.local_device_mesh("cuda") is None


def _jax_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:2]), (JM.BLOCK_AXIS,))


def test_uniform_mesh_blobs_equal_block_codec_and_jax_mesh():
    blocks = _blocks("golden_uniform")[:2]
    jcodec, tcodec = _codecs(blocks[0])
    staged = [TB.host_stage_uniform(b, tcodec.shape.cap) for b in blocks]
    _, _, spec, rpad = staged[0]
    mats = np.stack([s[0] for s in staged])
    nrecs = [s[1] for s in staged]
    port, offsets = TM.MeshUniformCodec([CPU] * 2, spec, rpad) \
        .compress_blocks(mats, nrecs)
    blobs = [r[0] for r in port]
    assert list(offsets) == [0, len(blobs[0])]
    assert blobs == [tcodec.compress(b, i)[0] for i, b in enumerate(blocks)]
    jax_res, _ = JM.MeshUniformCodec(_jax_mesh(), spec, rpad) \
        .compress_blocks(mats, nrecs)
    assert blobs == [r[0] for r in jax_res]


def test_semi_mesh_blobs_equal_block_codec_and_jax_mesh():
    blocks = _blocks("golden_semi")[:2]
    jcodec, tcodec = _codecs(blocks[0])
    staged = [tcodec.stage_semi_tok_for_mesh(b) for b in blocks]
    jstaged = [jcodec.stage_semi_tok_for_mesh(b) for b in blocks]
    _, read_len, rpad, pcs = staged[-1]
    assert [s[1:] for s in staged] == [s[1:] for s in jstaged]
    port, _ = TM.MeshSemiCodec([CPU] * 2, read_len, rpad, pcs) \
        .compress_blocks([s[0] for s in staged])
    blobs = [r[0] for r in port]
    _, one = _codecs(blocks[0])
    assert blobs == [one.compress(b, i)[0] for i, b in enumerate(blocks)]
    jax_res, _ = JM.MeshSemiCodec(_jax_mesh(), read_len, rpad, pcs) \
        .compress_blocks([s[0] for s in jstaged])
    assert blobs == [r[0] for r in jax_res]


# --------------------------------------------------------------------------
# DsrcModule over a mesh of [cpu] * 4
# --------------------------------------------------------------------------

def _cpu_mesh(monkeypatch):
    """From here on DsrcModule takes a mesh of [cpu] * 4; returns the
    counts of mesh batches compressed and decoded."""
    batches = {"compress": 0, "decompress": 0}
    for cls in (TM.MeshUniformCodec, TM.MeshSemiCodec):
        for op in ("compress", "decompress"):
            real = getattr(cls, op + "_blocks")

            def counted(self, *a, _real=real, _op=op):
                batches[_op] += 1
                return _real(self, *a)
            monkeypatch.setattr(cls, op + "_blocks", counted)
    monkeypatch.setattr(TAPI, "local_device_mesh",
                        lambda device: [CPU] * 4)
    return batches


def _one_device(data: bytes, block: int) -> bytes:
    """The one-device archive of data."""
    one = io.BytesIO()
    DsrcModule(InputParameters(fastq_block_size_bytes=block), device="cpu") \
        .compress(io.BytesIO(data), one)
    return one.getvalue()


def _mesh_round_trip(data: bytes, block: int):
    """(archive, decoded text) through DsrcModule on the CPU."""
    mod = DsrcModule(InputParameters(fastq_block_size_bytes=block),
                     device="cpu")
    arch, out = io.BytesIO(), io.BytesIO()
    mod.compress(io.BytesIO(data), arch)
    arch.seek(0)
    mod.decompress(arch, out)
    return arch.getvalue(), out.getvalue()


@pytest.mark.parametrize("name", ["semi", "uniform_then_semi"])
def test_module_mesh_archive_equals_one_device(name, monkeypatch):
    """The files of tests/test_parallel.py::test_mesh_semi_module_roundtrip
    (at 256 KB blocks the plane counts of every SEMI block agree, so the
    SEMI blocks batch)."""
    if name == "semi":
        data = make_fastq_fast(16000, 60, seed=5, fixed_width=False)
    else:
        data = make_fastq_fast(8000, 60, seed=6, fixed_width=True) + \
            make_fastq_fast(8000, 60, seed=7, fixed_width=False)
    block = 1 << 18
    one = _one_device(data, block)
    batches = _cpu_mesh(monkeypatch)
    arch, out = _mesh_round_trip(data, block)
    assert arch == one
    assert out == data
    assert batches["compress"] >= 1 and batches["decompress"] >= 1
    kinds = [b[0] for b in ArchiveReader(io.BytesIO(arch))]
    assert set(kinds) == ({TB.BLOCK_SEMI} if name == "semi"
                          else {TB.BLOCK_UNIFORM, TB.BLOCK_SEMI})


@pytest.mark.parametrize("staging", ["in_order", "threads"])
def test_mode0_blocks_through_the_mesh_are_parsed_once(staging, monkeypatch):
    """Block 0 is title mode 2 (so the mesh is taken), blocks 2-5 are a
    mode-2 batch (the plane counts that block 0 seeds hold them all); the
    text blocks are title mode 0 and go through the one-device codec in
    file order.  On decode each mode-0 blob's tag section is decoded
    once.  Block 0 seeds the hints, so the later blocks are staged ahead:
    on the calling thread for CPU entries, or on threads as for cards."""
    hint_block = 8192
    data = _regime_file(["p3", "text", "p3", "p1", "p3", "p3", "text",
                         "p1"], hint_block, 11)
    one = _one_device(data, hint_block)
    batches = _cpu_mesh(monkeypatch)
    if staging == "threads":
        monkeypatch.setattr(TAPI, "on_cards", lambda devices: True)
    real = TTAG.decode_tags
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(TTAG, "decode_tags", counted)
    arch, out = _mesh_round_trip(data, hint_block)
    assert arch == one and out == data
    modes = [_semi_modes(b)[1] for b in ArchiveReader(io.BytesIO(arch))]
    assert modes == [2, 0, 2, 2, 2, 2, 0, 2]
    assert len(calls) == modes.count(0)
    assert batches["compress"] >= 1 and batches["decompress"] >= 1


def _fixed(n: int, seed: int) -> np.ndarray:
    return np.frombuffer(make_fastq_fast(n, 20, seed=seed, fixed_width=True),
                         np.uint8).copy()


@pytest.mark.parametrize("n_dev", [2, 4])
def test_semi_hints_seeded_in_file_order_through_the_mesh(n_dev):
    """Block 1 passes the host staging of a UNIFORM block but fails the
    uniformity check (a title byte above the UNIFORM alphabet) and is semi
    layout, so it seeds the lane bucket on one device; block 2 is a title
    mode 2 block with fewer records.  Staging block 2 before block 1 falls
    back (the reference's order) seeds the bucket from block 2 and changes
    block 1's bytes; the port's mesh flushes block 1 first."""
    u0, a = _fixed(200, 1), _fixed(600, 2)
    a[np.flatnonzero(a == 10)[39] + 3] = 0xC3          # in record 10's title
    s = np.frombuffer(make_fastq_fast(100, 20, seed=3), np.uint8)
    blocks = [u0, a, s]
    _, codec = _codecs(u0)
    cap = codec.shape.cap
    assert TB.host_stage_uniform(a, cap) is not None
    assert TB.stage_uniform_block(a, cap, CPU) is None
    assert TB.host_stage_uniform(s, cap) is None
    one = [codec.compress(b, i)[0] for i, b in enumerate(blocks)]
    assert one[1][0] == TB.BLOCK_SEMI

    _, ref_order = _codecs(u0)
    ref_order.compress(u0, 0)
    assert ref_order.stage_semi_tok_for_mesh(s) is not None
    assert ref_order.compress(a, 1)[0] != one[1]

    _, codec = _codecs(u0)

    def job(item):
        index, block = item
        blob, info = codec.compress(block, index)
        return blob, TAPI._count_records(block), info
    got = TAPI._mesh_compress_results(enumerate(blocks), codec, job,
                                      [CPU] * n_dev)
    assert [blob for blob, _, _ in got] == one


def test_semi_hint_seeds_are_those_of_the_one_device_run():
    """The distributed planner asks each block what it would seed: a
    UNIFORM block nothing, a mode-0 block only the lane bucket, a mode-2
    block the plane counts too; asking seeds nothing.  The first such
    blocks give the one-device run's hints.  The reference's distributed
    compression seeds both from block 0, here a UNIFORM block, and gets
    other hints."""
    data = _regime_file(["text", "p1", "p3"], 8192, 8)
    blocks = list(FastqChunker(io.BytesIO(data), 8192))
    u0 = _fixed(600, 1)
    jcodec, one = _codecs(u0)
    for i, b in enumerate([u0] + blocks):
        one.compress(b, i)
    _, plan = _codecs(u0)
    assert plan.semi_hint_seeds(u0) == (0, None)
    assert plan.semi_hint_seeds(blocks[0]) == (one._rpad_hint, None)
    _rpad, pcs = plan.semi_hint_seeds(blocks[1])
    assert dict(enumerate(pcs)) == one._pcs_hint
    assert plan._rpad_hint == 0 and not plan._hints_frozen
    plan.set_semi_hints(one._rpad_hint, pcs)
    assert (plan._rpad_hint, plan._pcs_hint) == \
        (one._rpad_hint, one._pcs_hint)
    jcodec.seed_semi_hints(u0)
    assert (jcodec._rpad_hint, jcodec._pcs_hint) != \
        (one._rpad_hint, one._pcs_hint)
