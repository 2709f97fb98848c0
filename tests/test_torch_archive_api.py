"""The port's record-at-a-time archive API (dsrc_tpu_torch/archive_api.py)
and CLI -r on the CPU: the cases of tests/test_archive_api.py run on the
port, record streams cross between the port's DsrcArchive and the
reference's in both directions, a reused DsrcArchive never returns the
records of an earlier archive, and CLI -r prints what dsrc_tpu's CLI
prints."""
import io

import pytest

from dsrc_tpu import cli as jax_cli
from dsrc_tpu.archive_api import DsrcArchive as JaxArchive
from dsrc_tpu.config import InputParameters as JaxParams
from dsrc_tpu_torch import cli
from dsrc_tpu_torch.archive_api import DsrcArchive, FastqFile, FastqRecord
from dsrc_tpu_torch.config import DsrcException, InputParameters
from dsrc_tpu_torch.utils.synth import make_fastq
from torch_threads import one_torch_thread  # noqa: F401


def _records(n, seq="ACGTAC" * 10, qual="IIIHHGGFFE" * 6, shift=0):
    return [FastqRecord(tag=f"read.{i + shift} x:{i % 7}", sequence=seq,
                        quality=qual) for i in range(n)]


def _write(recs, params=None, arch=None):
    arch = arch or io.BytesIO()
    a = DsrcArchive(params, device="cpu")
    a.start_compress(arch)
    for r in recs:
        a.write_next_record(r)
    a.finish_compress()
    return arch


def _read_all(arch):
    arch.seek(0)
    b = DsrcArchive(device="cpu")
    b.start_decompress(arch)
    got = []
    while (r := b.read_next_record()) is not None:
        got.append(r)
    b.finish_decompress()
    return got


def test_record_archive_roundtrip():
    params = InputParameters(fastq_block_size_bytes=32768,
                             dna_compression_level=1,
                             quality_compression_level=1)
    recs = _records(300)
    assert _read_all(_write(recs, params)) == recs


def test_record_archive_context_manager_flushes_small_session():
    arch = io.BytesIO()
    recs = [FastqRecord(tag=f"r{i}", sequence="ACGT" * 8, quality="IIHH" * 8)
            for i in range(5)]
    with DsrcArchive(device="cpu") as a:     # default 8 MB block >> 5 records
        a.start_compress(arch)
        for r in recs:
            a.write_next_record(r)
    assert arch.tell() > 0, "buffered tail was not flushed on __exit__"
    arch.seek(0)
    with DsrcArchive(device="cpu") as b:
        b.start_decompress(arch)
        got = [b.read_next_record() for _ in range(6)]
    assert got[:5] == recs and got[5] is None


def test_record_archive_flushes_before_oversized_append():
    """A record that would push the buffer past the block size is flushed
    before, not appended (about 1 KB reads, two to a 4 KB block; their
    lengths differ, so the blocks are GENERIC, whose plain versions run
    fastest on the CPU)."""
    params = InputParameters(fastq_block_size_bytes=4096)
    arch = io.BytesIO()
    recs = [FastqRecord(tag=f"r{i}", sequence="ACGT" * 250 + "A" * i,
                        quality="I" * (1000 + i)) for i in range(8)]
    with DsrcArchive(params, device="cpu") as a:
        a.start_compress(arch)
        for r in recs:
            a.write_next_record(r)
    assert _read_all(arch) == recs


def test_record_archive_empty_session_exits_cleanly():
    with DsrcArchive(device="cpu") as a:
        a.start_compress(io.BytesIO())
    # no records: __exit__ must not raise, the archive stays unwritten


def test_fastq_file_read_write(tmp_path):
    data = make_fastq(25, 40, seed=1)
    p = tmp_path / "x.fastq"
    p.write_bytes(data)
    with FastqFile(str(p)) as f:
        recs = list(f)
    assert len(recs) == 25
    q = tmp_path / "y.fastq"
    with FastqFile(str(q), "w") as f:
        for r in recs:
            f.write_next_record(r)
    assert q.read_bytes() == data


def test_record_random_access_across_blocks():
    recs = _records(400)
    arch = _write(recs, InputParameters(fastq_block_size_bytes=16384))
    arch.seek(0)
    b = DsrcArchive(device="cpu")
    b.start_decompress(arch)
    assert b.record_count == 400
    for i in (0, 399, 200, 1, 398, 57):          # across block boundaries
        assert b.read_record(i) == recs[i], f"record {i}"
    assert list(b.read_records(150, 260)) == recs[150:260]
    with pytest.raises(DsrcException, match="out of range"):
        b.read_record(400)
    b.finish_decompress()


def test_reused_archive_returns_the_second_archives_records():
    """The reference keeps its read_record cache across start_decompress
    (dsrc_tpu/archive_api.py:116-190); the port clears it on start and
    finish."""
    params = InputParameters(fastq_block_size_bytes=16384)
    first, second = _records(300), _records(300, shift=10_000)
    arch1, arch2 = _write(first, params), _write(second, params)
    a = DsrcArchive(device="cpu")
    for arch, recs in ((arch1, first), (arch2, second)):
        arch.seek(0)
        a.start_decompress(arch)
        assert a.read_record(5) == recs[5]
        assert list(a.read_records(100, 104)) == recs[100:104]
        a.finish_decompress()


def test_default_device_is_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DsrcException, match="CUDA"):
        DsrcArchive()


# --------------------------------------------------------------------------
# against dsrc_tpu: one archive layout (SEMI blocks of 16 KB), so the
# reference compiles one encode and one decode
# --------------------------------------------------------------------------

BLOCK = 16384


@pytest.fixture(scope="module")
def cross():
    """(records, the port's archive, the reference's archive) of 400
    records written through each package's DsrcArchive."""
    recs = _records(400)
    tarch = _write(recs, InputParameters(fastq_block_size_bytes=BLOCK))
    jarch = io.BytesIO()
    a = JaxArchive(JaxParams(fastq_block_size_bytes=BLOCK))
    a.start_compress(jarch)
    for r in recs:
        a.write_next_record(r)
    a.finish_compress()
    return recs, tarch.getvalue(), jarch.getvalue()


def test_record_streams_cross_between_the_packages(cross):
    recs, tarch, jarch = cross
    assert tarch == jarch
    assert _read_all(io.BytesIO(jarch)) == recs
    b = JaxArchive()
    b.start_decompress(io.BytesIO(tarch))
    got = [b.read_record(i) for i in range(b.record_count)]
    b.finish_decompress()
    assert [r.to_bytes() for r in got] == [r.to_bytes() for r in recs]


def test_cli_record_range_equals_dsrc_tpu(cross, tmp_path):
    recs, tarch, _ = cross
    src = tmp_path / "in.xfqz"
    src.write_bytes(tarch)
    got, want = tmp_path / "port.fastq", tmp_path / "jax.fastq"
    assert cli.main(["d", "-r150:260", str(src), str(got)],
                    device="cpu") == 0
    assert jax_cli.main(["d", "-r150:260", str(src), str(want)]) == 0
    assert got.read_bytes() == want.read_bytes() == \
        b"".join(r.to_bytes() for r in recs[150:260])
    # a range past the end stops at the last record
    assert cli.main(["d", "-r390:999", str(src), str(got)],
                    device="cpu") == 0
    assert got.read_bytes() == b"".join(r.to_bytes() for r in recs[390:])
