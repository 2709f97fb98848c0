"""Whole-file behaviour of the PyTorch port on the CPU: the golden archives
decode byte-exactly, archives cross-decode between the port and dsrc_tpu in
both directions, the CLI round-trips and extracts record ranges (-r),
colour-space (SOLiD) input and free-text titles (SEMI title mode 0) go
through, and distributed compression of streams (it needs file paths)
raises DsrcException instead of writing other bytes."""
import io
import os

import numpy as np
import pytest
import torch

from dsrc_tpu.api import DsrcModule as JaxModule
from dsrc_tpu.config import InputParameters as JaxParams
from dsrc_tpu_torch import cli
from dsrc_tpu_torch.api import DsrcModule
from dsrc_tpu_torch.config import DsrcException, InputParameters
from dsrc_tpu_torch.utils.synth import make_fastq_fast, make_fastq_realistic
from torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
BLOCK = 1 << 17


def _read(name):
    return open(os.path.join(DATA, name), "rb").read()


def _port(**kw):
    return DsrcModule(InputParameters(fastq_block_size_bytes=BLOCK, **kw),
                      device="cpu")


@pytest.mark.parametrize("name", ["golden_uniform", "golden_semi"])
def test_golden_archives_decode_with_port(name):
    out = io.BytesIO()
    DsrcModule(device="cpu").decompress(os.path.join(DATA, name + ".xfqz"),
                                        out)
    assert out.getvalue() == _read(name + ".fastq")


def test_archives_cross_decode_both_ways():
    """A SEMI input at read length 101 (flat DNA packing across rows, N
    bases, a bad cycle): the two packages write the same archive, and each
    decodes the other's."""
    data = make_fastq_realistic(700, 101, seed=61)
    port_arch = io.BytesIO()
    _port().compress(io.BytesIO(data), port_arch)
    jax_mod = JaxModule(JaxParams(fastq_block_size_bytes=BLOCK))
    jax_arch = io.BytesIO()
    jax_mod.compress(io.BytesIO(data), jax_arch)
    assert port_arch.getvalue() == jax_arch.getvalue()
    out = io.BytesIO()
    jax_mod.decompress(io.BytesIO(port_arch.getvalue()), out)
    assert out.getvalue() == data
    out = io.BytesIO()
    _port().decompress(io.BytesIO(jax_arch.getvalue()), out)
    assert out.getvalue() == data


def test_uniform_archive_decodes_with_jax():
    data = _read("golden_uniform.fastq")
    arch = io.BytesIO()
    _port().compress(io.BytesIO(data), arch)
    assert arch.getvalue() == _read("golden_uniform.xfqz")
    out = io.BytesIO()
    JaxModule().decompress(io.BytesIO(arch.getvalue()), out)
    assert out.getvalue() == data


def test_cli_roundtrip(tmp_path):
    src = tmp_path / "in.fastq"
    src.write_bytes(make_fastq_fast(500, 60, seed=62, fixed_width=True))
    arch, back = tmp_path / "out.xfqz", tmp_path / "rt.fastq"
    assert cli.main(["c", "-m0", str(src), str(arch)], device="cpu") == 0
    assert cli.main(["d", str(arch), str(back)], device="cpu") == 0
    assert back.read_bytes() == src.read_bytes()


def test_cli_rejects_what_the_slice_does_not_cover(tmp_path, capsys):
    """-r extracts records [N, M) through the record API; the CLI rejects
    a range that is not 0 <= N < M."""
    out = tmp_path / "five.fastq"
    golden = DATA + "/golden_semi.xfqz"
    assert cli.main(["d", "-r0:5", golden, str(out)], device="cpu") == 0
    want = b"".join(_read("golden_semi.fastq").splitlines(True)[:20])
    assert out.read_bytes() == want
    assert cli.main(["d", "-r5:2", golden, str(out)], device="cpu") == 1
    assert "record range" in capsys.readouterr().err


def _solid(n=40, dot_qual=b"I"):
    """SOLiD reads: primer T, then "0123." six times, quality 'I' but
    dot_qual at each '.'."""
    return b"".join(b"@s%d\nT%s\n+\n%s\n" % (i, b"0123." * 6,
                                              (b"IIII" + dot_qual) * 6)
                    for i in range(n))


@pytest.mark.parametrize("kw", [dict(dna_compression_level=2),
                                dict(quality_compression_level=1),
                                dict(lossy_quality=True),
                                dict(calculate_crc32=True)])
def test_generic_settings_raise(kw):
    """GENERIC settings code fixed-width reads as GENERIC blocks, and
    colour-space (SOLiD) input as well."""
    data = b"".join(_read("golden_uniform.fastq").splitlines(True)[:800])
    arch, out = io.BytesIO(), io.BytesIO()
    _port(**kw).compress(io.BytesIO(data), arch)
    _port(**kw).decompress(io.BytesIO(arch.getvalue()), out)
    if kw.get("lossy_quality"):
        assert out.getvalue().split(b"\n")[0::4] == data.split(b"\n")[0::4]
    else:
        assert out.getvalue() == data
    solid = _solid()
    arch, out = io.BytesIO(), io.BytesIO()
    _port(**kw).compress(io.BytesIO(solid), arch)
    _port(**kw).decompress(io.BytesIO(arch.getvalue()), out)
    # lossy: quality 'I' (40) keeps bin 7, whose representative is 40; a
    # '.' forces bin 0, whose representative is 0 ('!')
    assert out.getvalue() == (_solid(dot_qual=b"!")
                              if kw.get("lossy_quality") else solid)


def test_generic_inputs_and_archives_raise():
    """Variable-length reads and the golden GENERIC archive go through the
    GENERIC class; a colour-space GENERIC block carries its primers (flag
    FLAG_COLOR_SPACE) and decodes; one that lacks them raises."""
    from dsrc_tpu_torch.models import block as TB
    variable = make_fastq_fast(300, 50, seed=63)[:-1] + b"\n"
    lines = variable.split(b"\n")
    lines[1] = lines[1][:20]                     # one short read
    lines[3] = lines[3][:20]
    data = b"\n".join(lines)
    arch, out = io.BytesIO(), io.BytesIO()
    _port().compress(io.BytesIO(data), arch)
    _port().decompress(io.BytesIO(arch.getvalue()), out)
    assert out.getvalue() == data
    out = io.BytesIO()
    DsrcModule(device="cpu").decompress(
        os.path.join(DATA, "golden_generic.xfqz"), out)
    assert out.getvalue() == _read("golden_generic.fastq")
    codec = TB.BlockCodec(TB.BlockShape.for_block_size(BLOCK),
                          InputParameters().to_settings(),
                          TB.DatasetType(quality_offset=33, color_space=True),
                          device="cpu")
    solid = np.frombuffer(_solid(), np.uint8)
    blob, _ = codec.compress(solid)
    assert blob[0] == TB.BLOCK_GENERIC and blob[2] & TB.FLAG_COLOR_SPACE
    np.testing.assert_array_equal(codec.decompress(blob), solid)
    no_primers = bytearray(blob)
    no_primers[2] &= ~TB.FLAG_COLOR_SPACE
    with pytest.raises(DsrcException, match="without primers"):
        codec.decompress(bytes(no_primers))


def test_free_text_titles_raise():
    """Titles with a text field make a SEMI block of title mode 0, which
    round-trips."""
    from dsrc_tpu_torch.io.archive import ArchiveReader
    from dsrc_tpu_torch.models import block as TB
    data = make_fastq_fast(300, 50, seed=64)
    data = data.replace(b" length=", b" run_abc length=", 1)
    arch, out = io.BytesIO(), io.BytesIO()
    _port().compress(io.BytesIO(data), arch)
    blob = ArchiveReader(io.BytesIO(arch.getvalue())).read_block(0)
    d = TB.parse_semi_block(TB.BitReader(blob[1:]),
                            TB.BlockShape.for_block_size(BLOCK).cap, "cpu")
    assert blob[0] == TB.BLOCK_SEMI and d["mode"] == 0
    _port().decompress(io.BytesIO(arch.getvalue()), out)
    assert out.getvalue() == data


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DsrcException, match="CUDA"):
        DsrcModule()
    with pytest.raises(DsrcException, match="CUDA"):
        DsrcModule(device="cuda")
    with pytest.raises(DsrcException, match="distributed"):
        _port().compress(io.BytesIO(b""), io.BytesIO(), distributed=True)
