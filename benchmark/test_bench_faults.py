"""`correct` comes out false when the timed path is broken underneath, and
for the control: the program's own lower precision, its lossy quality
binning (-l).  Each cell's faults are the ones it can have: an answer
altered where it is produced, half of a block's records left out, a codec
that returns its input unchanged, an operation that raises, an archive that
differs from the first."""
from __future__ import annotations

import contextlib

import numpy as np
import pytest
from conftest import run_tiny


@contextlib.contextmanager
def patched(obj, name, make):
    real = getattr(obj, name)
    setattr(obj, name, make(real))
    try:
        yield
    finally:
        setattr(obj, name, real)


def _flip(arr: np.ndarray, at: float = 0.5) -> np.ndarray:
    out = np.array(arr, copy=True)
    i = int(len(out) * at)
    out[i] ^= 0x01
    return out


def altered_text():
    """BlockCodec.decompress returns a byte altered in its block."""
    from dsrc_tpu_torch.models.block import BlockCodec
    return patched(BlockCodec, "decompress",
                   lambda real: lambda self, blob: _flip(real(self, blob)))


def altered_blob():
    """BlockCodec.compress writes a byte altered in its block's archive."""
    from dsrc_tpu_torch.models.block import BlockCodec

    def make(real):
        def run(self, block, *a, **k):
            blob, info = real(self, block, *a, **k)
            return _flip(np.frombuffer(blob, np.uint8), 0.9).tobytes(), info
        return run
    return patched(BlockCodec, "compress", make)


def half_left_out():
    """BlockCodec.decompress returns the first half of its block's
    records."""
    from dsrc_tpu_torch.models.block import BlockCodec

    def make(real):
        def run(self, blob):
            text = real(self, blob)
            ends = np.flatnonzero(text == 10)[3::4]
            return text[:int(ends[len(ends) // 2 - 1]) + 1]
        return run
    return patched(BlockCodec, "decompress", make)


@contextlib.contextmanager
def identity_codec():
    """DsrcModule.compress copies its input as the archive, decompress
    copies the archive back: the round trip gives the input back."""
    from dsrc_tpu_torch.api import DsrcModule

    def copy(self, src, dst, *a, **k):
        dst.write(src.read())
    with patched(DsrcModule, "compress", lambda real: copy), \
            patched(DsrcModule, "decompress", lambda real: copy):
        yield


def raises():
    """BlockCodec.decompress raises on a block."""
    from dsrc_tpu_torch.models.block import BlockCodec

    def make(real):
        def run(self, blob):
            raise RuntimeError("a planted fault")
        return run
    return patched(BlockCodec, "decompress", make)


ROUND_TRIP_FAULTS = {"altered_text": altered_text,
                     "altered_blob": altered_blob,
                     "half_left_out": half_left_out,
                     "identity_codec": identity_codec,
                     "raises": raises}


@pytest.mark.parametrize("fault", sorted(ROUND_TRIP_FAULTS))
@pytest.mark.parametrize("cell", ["tiny-m0-semi-rt", "tiny-m1-generic-rt",
                                  "tiny-m0-umi-rt"])
def test_round_trip_fault_is_not_correct(tiny_root, cell, fault):
    res = run_tiny(*tiny_root, cell, faults=ROUND_TRIP_FAULTS[fault]())
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["checks"].values())


def test_identity_codec_is_caught_by_the_reference(tiny_root):
    res = run_tiny(*tiny_root, "tiny-m0-semi-rt", faults=identity_codec())
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert checks["fastq_bytes_wrong"] == 0
    assert checks["container_faults"] > 0
    assert checks["reference_bytes_wrong"] > 0


def test_raising_operation_is_counted(tiny_root):
    res = run_tiny(*tiny_root, "tiny-m0-semi-rt", faults=raises())
    assert res["failed"] == 1
    assert res["checks"]["ops_failed"]["value"] == 1


def test_archive_unlike_the_first_is_not_correct(tiny_root):
    """Two compresses of the same input that write different bytes."""
    import time

    import torch
    from yardstick import cell as C
    from yardstick import spec
    c = spec.load_cell("tiny-m0-semi-rt", *tiny_root)
    out = C.run_window(c, 7, 0.0, False, torch.device("cpu"),
                       time.perf_counter())
    first = out.archives[0]
    out.archives.append(first[:-1] + bytes([first[-1] ^ 1]))
    res = C.checks(c, 7, out)
    assert res["archives_unlike_first"] == (1, 0)


@pytest.mark.parametrize("cell", ["tiny-m0-semi-rt", "tiny-m1-generic-rt",
                                  "tiny-m0-umi-rt"])
def test_sound_and_control(tiny_root, cell):
    """The sound program is correct; the control (the same run with the
    program's lossy quality binning) is not, by every number that can
    see it."""
    from yardstick import spec
    root, bench = tiny_root
    res = run_tiny(root, bench, cell)
    assert res["correct"], res["checks"]
    assert all(v["value"] == 0 for v in res["checks"].values())
    params = dict(spec.load_cell(cell, root, bench).config["params"],
                  lossy_quality=True)
    res = run_tiny(root, bench, cell, params=params)
    assert res["correct"] is False
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert checks["fastq_bytes_wrong"] > 0
    assert checks["container_faults"] > 0
    assert checks["reference_bytes_wrong"] > 0
