"""The port's native host library (dsrc_tpu_torch/utils/native.py) on the CPU.

- Each entry point (scan_records, stage_semi, layout_records) gives the
  same bytes from the library built at first use as dsrc_tpu's numpy
  fallback (dsrc_tpu/utils/native.py with its library out of the way): an
  8 MB SEMI block of the benchmark's generator, GENERIC records of varying
  length, colour space, plus_repetition, and the blocks stage_semi
  rejects.
- The build: the library's name follows the source and the flags;
  processes that start together build it once; without g++, or when the
  build fails, the first call raises DsrcException naming the compiler,
  and no library file is left.
- Archives of slices of the four traffic mixes are the bytes dsrc_tpu
  writes and decompress to their input (tests/test_torch_tag_native.py
  holds the tag coder's passes one by one).
"""
import importlib.util
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from dsrc_tpu import api as JAPI
from dsrc_tpu.config import InputParameters as JaxParams
from dsrc_tpu.utils import native as JNATIVE
from dsrc_tpu_torch import cli
from dsrc_tpu_torch.api import DsrcModule
from dsrc_tpu_torch.config import DsrcException, InputParameters
from dsrc_tpu_torch.models import tag as TTAG
from dsrc_tpu_torch.utils import native
from dsrc_tpu_torch.utils.synth import make_fastq
from torch_jax_codec import jax_codec  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")


def _bench_gen():
    spec = importlib.util.spec_from_file_location(
        "bench_gen", os.path.join(BENCH, "yardstick", "gen.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GEN = _bench_gen()
SEMI_8MB = np.frombuffer(GEN.fastq_of_size(8_000_000, 7200000011),
                         np.uint8)


def _u8(data: bytes) -> np.ndarray:
    return np.frombuffer(data, np.uint8)


FASTQ = {
    "semi-8mb": lambda: SEMI_8MB,
    "generic": lambda: _u8(make_fastq(600, 120, variable_length=True,
                                      seed=3)),
    "colour": lambda: _u8(make_fastq(400, 50, color_space=True, seed=4)),
    "plus-rep": lambda: _u8(make_fastq(400, 80, variable_length=True,
                                       plus_repetition=True, seed=5)),
}


def both(name, *args):
    """native.<name>(*args) from the port's library, then from dsrc_tpu's
    numpy fallback."""
    lib = getattr(native, name)(*args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JNATIVE, "_load", lambda: None)
        return lib, getattr(JNATIVE, name)(*args)


def same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape \
            and a.tobytes() == b.tobytes()
    return a == b


def streams(buf: np.ndarray, color_space: bool):
    """The decoded streams of a FASTQ text, as layout_records takes them:
    (num_rec, titles, title_lens, seq, qual, qual_lens, primers,
    plus_rep)."""
    lines = buf.tobytes().split(b"\n")[:-1]
    titles = [t[1:] for t in lines[0::4]]
    seqs = lines[1::4]
    quals = lines[3::4]
    plus_rep = lines[2] != b"+"
    primers = None
    if color_space:
        primers = np.frombuffer(b"".join(s[:1] for s in seqs), np.uint8)
        seqs = [s[1:] for s in seqs]
    return (len(titles), _u8(b"".join(titles)),
            np.array([len(t) for t in titles], np.int64),
            _u8(b"".join(seqs)), _u8(b"".join(quals)),
            np.array([len(q) for q in quals], np.int64), primers, plus_rep)


@pytest.mark.parametrize("lines_before", [0, 1, 2, 3])
@pytest.mark.parametrize("name", ["semi-8mb", "generic", "semi-cut",
                                  "no-newline", "empty"])
def test_scan_records_matches_fallback(name, lines_before):
    buf = {"semi-cut": lambda: SEMI_8MB[:3_000_017],
           "no-newline": lambda: _u8(b"@r1 no newline"),
           "empty": lambda: np.zeros(0, np.uint8)}.get(
        name, FASTQ.get(name))()
    lib, fb = both("scan_records", buf, lines_before)
    assert lib == fb


@pytest.mark.parametrize("name", ["semi-8mb", "generic", "colour",
                                  "plus-rep"])
def test_stage_semi_matches_fallback(name):
    buf = FASTQ[name]()
    read_len = len(buf.tobytes().split(b"\n", 2)[1])
    rpad = len(buf) // (2 * read_len + 6) + 257
    lib, fb = both("stage_semi", buf, read_len, rpad)
    assert same(lib, fb)
    # only fixed-length ACGTN reads with a bare '+' line stage
    assert (lib is not None) == (name == "semi-8mb")


def _mutated(kind: str) -> np.ndarray:
    b = SEMI_8MB[:200_000].copy()
    b = b[:np.flatnonzero(b == 10)[4 * 600 - 1] + 1]
    nl = np.flatnonzero(b == 10)
    r = 4 * 300                       # record 300's first line
    if kind == "plus":
        b[nl[r + 1] + 1] = ord("x")
    elif kind == "qual-low":
        b[nl[r + 2] + 5] = 32
    elif kind == "qual-high":
        b[nl[r + 2] + 5] = 33 + 64
    elif kind == "seq":
        b[nl[r] + 3] = ord("z")
    elif kind == "at":
        b[nl[r - 1] + 1] = ord("%")
    elif kind == "truncate":
        b = b[:-1]
    elif kind == "short-read":
        b = np.delete(b, nl[r] + 1)
    elif kind == "partial":
        b = b[:nl[r + 1] + 1]
    return b


@pytest.mark.parametrize("kind", ["plus", "qual-low", "qual-high", "seq",
                                  "at", "truncate", "short-read", "partial",
                                  "rpad", "read-len"])
def test_stage_semi_rejections_match_fallback(kind):
    b = SEMI_8MB[:200_000]
    b = b[:np.flatnonzero(b == 10)[4 * 600 - 1] + 1]
    read_len, rpad = 100, 1024
    if kind == "rpad":
        rpad = 599
    elif kind == "read-len":
        read_len = 99
    else:
        b = _mutated(kind)
    lib, fb = both("stage_semi", b, read_len, rpad)
    assert lib is None and fb is None


@pytest.mark.parametrize("name", ["semi-8mb", "generic", "colour",
                                  "plus-rep"])
def test_layout_records_matches_fallback(name):
    buf = FASTQ[name]()
    n, t, tl, s, q, ql, prim, plus = streams(buf, name == "colour")
    assert plus == (name == "plus-rep")
    lib, fb = both("layout_records", n, t, tl, s, q, ql, prim,
                   name == "colour", plus)
    assert same(lib, fb)
    assert lib.tobytes() == buf.tobytes()


def test_lib_name_follows_source_and_flags(tmp_path, monkeypatch):
    src = tmp_path / "host_ops.cpp"
    src.write_bytes(open(native.SOURCE, "rb").read())
    monkeypatch.setattr(native, "SOURCE", str(src))
    first = native.lib_path()
    assert native.lib_path() == first
    assert os.path.dirname(first) == native.BUILD_DIR
    src.write_bytes(src.read_bytes() + b"\n// changed\n")
    changed = native.lib_path()
    assert changed != first
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.lib_path() not in (first, changed)


def test_parallel_first_uses_build_once(tmp_path):
    log = tmp_path / "calls.log"
    cxx = tmp_path / "cxx"
    cxx.write_text(f"#!/bin/sh\necho $$ >> {log}\nsleep 1\n"
                   f"exec g++ \"$@\"\n")
    cxx.chmod(0o755)
    out = tmp_path / "build"
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import numpy as np; "
            "from dsrc_tpu_torch.utils import native; "
            "native.BUILD_DIR = sys.argv[2]; "
            "native._compiler = lambda: sys.argv[3]; "
            "print(native.path()); "
            "print(native.scan_records(np.frombuffer("
            "b'@a\\nC\\n+\\nI\\n', np.uint8), 0))")
    procs = [subprocess.Popen([sys.executable, "-c", code, ROOT, str(out),
                               str(cxx)], stdout=subprocess.PIPE, text=True)
             for _ in range(4)]
    said = [p.communicate(timeout=120)[0].split("\n") for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert len(log.read_text().split()) == 1
    paths = {s[0] for s in said}
    assert len(paths) == 1 and os.path.isfile(paths.pop())
    assert all(s[1] == "(4, 9)" for s in said)
    assert [f for f in os.listdir(out) if f.endswith(".tmp")] == []


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_no_library_raises_at_first_use(tmp_path, monkeypatch, compiler):
    buf = SEMI_8MB[:4_000]
    build = tmp_path / "build"
    monkeypatch.setattr(native, "BUILD_DIR", str(build))
    monkeypatch.setattr(native, "_compiler", lambda: None if
                        compiler == "missing" else "/bin/false")
    monkeypatch.setattr(native, "_LIB", None)
    names = "g++ not found" if compiler == "missing" else "/bin/false exit 1"
    calls = [lambda: native.scan_records(buf, 0),
             lambda: native.stage_semi(buf, 100, 64),
             lambda: native.layout_records(0, buf, np.zeros(0, np.int64),
                                           buf, buf, np.zeros(0, np.int64),
                                           None, False, False),
             lambda: TTAG.tokenize(buf, np.array([len(buf)], np.int64))]
    for call in calls:
        with pytest.raises(DsrcException, match=re.escape(names)):
            call()
    assert not native.available() and native._LIB is None
    assert not build.exists() or not any(
        f.endswith((".so", ".tmp")) for f in os.listdir(build))


def test_cli_verbose_names_the_loaded_library(tmp_path, capsys):
    src = tmp_path / "in.fastq"
    src.write_bytes(make_fastq(300, 60, seed=9))
    arc = tmp_path / "out.xfqz"
    assert cli.main(["c", "-v", str(src), str(arc)], device="cpu") == 0
    err = capsys.readouterr().err
    assert f"native host library: {native.lib_path()}\n" in err
    assert native.lib_path().startswith(
        os.path.join(ROOT, "build", "dsrc_tpu_torch") + os.sep)


SLICE, BLOCK = 2_000_000, 1 << 20
MIXES = {"semi-rt-64m": "dsrc-m0", "generic-rt-192m": "dsrc-m1",
         "umi-rt-64m": "dsrc-m0", "iupac-rt-192m": "dsrc-m1-iupac"}


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_traffic_archives_match_reference(mix, jax_codec):
    with open(os.path.join(BENCH, "traffic", mix + ".json")) as f:
        data_spec = dict(json.load(f)["data"], bytes=SLICE)
    with open(os.path.join(BENCH, "configs", MIXES[mix] + ".json")) as f:
        params = dict(json.load(f)["params"], fastq_block_size_bytes=BLOCK)
    data = GEN.make_input(data_spec, 7300000013)
    mod = DsrcModule(InputParameters(**params), device="cpu")
    arc, back = io.BytesIO(), io.BytesIO()
    mod.compress(io.BytesIO(data), arc)
    mod.decompress(io.BytesIO(arc.getvalue()), back)
    assert back.getvalue() == data and len(data) > BLOCK   # two blocks
    ref = io.BytesIO()
    with jax_codec():
        JAPI.DsrcModule(JaxParams(**params)).compress(io.BytesIO(data), ref)
    assert arc.getvalue() == ref.getvalue()
