"""ctypes bindings for the native host library (native/host_ops.cpp).

The library is built at first use, as ops/cuda_build.py builds the CUDA
kernels: g++ compiles native/host_ops.cpp into build/dsrc_tpu_torch/ beside
the package (a directory .gitignore lists), named by a hash of the source
and the flags, so a changed source is never served by a stale library.
A file lock makes one process of many build it, and the build writes a
temporary name that os.replace renames, so no process loads a half-written
library.  The library is required, as the CUDA kernels are: a missing g++
or a failed build raises DsrcException at first use, and every entry point
runs in it (nvcc builds host code with the host compiler, so every machine
that runs the kernels has g++).  The library has a plain C ABI, bound by
ctypes: its build needs no Python or PyTorch headers.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from ..config import DsrcException

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "host_ops.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "dsrc_tpu_torch")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def lib_path() -> str:
    """The library's path, named by a hash of its source and the flags."""
    with open(SOURCE, "rb") as f:
        h = hashlib.sha1(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libdsrc_host-{h.hexdigest()[:12]}.so")


def _compiler() -> Optional[str]:
    return shutil.which("g++")


def build() -> str:
    """The library's path, compiled first when it is missing; raises
    DsrcException when there is no g++ or the build fails."""
    out = lib_path()
    if os.path.exists(out):
        return out
    cxx = _compiler()
    if cxx is None:
        raise DsrcException("g++ not found: the native host library is "
                            "built from native/host_ops.cpp at first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(out + ".lock", "wb") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(out):
            tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
            try:
                done = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT)
                if done.returncode != 0:
                    raise DsrcException(
                        f"native host library build failed: {cxx} exit "
                        f"{done.returncode}\n"
                        + done.stdout.decode(errors="replace"))
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
    return out


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i64 = ctypes.c_int64
    lib.dsrc_scan_records.restype = i64
    lib.dsrc_scan_records.argtypes = [u8p, i64, i64, i64p]
    lib.dsrc_stage_semi.restype = i64
    lib.dsrc_stage_semi.argtypes = [u8p, i64, i64, i64, u8p, u8p, u8p, i64p]
    lib.dsrc_layout_records.restype = i64
    lib.dsrc_layout_records.argtypes = [
        i64, u8p, i64p, u8p, u8p, i64p, u8p,
        ctypes.c_int32, ctypes.c_int32, u8p]
    vpp = ctypes.c_void_p
    lib.dsrc_tag_structure.restype = i64
    lib.dsrc_tag_structure.argtypes = [u8p, i64p, i64, i64, u8p, u8p]
    lib.dsrc_tag_tokens.restype = i64
    lib.dsrc_tag_tokens.argtypes = [u8p, i64p, i64, i64, u8p, i64p, i64p]
    lib.dsrc_tag_classify.restype = i64
    lib.dsrc_tag_classify.argtypes = [u8p, i64p, i64p, i64, i64, i64, i64,
                                      i32p, i64p, i64p]
    lib.dsrc_tag_render.restype = i64
    lib.dsrc_tag_render.argtypes = [i64, i64, u8p, i32p, i64p, vpp, vpp,
                                    i64p, i64, i64p, u8p, i64p, u8p]
    lib.dsrc_tag_render_values.restype = i64
    lib.dsrc_tag_render_values.argtypes = [i64, i64, u8p, i32p, i64p, vpp,
                                           i64p, i64, i64p, u8p]


def _load() -> ctypes.CDLL:
    """The loaded library, built at the first call of the process."""
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(build())
                _bind(lib)
                _LIB = lib
    return _LIB


def available() -> bool:
    """Whether the library builds and loads (every entry point needs it)."""
    try:
        _load()
    except (DsrcException, OSError):
        return False
    return True


def path() -> str:
    """The loaded library's file."""
    _load()
    return lib_path()


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def scan_records(buf: np.ndarray, lines_before: int) -> Tuple[int, int]:
    """(newline_count, cut_position_after_last_boundary_or_-1)."""
    lib = _load()
    buf = np.ascontiguousarray(buf, np.uint8)
    cut = ctypes.c_int64(-1)
    count = lib.dsrc_scan_records(_u8(buf), len(buf), lines_before,
                                  ctypes.byref(cut))
    return int(count), int(cut.value)


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def stage_semi(buf: np.ndarray, read_len: int, rpad: int):
    """One-pass semi-uniform block staging: validate the fixed-read-length
    4-line layout and return (qual_mat [rpad, read_len] u8, seq_mat
    [rpad, read_len] u8, title_stream u8, title_lens i64, num_rec), or None
    when the block is not semi-layout (native/host_ops.cpp:
    dsrc_stage_semi)."""
    lib = _load()
    b = np.ascontiguousarray(buf, np.uint8)
    n = len(b)
    if not (0 < read_len <= 8192) or n == 0 or b[-1] != 10:
        return None
    qm = np.zeros((rpad, read_len), np.uint8)
    sm = np.zeros((rpad, read_len), np.uint8)
    tbuf = np.empty(n, np.uint8)
    tlens = np.zeros(rpad, np.int64)
    rec = lib.dsrc_stage_semi(_u8(b), n, read_len, rpad, _u8(qm), _u8(sm),
                              _u8(tbuf), _i64(tlens))
    if rec < 0:
        return None
    total = int(tlens[:rec].sum())
    return qm, sm, tbuf[:total], tlens[:rec], int(rec)


def layout_records(num_rec: int, titles: np.ndarray, title_lens: np.ndarray,
                   seq: np.ndarray, qual: np.ndarray, qual_lens: np.ndarray,
                   primers, color_space: bool, plus_rep: bool) -> np.ndarray:
    """Rebuild FASTQ text from decoded streams in one pass (decode-side
    mirror of stage_semi, for ALL block schemes)."""
    tl = np.ascontiguousarray(title_lens, np.int64)[:num_rec]
    ql = np.ascontiguousarray(qual_lens, np.int64)[:num_rec]
    sl = ql + (1 if color_space else 0)
    plus_extra = tl if plus_rep else np.zeros_like(tl)
    total = int((1 + tl + 1 + sl + 1 + 1 + plus_extra + 1 + ql + 1).sum())
    lib = _load()
    titles = np.ascontiguousarray(titles, np.uint8)
    seq = np.ascontiguousarray(seq, np.uint8)
    qual = np.ascontiguousarray(qual, np.uint8)
    prim = np.ascontiguousarray(
        primers if primers is not None else np.zeros(num_rec, np.uint8),
        np.uint8)
    out = np.empty(total, np.uint8)
    wrote = lib.dsrc_layout_records(
        num_rec, _u8(titles), _i64(tl), _u8(seq), _u8(qual), _i64(ql),
        _u8(prim), int(color_space), int(plus_rep), _u8(out))
    assert wrote == total
    return out


# --------------------------------------------------------------------------
# The tag coder's title passes (models/tag.py; its numpy renderers serve
# only the malformed sections tag_render and tag_render_values decline)
# --------------------------------------------------------------------------

def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _ptrs(arrays) -> ctypes.Array:
    """A C array of the arrays' data pointers (None: a null pointer)."""
    return (ctypes.c_void_p * max(len(arrays), 1))(
        *[a.ctypes.data if a is not None else None for a in arrays])


def tag_tokenize(stream: np.ndarray, lengths: np.ndarray, max_fields: int):
    """The modal token structure of the titles (stream u8, lengths i64 [R],
    R >= 1, every length >= 0, len(stream) >= their sum; ValueError
    otherwise): (k, seps u8 [k-1], tok_start [Rm, k], tok_len [Rm, k],
    match_idx, exc_idx), the fields of models/tag.py's TokenTable as
    dsrc_tpu's tokenize gives them, or None for no dominant structure."""
    lib = _load()
    stream = np.ascontiguousarray(stream, np.uint8)
    lengths = np.ascontiguousarray(lengths, np.int64)
    r = len(lengths)
    if r < 1 or lengths.min() < 0 or len(stream) < int(lengths.sum()):
        raise ValueError("tag_tokenize: one title or more, lengths >= 0 "
                         "that the stream holds")
    seps = np.zeros(max_fields, np.uint8)
    match = np.empty(r, np.uint8)
    k = lib.dsrc_tag_structure(_u8(stream), _i64(lengths), r, max_fields,
                               _u8(seps), _u8(match))
    if k == -2:
        raise MemoryError("tag structure")
    if k < 0:
        return None
    match = match.view(bool)
    match_idx = np.flatnonzero(match).astype(np.int64)
    exc_idx = np.flatnonzero(~match).astype(np.int64)
    tok_start = np.empty((len(match_idx), k), np.int64)
    tok_len = np.empty((len(match_idx), k), np.int64)
    if lib.dsrc_tag_tokens(_u8(stream), _i64(lengths), r, k,
                           _u8(match.view(np.uint8)), _i64(tok_start),
                           _i64(tok_len)) < 0:
        return None
    return k, seps[:k - 1].copy(), tok_start, tok_len, match_idx, exc_idx


def tag_classify(stream: np.ndarray, tok_start: np.ndarray,
                 tok_len: np.ndarray, max_digits: int, max_const: int):
    """Each field of a token table [Rm, k] (Rm >= 1) as constant (0),
    numeric (1) or text (2), in one pass over its tokens: (kind i32 [k],
    pad i64 [k], vals i64 [k, Rm], a numeric field's values in its row)."""
    lib = _load()
    stream = np.ascontiguousarray(stream, np.uint8)
    tok_start = np.ascontiguousarray(tok_start, np.int64)
    tok_len = np.ascontiguousarray(tok_len, np.int64)
    rm, k = tok_start.shape
    if rm < 1 or tok_len.shape != (rm, k):
        raise ValueError("tag_classify: a token table of one record or more")
    kind = np.empty(k, np.int32)
    pad = np.empty(k, np.int64)
    vals = np.empty((k, rm), np.int64)
    if lib.dsrc_tag_classify(_u8(stream), _i64(tok_start), _i64(tok_len),
                             rm, k, max_digits, max_const, _i32(kind),
                             _i64(pad), _i64(vals)) < 0:
        raise MemoryError("tag_classify")
    return kind, pad, vals


def tag_render(num_rec: int, seps: np.ndarray, kind: np.ndarray,
               arg: np.ndarray, data, ivec, exc_idx: np.ndarray,
               exc_lens: np.ndarray, exc_bytes: np.ndarray, bound: int):
    """The titles of a token-coded section from its decoded fields (see
    native/host_ops.cpp:dsrc_tag_render; data and ivec hold one array or
    None a field, every array contiguous and of its C type), in at most
    `bound` bytes: (titles u8, lengths i64 [num_rec]), or None when a
    padded value is wider than its pad or exc_idx is out of order."""
    lib = _load()
    out = np.empty(max(bound, 1), np.uint8)
    lens = np.empty(num_rec, np.int64)
    n = lib.dsrc_tag_render(num_rec, len(kind), _u8(seps), _i32(kind),
                            _i64(arg), _ptrs(data), _ptrs(ivec),
                            _i64(exc_idx), len(exc_idx), _i64(exc_lens),
                            _u8(exc_bytes), _i64(lens), _u8(out))
    if n == -3:
        raise MemoryError("tag_render")
    if n < 0:
        return None
    return out[:n], lens


def tag_render_values(num_rec: int, seps: np.ndarray, kind: np.ndarray,
                      arg: np.ndarray, data, vmat: np.ndarray, bound: int):
    """The titles of a SEMI title mode 2 block from its value matrix vmat
    i64 [num_rec, ncols] (see native/host_ops.cpp:dsrc_tag_render_values),
    in at most `bound` bytes: (titles u8, lengths i64 [num_rec])."""
    lib = _load()
    out = np.empty(max(bound, 1), np.uint8)
    lens = np.empty(num_rec, np.int64)
    n = lib.dsrc_tag_render_values(num_rec, len(kind), _u8(seps),
                                   _i32(kind), _i64(arg), _ptrs(data),
                                   _i64(vmat), vmat.shape[1], _i64(lens),
                                   _u8(out))
    return out[:n], lens
