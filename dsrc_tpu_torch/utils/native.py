"""ctypes bindings for the native host library (native/host_ops.cpp).

The library is built at first use, as ops/cuda_build.py builds the CUDA
kernels: g++ compiles native/host_ops.cpp into build/dsrc_tpu_torch/ beside
the package (a directory .gitignore lists), named by a hash of the source
and the flags, so a changed source is never served by a stale library.
A file lock makes one process of many build it, and the build writes a
temporary name that os.replace renames, so no process loads a half-written
library.  Every entry point has a numpy fallback that gives the same bytes;
without g++, or when the build fails, the fallbacks serve, and each call
they serve counts `native.fallback` on the recorder (utils/trace.py).
The library has a plain C ABI, bound by ctypes: its build needs no Python
or PyTorch headers.
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

from . import trace

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "host_ops.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "dsrc_tpu_torch")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
FALLBACK = "native.fallback"

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_PATH: Optional[str] = None
_TRIED = False


def lib_path() -> str:
    """The library's path, named by a hash of its source and the flags."""
    with open(SOURCE, "rb") as f:
        h = hashlib.sha1(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libdsrc_host-{h.hexdigest()[:12]}.so")


def _compiler() -> Optional[str]:
    return shutil.which("g++")


def build() -> Optional[str]:
    """The library's path, compiled first when it is missing; None when
    there is no g++ or the build fails."""
    try:
        out = lib_path()
        if os.path.exists(out):
            return out
        cxx = _compiler()
        if cxx is None:
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(out + ".lock", "wb") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.exists(out):
                tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
                try:
                    subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                                   check=True, capture_output=True)
                    os.replace(tmp, out)
                finally:
                    if os.path.exists(tmp):
                        os.remove(tmp)
    except (OSError, subprocess.CalledProcessError):
        return None
    return out


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i64 = ctypes.c_int64
    lib.dsrc_scan_records.restype = i64
    lib.dsrc_scan_records.argtypes = [u8p, i64, i64, i64p]
    lib.dsrc_compact_payload.restype = i64
    lib.dsrc_compact_payload.argtypes = [i32p, i64, i64, i32p, u16p]
    lib.dsrc_compact_payload_right.restype = i64
    lib.dsrc_compact_payload_right.argtypes = [i32p, i64, i64, i32p, u16p]
    lib.dsrc_expand_payload.restype = None
    lib.dsrc_expand_payload.argtypes = [u16p, i64, i64, i32p, i32p]
    lib.dsrc_stage_semi.restype = i64
    lib.dsrc_stage_semi.argtypes = [u8p, i64, i64, i64, u8p, u8p, u8p, i64p]
    lib.dsrc_layout_records.restype = i64
    lib.dsrc_layout_records.argtypes = [
        i64, u8p, i64p, u8p, u8p, i64p, u8p,
        ctypes.c_int32, ctypes.c_int32, u8p]
    i32 = ctypes.c_int32
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


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built at the first call of the process; None
    (every later call too) when it could not be built or loaded."""
    global _LIB, _PATH, _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        if not _TRIED:
            path = build()
            try:
                lib = ctypes.CDLL(path) if path else None
                if lib is not None:
                    _bind(lib)
            except (OSError, AttributeError):
                lib = None
            _LIB, _PATH = lib, path if lib is not None else None
            _TRIED = True
    return _LIB


def available() -> bool:
    return _load() is not None


def path() -> Optional[str]:
    """The loaded library's file (None: the numpy fallbacks serve)."""
    _load()
    return _PATH


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def scan_records(buf: np.ndarray, lines_before: int) -> Tuple[int, int]:
    """(newline_count, cut_position_after_last_boundary_or_-1)."""
    lib = _load()
    if lib is None:
        trace.count(FALLBACK)
        nl_pos = np.flatnonzero(buf == 10)
        n = len(nl_pos)
        if n == 0:
            return 0, -1
        k = (lines_before + np.arange(n) + 1) % 4 == 0
        hits = np.flatnonzero(k)
        return n, (int(nl_pos[hits[-1]]) + 1 if len(hits) else -1)
    buf = np.ascontiguousarray(buf, np.uint8)
    cut = ctypes.c_int64(-1)
    count = lib.dsrc_scan_records(_u8(buf), len(buf), lines_before,
                                  ctypes.byref(cut))
    return int(count), int(cut.value)


def compact_payload(payload: np.ndarray, nwords: np.ndarray,
                    right_aligned: bool = False) -> np.ndarray:
    """[L, W] i32 rows -> flat u16 word stream.

    Left-aligned rows keep the first nwords[j] words; right-aligned rows
    (the in-scan encoder layout) keep the last nwords[j]."""
    lib = _load()
    payload = np.ascontiguousarray(payload, np.int32)
    nwords = np.ascontiguousarray(nwords, np.int32)
    total = int(nwords.sum())
    w_max = payload.shape[1]
    if lib is None:
        trace.count(FALLBACK)
        cols = np.arange(w_max)[None, :]
        if right_aligned:
            mask = cols >= (w_max - nwords[:, None])
        else:
            mask = cols < nwords[:, None]
        return payload[mask].astype(np.uint16)
    out = np.empty(total, np.uint16)
    fn = lib.dsrc_compact_payload_right if right_aligned \
        else lib.dsrc_compact_payload
    fn(payload.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
       payload.shape[0], w_max,
       nwords.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
       out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    return out


def expand_payload(words: np.ndarray, nwords: np.ndarray,
                   w_max: int) -> np.ndarray:
    """Flat u16 stream -> [L, w_max] i32 rows."""
    lib = _load()
    nwords = np.ascontiguousarray(nwords, np.int32)
    l = len(nwords)
    if lib is None:
        trace.count(FALLBACK)
        payload = np.zeros((l, w_max), np.int32)
        mask = np.arange(w_max)[None, :] < nwords[:, None]
        payload[mask] = words
        return payload
    words = np.ascontiguousarray(words, np.uint16)
    payload = np.zeros((l, w_max), np.int32)
    lib.dsrc_expand_payload(
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        l, w_max,
        nwords.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        payload.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return payload


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def stage_semi(buf: np.ndarray, read_len: int, rpad: int):
    """One-pass semi-uniform block staging (native when built, numpy
    otherwise): validate the fixed-read-length 4-line layout and return
    (qual_mat [rpad, read_len] u8, seq_mat [rpad, read_len] u8,
    title_stream u8, title_lens i64, num_rec), or None when the block is
    not semi-layout.  Mirrors native/host_ops.cpp:dsrc_stage_semi."""
    lib = _load()
    b = np.ascontiguousarray(buf, np.uint8)
    n = len(b)
    if not (0 < read_len <= 8192) or n == 0 or b[-1] != 10:
        return None
    if lib is not None:
        qm = np.zeros((rpad, read_len), np.uint8)
        sm = np.zeros((rpad, read_len), np.uint8)
        tbuf = np.empty(n, np.uint8)
        tlens = np.zeros(rpad, np.int64)
        rec = lib.dsrc_stage_semi(_u8(b), n, read_len, rpad, _u8(qm),
                                  _u8(sm), _u8(tbuf), _i64(tlens))
        if rec < 0:
            return None
        total = int(tlens[:rec].sum())
        return qm, sm, tbuf[:total], tlens[:rec], int(rec)
    # numpy fallback: the vectorized multi-pass equivalent
    trace.count(FALLBACK)
    nl = np.flatnonzero(b == 10)
    if len(nl) == 0 or len(nl) % 4 or len(nl) // 4 > rpad:
        return None
    num_rec = len(nl) // 4
    starts = np.concatenate([[0], nl[:-1] + 1])
    l0, l1 = starts[0::4], starts[1::4]
    l2, l3 = starts[2::4], starts[3::4]
    e0, e1, e2, e3 = nl[0::4], nl[1::4], nl[2::4], nl[3::4]
    if not (((e1 - l1) == read_len).all()
            and ((e3 - l3) == read_len).all()
            and ((e2 - l2) == 1).all()
            and (b[l0] == ord("@")).all()
            and (b[l2] == ord("+")).all()):
        return None
    cols = np.arange(read_len)
    qual = b[l3[:, None] + cols]
    if qual.min() < 33 or qual.max() >= 33 + 64:
        return None
    seq = b[l1[:, None] + cols]
    if not np.isin(seq, np.frombuffer(b"ACGTN", np.uint8)).all():
        return None
    qm = np.zeros((rpad, read_len), np.uint8)
    qm[:num_rec] = qual
    sm = np.zeros((rpad, read_len), np.uint8)
    sm[:num_rec] = seq
    tl = (e0 - l0 - 1).astype(np.int64)
    total = int(tl.sum())
    reps = np.repeat(np.arange(num_rec), tl)
    offs = np.concatenate([[0], np.cumsum(tl)[:-1]]).astype(np.int64)
    within = np.arange(total, dtype=np.int64) - offs[reps]
    tstream = b[(l0 + 1)[reps] + within]
    return qm, sm, tstream, tl, num_rec


def layout_records(num_rec: int, titles: np.ndarray, title_lens: np.ndarray,
                   seq: np.ndarray, qual: np.ndarray, qual_lens: np.ndarray,
                   primers, color_space: bool, plus_rep: bool) -> np.ndarray:
    """Rebuild FASTQ text from decoded streams (decode-side mirror of
    stage_semi, for ALL block schemes).  Native single pass when built;
    numpy vectorized scatters otherwise."""
    tl = np.ascontiguousarray(title_lens, np.int64)[:num_rec]
    ql = np.ascontiguousarray(qual_lens, np.int64)[:num_rec]
    sl = ql + (1 if color_space else 0)
    plus_extra = tl if plus_rep else np.zeros_like(tl)
    total = int((1 + tl + 1 + sl + 1 + 1 + plus_extra + 1 + ql + 1).sum())
    lib = _load()
    if lib is not None:
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
    # numpy fallback: vectorized scatters
    trace.count(FALLBACK)
    rec_len = 1 + tl + 1 + sl + 1 + 1 + plus_extra + 1 + ql + 1
    starts = np.concatenate([[0], np.cumsum(rec_len)[:-1]]).astype(np.int64)
    out = np.zeros(total, np.uint8)
    out[starts] = ord("@")
    t_dst = starts + 1
    _scatter_var(out, titles, tl, t_dst)
    nl1 = t_dst + tl
    out[nl1] = 10
    s_dst = nl1 + 1
    if color_space:
        out[s_dst] = primers
        _scatter_var(out, seq, ql, s_dst + 1)
    else:
        _scatter_var(out, seq, ql, s_dst)
    nl2 = s_dst + sl
    out[nl2] = 10
    p_dst = nl2 + 1
    out[p_dst] = ord("+")
    if plus_rep:
        _scatter_var(out, titles, tl, p_dst + 1)
    nl3 = p_dst + 1 + plus_extra
    out[nl3] = 10
    q_dst = nl3 + 1
    _scatter_var(out, qual, ql, q_dst)
    out[q_dst + ql] = 10
    return out


def _scatter_var(out: np.ndarray, content: np.ndarray, lens: np.ndarray,
                 dst: np.ndarray) -> None:
    """out[dst[r] + i] = content[off[r] + i] for i < lens[r] (vectorized)."""
    total = int(lens.sum())
    if total == 0:
        return
    content = np.ascontiguousarray(content, np.uint8)
    reps = np.repeat(np.arange(len(lens), dtype=np.int64), lens)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    within = np.arange(total, dtype=np.int64) - offs[reps]
    out[dst[reps] + within] = content[:total]


# --------------------------------------------------------------------------
# The tag coder's title passes (models/tag.py holds their numpy fallbacks,
# and calls these only when available() is true)
# --------------------------------------------------------------------------

def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _ptrs(arrays) -> ctypes.Array:
    """A C array of the arrays' data pointers (None: a null pointer)."""
    return (ctypes.c_void_p * max(len(arrays), 1))(
        *[a.ctypes.data if a is not None else None for a in arrays])


def tag_tokenize(stream: np.ndarray, lengths: np.ndarray, max_fields: int):
    """The modal token structure of the titles (stream u8, lengths i64 [R],
    R >= 1, every length >= 0, len(stream) >= their sum): (k, seps u8
    [k-1], tok_start [Rm, k], tok_len [Rm, k], match_idx, exc_idx), the
    fields of models/tag.py's TokenTable as its numpy tokenize gives them,
    or None for no dominant structure."""
    lib = _load()
    stream = np.ascontiguousarray(stream, np.uint8)
    lengths = np.ascontiguousarray(lengths, np.int64)
    r = len(lengths)
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
