"""ctypes bindings for the native host library (native/host_ops.cpp).

Loads native/libdsrc_host.so when present (build with `make -C native`);
every entry point has a numpy fallback so the package works without the
native build.  pybind11 is not available in this image, hence plain C ABI.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB is not None:
        return _LIB
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.path.join(root, "native", "libdsrc_host.so")
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i64 = ctypes.c_int64
    lib.dsrc_scan_records.restype = i64
    lib.dsrc_scan_records.argtypes = [u8p, i64, i64,
                                      ctypes.POINTER(ctypes.c_int64)]
    lib.dsrc_pack2.restype = None
    lib.dsrc_pack2.argtypes = [u8p, i64, u8p]
    lib.dsrc_unpack2.restype = None
    lib.dsrc_unpack2.argtypes = [u8p, i64, u8p]
    lib.dsrc_compact_payload.restype = i64
    lib.dsrc_compact_payload.argtypes = [i32p, i64, i64, i32p, u16p]
    lib.dsrc_compact_payload_right.restype = i64
    lib.dsrc_compact_payload_right.argtypes = [i32p, i64, i64, i32p, u16p]
    lib.dsrc_expand_payload.restype = None
    lib.dsrc_expand_payload.argtypes = [u16p, i64, i64, i32p, i32p]
    i64p = ctypes.POINTER(ctypes.c_int64)
    if hasattr(lib, "dsrc_stage_semi"):
        lib.dsrc_stage_semi.restype = i64
        lib.dsrc_stage_semi.argtypes = [u8p, i64, i64, i64, u8p, u8p,
                                        u8p, i64p]
        lib.dsrc_layout_records.restype = i64
        lib.dsrc_layout_records.argtypes = [
            i64, u8p, i64p, u8p, u8p, i64p, u8p,
            ctypes.c_int32, ctypes.c_int32, u8p]
    _LIB = lib
    return lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


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
    if lib is not None and hasattr(lib, "dsrc_layout_records"):
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
