"""Build and load the port's CUDA kernels (dsrc_tpu_torch/csrc/*.cu).

Each source is compiled by nvcc into its own shared library with a plain C
interface, loaded with ctypes.  Nothing here includes PyTorch's headers, so
a build takes seconds.  Libraries are built at first use into
build/dsrc_tpu_torch/ beside the package (a directory .gitignore lists),
named by a hash of the source, the shared headers and the flags, so a
changed source is never served by a stale library.  Sources are compiled
in parallel: one nvcc per file, all started together.  nvcc runs with
-Xptxas -v and its log is kept beside each library (`.log`):
ptxas_usage() reads each kernel's registers, shared memory and spills
from it.

The build needs nvcc (CUDA_HOME/bin, /usr/local/cuda/bin or PATH); a
missing compiler or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable

from ..config import DsrcException

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "dsrc_tpu_torch")
SOURCES = ("rans_enc", "rans_dec", "ctx_dec", "hist", "a19_dec")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise DsrcException("nvcc not found: the CUDA kernels are built from "
                        "dsrc_tpu_torch/csrc at first use")


def _lib_path(name: str) -> str:
    """The library's path, named by a hash of its source, the headers
    beside it (csrc/*.cuh) and the flags."""
    h = hashlib.sha1(open(os.path.join(CSRC, name + ".cu"), "rb").read())
    for hdr in sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh")):
        h.update(open(os.path.join(CSRC, hdr), "rb").read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(names: Iterable[str] = SOURCES) -> None:
    """Compile every named source whose library is missing, in parallel."""
    todo = [n for n in names if not os.path.exists(_lib_path(n))]
    if not todo:
        return
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for n in todo:
        out = _lib_path(n)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, n + ".cu")]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for n, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{n}.cu: nvcc exit {proc.returncode}\n"
                          + log.decode(errors="replace"))
            continue
        with open(out + ".log", "wb") as f:
            f.write(log)
        os.replace(tmp, out)
    if errors:
        raise DsrcException("CUDA kernel build failed:\n" + "\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, building it at first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            build([name])
            _LIBS[name] = ctypes.CDLL(_lib_path(name))
        return _LIBS[name]


def load_all() -> None:
    """Build every kernel library (in parallel) and load it."""
    with _LOCK:
        build(SOURCES)
    for n in SOURCES:
        load(n)


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


# builtin types that name a template argument (the Itanium ABI's codes)
_TYPES = {"a": "int8_t", "h": "uint8_t", "s": "int16_t", "t": "uint16_t",
          "i": "int32_t", "j": "uint32_t", "l": "int64_t", "m": "uint64_t"}


def kernel_name(mangled: str) -> str:
    """'_ZN44_GLOBAL__N__7ef3696d_11_rans_dec_cu_8f53b51718rans_decode_kernel
    ILi2EEEv...' -> 'rans_decode_kernel<2>': the last length-prefixed name
    of the nested name, and its int, bool and builtin-type template
    arguments ('Lin1E' is -1, 'Lb1E' true, 'h' uint8_t)."""
    m = re.match(r"_ZN?", mangled)
    if not m:
        return mangled
    pos, name = m.end(), mangled
    while True:
        d = re.match(r"\d+", mangled[pos:])
        if not d:
            break
        pos += d.end()
        name = mangled[pos:pos + int(d.group())]
        pos += int(d.group())
    if mangled[pos:pos + 1] == "I":
        args = re.findall(r"L([ib])(n?)(\d+)E|([ahijlmst])",
                          mangled[pos + 1:].split("EE")[0] + "E")
        name += "<" + ",".join(
            _TYPES[ty] if ty else ("-" if neg else "") + num if kind == "i"
            else ("true" if num == "1" else "false")
            for kind, neg, num, ty in args) + ">"
    return name


def ptxas_usage(log: str) -> Dict[str, Dict[str, int]]:
    """Registers, static shared memory and spill bytes of every kernel in
    an nvcc -Xptxas -v log, by kernel name."""
    out: Dict[str, Dict[str, int]] = {}
    cur = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = out.setdefault(kernel_name(m.group(1)), {
                "registers": 0, "smem_bytes": 0, "spill_stores": 0,
                "spill_loads": 0})
            continue
        if cur is None:
            continue
        m = _SPILL.search(line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = _REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            s = _SMEM.search(line)
            cur["smem_bytes"] = int(s.group(1)) if s else 0
    return out


def build_usage(names: Iterable[str] = SOURCES) -> Dict[str, Dict]:
    """ptxas_usage of each built source's kept log."""
    usage = {}
    for n in names:
        with open(_lib_path(n) + ".log", encoding="utf-8",
                  errors="replace") as f:
            usage[n] = ptxas_usage(f.read())
    return usage
