#!/usr/bin/env python3
"""Measure what sets the step of A19's order-0 decode on one NVIDIA card,
and time K4 (dsrc_tpu_torch/csrc/a19_dec.cu) and its variants beside K2 at
P = 1, the route that served A19 before K4.

    python3 k4_variants.py [--reps 5] [--sass FILE]
    python3 k4_variants.py --host-issued 5 [--tree DIR]

The first form prints:
  probe     K2 (csrc/rans_dec.cu) at P = 1 and group T, built from a copy
            of its source with clock64 stamps inserted by text (the
            committed kernel has none): thread 0 of lane 0's warp sums,
            over its steps, the cycles of each part of a step:
            bookkeeping (the record, tile and run loops, the act test, the
            run store), the symbol search (row read, ballot, popcount), the
            two cum reads and the state update, the refill (word, window,
            shuffle); with every lane running and with lane 0 alone.  A
            stamp waits for its value (a volatile shared store) and costs
            cycles itself: `marked_cycles` is the probed step, beside the
            unprobed kernel's ns a step.
  least     the least dependent step the card allows: a chain of one
            shared-memory load (the slot table's entry), one 32-bit
            multiply-add and a compare-select, on one thread and on 32
            threads at their own slots, with 8- and 4-byte entries
            (least_step); `ns` is the best of them, the step that K4's
            chain bound (T x ns) is held to.
  k4_probe  K4 built from a copy of its source with stamps: lane 0 sums
            the cycles of each full group of 16 steps, split into the
            ring's refill and the 16 steps (with every lane running and
            with lane 0 alone).
  variants  K4 as committed and with 4-byte entries (f << 14 | bias; the
            committed source with kWideEntries = false), at 16, 32, 64 and
            128 lanes a block, on chip_smoke.a19_stream at T = 2,048,
            16,384 and 65,536: each exact against the encoded symbols,
            device ms and the chain floor (lane 0 alone), beside K2 at
            P = 1.
The second form times K1 and K2 on an 8 MB block's SEMI quality stream
(chip_smoke.kernel_checks) and K1 and K3 on a 64 MB -m1 block's quality
stream (chip_smoke.ctx_checks) as the host issues them, `--host-issued`
times, with the chip_smoke.py and dsrc_tpu_torch of the checkout at --tree:
for two commits in one call (parent, change, change, parent).

Everything is built in parallel with nvcc (the port's flags) into
build/k4_variants/.  Prints one JSON line per measurement, then the card's
name and power limit; needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import io
import json
import os
import statistics
import subprocess
import sys
from typing import Optional

ROOT = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(ROOT, "build", "k4_variants")
LEAST_STEPS = 1 << 16
LANES_PER_BLOCK = (16, 32, 64, 128)
_WIDE = "constexpr bool kWideEntries = true;"

_LEAST = r"""
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 1 << 14;
__shared__ uint32_t sink;

__device__ __forceinline__ unsigned long long clock_after(uint32_t dep) {
  *reinterpret_cast<volatile uint32_t*>(&sink) = dep;
  unsigned long long c;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c) :: "memory");
  return c;
}

__device__ __forceinline__ unsigned long long ns_now() {
  unsigned long long g;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g) :: "memory");
  return g;
}

// One chain a thread: e = tab[x & (2^14 - 1)]; y = f * (x >> 14) + bias;
// x = y < 2^16 ? (y << 16 | w) : y.
template <bool kWide>
__global__ void least_step(const uint32_t* __restrict__ init, int steps,
                           int active, uint32_t* __restrict__ xs,
                           unsigned long long* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t tab[];
  for (int i = threadIdx.x; i < (kWide ? 2 : 1) * kSlots; i += blockDim.x)
    tab[i] = init[i];
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= active) return;
  uint32_t x = xs[threadIdx.x];
  const uint32_t w = 0x9e37u + threadIdx.x;
  const unsigned long long c0 = clock_after(x), g0 = ns_now();
#pragma unroll 16
  for (int i = 0; i < steps; ++i) {
    const uint32_t slot = x & (kSlots - 1);
    uint32_t y;
    if constexpr (kWide) {
      const uint2 e = reinterpret_cast<const uint2*>(tab)[slot];
      y = e.x * (x >> 14) + e.y;
    } else {
      const uint32_t e = tab[slot];
      y = (e >> 14) * (x >> 14) + (e & (kSlots - 1));
    }
    x = y < (1u << 16) ? __byte_perm(w, y, 0x5410) : y;
  }
  const unsigned long long c1 = clock_after(x), g1 = ns_now();
  xs[threadIdx.x] = x;
  if (threadIdx.x == 0) {
    out[0] = c1 - c0;
    out[1] = g1 - g0;
  }
}

}  // namespace

extern "C" int dsrc_k4_least(const void* init, int steps, int active,
                             int wide, void* xs, void* out, void* stream) {
  const size_t smem = (wide ? 8 : 4) * kSlots;
  const void* fn = wide ? reinterpret_cast<const void*>(least_step<true>)
                        : reinterpret_cast<const void*>(least_step<false>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint32_t*>(init);
  auto* x = static_cast<uint32_t*>(xs);
  auto* o = static_cast<unsigned long long*>(out);
  if (wide)
    least_step<true><<<1, 32, smem, s>>>(in, steps, active, x, o);
  else
    least_step<false><<<1, 32, smem, s>>>(in, steps, active, x, o);
  return static_cast<int>(cudaGetLastError());
}
"""

# K2's probe: stamps inserted into a copy of rans_dec.cu (anchor, text
# inserted before it, text inserted after it); each anchor must occur once
_PROBE_HEAD = r"""
__device__ unsigned long long k4_probe[7];
__shared__ uint32_t k4_sink;

__device__ __forceinline__ unsigned long long k4_clock(uint32_t dep) {
  // the volatile store waits for `dep`; the clock is read after it
  *reinterpret_cast<volatile uint32_t*>(&k4_sink) = dep;
  unsigned long long c;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c) :: "memory");
  return c;
}
#define K4_MARK(i, dep)                                               \
  do {                                                                \
    if (probe) {                                                      \
      const unsigned long long c_ = k4_clock(static_cast<uint32_t>(dep)); \
      if ((i) == 0) {                                                 \
        if (last) acc[0] += c_ - last;                                \
        ++nsteps;                                                     \
      } else {                                                        \
        acc[i] += c_ - last;                                          \
      }                                                               \
      last = c_;                                                      \
    }                                                                 \
  } while (0)
"""
_PROBE_EDITS = (
    ("namespace {\n\nconstexpr uint32_t kProbBits", _PROBE_HEAD, ""),
    ("  extern __shared__ int32_t tab[];\n", "", """\
  const bool probe = blockIdx.x == 0 && threadIdx.x == 0;
  unsigned long long acc[4] = {0, 0, 0, 0}, last = 0, nsteps = 0;
  unsigned long long c_start = 0, g_start = 0;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c_start) :: "memory");
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_start) :: "memory");
"""),
    ("          const int32_t slot = static_cast<int32_t>(x & kMask);\n",
     "          K4_MARK(0, x);\n", ""),
    ("          const int s = min(count, nsym - 1);\n", "",
     "          K4_MARK(1, s);\n"),
    ("            x = f * (x >> kProbBits) + static_cast<uint32_t>(slot) - c;"
     "\n", "", "            K4_MARK(2, x);\n"),
    ("              wsel = (o & 1) ? kHighHalf : kLowHalf;\n            }\n"
     "          }\n", "",
     "          K4_MARK(3, x ^ static_cast<uint32_t>(wpair));\n"),
    ("  if (live && k < tt) orow[t0 + k] = keep;\n", "", """\
  if (probe) {
    unsigned long long c_end, g_end;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(c_end) :: "memory");
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_end) :: "memory");
    for (int i = 0; i < 4; ++i) k4_probe[i] += acc[i];
    k4_probe[4] += nsteps;
    k4_probe[5] += c_end - c_start;
    k4_probe[6] += g_end - g_start;
  }
"""),
)
_PROBE_TAIL = r"""
// Copies the probe's sums (k4_probe, 7 u64) to `out` and zeroes them.
extern "C" int dsrc_k4_probe(void* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k4_probe, sizeof(k4_probe));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[7] = {};
  return static_cast<int>(cudaMemcpyToSymbol(k4_probe, zero, sizeof(zero)));
}
"""
PROBE_PARTS = ("bookkeeping", "search", "cum_reads_update", "refill")

# K4's probe: thread 0 of block 0 (lane 0) sums the cycles of each full
# group of 16 steps, split at the ring's refill: the refill (its copies
# issued, the wait for the older ones) and the 16 steps with their store
_K4_PROBE_HEAD = r"""
__device__ unsigned long long k4p_probe[5];
__shared__ uint32_t k4p_sink;

__device__ __forceinline__ unsigned long long k4p_clock(uint32_t dep) {
  *reinterpret_cast<volatile uint32_t*>(&k4p_sink) = dep;
  unsigned long long c;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c) :: "memory");
  return c;
}
"""
_K4_PROBE_EDITS = (
    ("namespace {\n\nconstexpr int kProbBits", _K4_PROBE_HEAD, ""),
    ("  uint32_t x = states[lane];\n", "", """\
  const bool probe = lane == 0;
  unsigned long long pacc[2] = {0, 0}, ngroups = 0, m0 = 0, m1 = 0;
  const unsigned long long c_start = k4p_clock(x);
  unsigned long long g_start;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_start) :: "memory");
"""),
    ("  for (; t + kGroup <= len; t += kGroup) {\n    boundary();\n", "",
     "    if (probe) m1 = k4p_clock(static_cast<uint32_t>(wq ^ rp));\n"),
    ("  for (; t + kGroup <= len; t += kGroup) {\n",
     "", "    if (probe) m0 = k4p_clock(x);\n"),
    ("      for (int i = 0; i < kGroup; ++i) w[i >> 2] |= step() << (8 * (i & 3));"
     "\n      *reinterpret_cast<uint4*>(orow + t) = make_uint4(w[0], w[1], w[2],"
     " w[3]);\n", "", """\
      if (probe) {
        const unsigned long long m2 = k4p_clock(w[3] ^ x);
        pacc[0] += m1 - m0;
        pacc[1] += m2 - m1;
        ++ngroups;
      }
"""),
    ("  cp_async_wait<0>();\n  // the held state's symbol", """\
  if (probe) {
    const unsigned long long c_end = k4p_clock(x);
    unsigned long long g_end;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_end) :: "memory");
    k4p_probe[0] += pacc[0];
    k4p_probe[1] += pacc[1];
    k4p_probe[2] += ngroups;
    k4p_probe[3] += c_end - c_start;
    k4p_probe[4] += g_end - g_start;
  }
""", ""),
)
_K4_PROBE_TAIL = r"""
// Copies the probe's sums (k4p_probe, 5 u64) to `out` and zeroes them.
extern "C" int dsrc_k4_probe(void* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k4p_probe, sizeof(k4p_probe));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[5] = {};
  return static_cast<int>(cudaMemcpyToSymbol(k4p_probe, zero, sizeof(zero)));
}
"""


def edit(src: str, edits) -> str:
    """src with each (anchor, before, after) applied; an anchor must occur
    exactly once, so the harness follows the committed kernel."""
    for anchor, before, after in edits:
        if src.count(anchor) != 1:
            raise AssertionError(f"anchor not found once: {anchor[:60]!r}")
        src = src.replace(anchor, before + anchor + after)
    return src


def probe_source(src: str) -> str:
    """K2's source with the probe's stamps."""
    return edit(src, _PROBE_EDITS) + _PROBE_TAIL


def k4_probe_source(src: str) -> str:
    """K4's source with the probe's stamps."""
    return edit(src, _K4_PROBE_EDITS) + _K4_PROBE_TAIL


def entry32_source(src: str) -> str:
    if src.count(_WIDE) != 1:
        raise AssertionError("kWideEntries no longer matches a19_dec.cu")
    return src.replace(_WIDE, "constexpr bool kWideEntries = false;")


def _nvcc(cu: str, lib: str) -> subprocess.Popen:
    from dsrc_tpu_torch.ops import cuda_build
    return subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", cuda_build.CSRC,
         "-o", lib, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def build_least(out_dir: str) -> subprocess.Popen:
    """Start nvcc on the least-step source into out_dir/libk4_least.so."""
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "k4_least.cu")
    with open(cu, "w") as f:
        f.write(_LEAST)
    return _nvcc(cu, os.path.join(out_dir, "libk4_least.so"))


def build_all() -> dict:
    """Build the probe, the least step and the K4 variant in parallel:
    {name: library}."""
    from dsrc_tpu_torch.ops import cuda_build
    os.makedirs(BUILD, exist_ok=True)
    read = lambda n: open(os.path.join(cuda_build.CSRC, n)).read()  # noqa
    procs = {"least": (os.path.join(BUILD, "libk4_least.so"),
                       build_least(BUILD))}
    for name, text in (("k2_probe", probe_source(read("rans_dec.cu"))),
                       ("k4_probe", k4_probe_source(read("a19_dec.cu"))),
                       ("k4_entry32", entry32_source(read("a19_dec.cu")))):
        cu = os.path.join(BUILD, name + ".cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(BUILD, f"lib{name}.so")
        procs[name] = (lib, _nvcc(cu, lib))
    cuda_build.load_all()
    libs = {"k4": cuda_build._lib_path("a19_dec")}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise AssertionError(f"{name} does not build:\n{log}")
        emit({"build": name, "ptxas": cuda_build.ptxas_usage(log)})
        libs[name] = lib
    return libs


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def least_step(device, lib: str, steps: int = LEAST_STEPS) -> dict:
    """The least step's cycles and ns on each form; `ns` and `cycles` the
    best form's."""
    import numpy as np
    import torch
    fn = ctypes.CDLL(lib).dsrc_k4_least
    fn.argtypes = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)
    fn.restype = ctypes.c_int
    rng = np.random.default_rng(4)
    f = rng.integers(1, 1 << 14, 1 << 14)
    bias = rng.integers(0, 1 << 14, 1 << 14)
    tables = {True: np.stack([f, bias], 1).reshape(-1),
              False: (f << 14) | bias}
    out = {"steps": steps}
    for wide in (True, False):
        init = torch.from_numpy(tables[wide].astype(np.uint32).view(
            np.int32)).to(device)
        for active in (1, 32):
            xs = torch.from_numpy(rng.integers(1 << 16, 1 << 31, 32).astype(
                np.int32)).to(device)
            res = torch.zeros(2, dtype=torch.int64, device=device)
            stream = torch.cuda.current_stream(device).cuda_stream
            for _ in range(2):                  # the second run counts
                rc = fn(init.data_ptr(), steps, active, int(wide),
                        xs.data_ptr(), res.data_ptr(), stream)
                if rc != 0:
                    raise AssertionError(f"least step: CUDA error {rc}")
            cyc, ns = res.tolist()
            key = f"{'entry8' if wide else 'entry4'}_{active}_threads"
            out[key] = {"cycles": cyc / steps, "ns": ns / steps}
    best = min((v for v in out.values() if isinstance(v, dict)),
               key=lambda v: v["ns"])
    out["ns"], out["cycles"] = best["ns"], best["cycles"]
    return out


def _entry(lib: str, name: str, argtypes):
    fn = getattr(ctypes.CDLL(lib), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def k4_call(lib: str, lanes_per_block: int, st: dict, lanes: int = 0):
    """A K4 launch from `lib` on stream st (its first `lanes` lanes, all
    when 0), as ops/a19_kernels.a19_decode makes it; returns a call."""
    import torch
    from dsrc_tpu_torch.ops import a19_kernels as AK
    from dsrc_tpu_torch.ops import rans_kernels as RK
    fn = _entry(lib, "dsrc_a19_decode", RK._SIGNATURES["dsrc_a19_decode"][1])
    lanes = lanes or st["lanes"]
    t = st["t"]
    n = st["n"] if lanes == st["lanes"] else t
    pl, states, wptr = (st[k][:lanes].contiguous()
                        for k in ("payload", "states", "wptr"))
    fields = AK._FIELDS(*st["fields"])
    dev = pl.get_device()

    def run():
        out = torch.empty(lanes * t, dtype=torch.uint8, device=pl.device)
        rc = fn(pl.data_ptr(), pl.shape[1], states.data_ptr(),
                wptr.data_ptr(), fields, n, t, lanes, lanes_per_block,
                out.data_ptr(), dev, RK._stream(dev))
        if rc != 0:
            raise AssertionError(f"K4 from {lib}: CUDA error {rc}")
        return out
    return run


def k2_call(lib: str, st: dict, lanes: int = 0):
    """K2 at P = 1 and group T from `lib`, as rans_kernels.rans_decode
    launches it, on stream st (its first `lanes` lanes, all when 0)."""
    import torch
    from dsrc_tpu_torch.ops import rans_kernels as RK
    from dsrc_tpu_torch.ops.rans import cum_from_freqs
    fn = _entry(lib, "dsrc_rans_decode", RK._SIGNATURES["dsrc_rans_decode"][1])
    lanes = lanes or st["lanes"]
    t = st["t"]
    n = st["n"] if lanes == st["lanes"] else t
    pl, states, wptr = (st[k][:lanes].contiguous()
                        for k in ("payload", "states", "wptr"))
    cum = cum_from_freqs(st["freqs"])[None, :].contiguous()
    ne, stride, tile_rows = RK.dec_layout(19, 1)
    dev = pl.get_device()

    def run():
        out = torch.empty((lanes * t, 1), dtype=torch.int32, device=pl.device)
        rc = fn(pl.data_ptr(), pl.shape[1], states.data_ptr(),
                wptr.data_ptr(), cum.data_ptr(), 1, 19, ne, stride,
                tile_rows, t, lanes, min(n, lanes * t), out.data_ptr(), dev,
                RK._stream(dev))
        if rc != 0:
            raise AssertionError(f"K2 from {lib}: CUDA error {rc}")
        return out
    return run


def k2_probe(lib: str, st: dict, lanes: int) -> dict:
    """The probe's parts of K2's step at P = 1 (thread 0 of lane 0's warp),
    with the first `lanes` lanes running."""
    import torch
    read = _entry(lib, "dsrc_k4_probe", (ctypes.c_void_p,))
    acc = (ctypes.c_ulonglong * 7)()
    call = k2_call(lib, st, lanes)
    call()
    torch.cuda.synchronize()
    if read(ctypes.cast(acc, ctypes.c_void_p)) != 0:    # zero the sums
        raise AssertionError("dsrc_k4_probe failed")
    call()
    torch.cuda.synchronize()
    if read(ctypes.cast(acc, ctypes.c_void_p)) != 0:
        raise AssertionError("dsrc_k4_probe failed")
    steps = max(1, acc[4])
    out = {f"{p}_cycles": acc[i] / steps for i, p in enumerate(PROBE_PARTS)}
    out["marked_cycles"] = sum(acc[i] for i in range(4)) / steps
    out["lane_cycles_per_step"] = acc[5] / steps
    out["lane_ns_per_step"] = acc[6] / steps
    out["sm_ghz"] = acc[5] / acc[6] if acc[6] else None
    out["steps"] = acc[4]
    return out


def k4_probe(lib: str, st: dict, lanes: int) -> dict:
    """K4's probe (lane 0, 32 lanes a block): cycles of a group of 16
    steps, split into the ring's refill and the steps, with the first
    `lanes` lanes running."""
    import torch
    read = _entry(lib, "dsrc_k4_probe", (ctypes.c_void_p,))
    acc = (ctypes.c_ulonglong * 5)()
    call = k4_call(lib, 32, st, lanes)
    call()
    torch.cuda.synchronize()
    if read(ctypes.cast(acc, ctypes.c_void_p)) != 0:    # zero the sums
        raise AssertionError("dsrc_k4_probe failed")
    call()
    torch.cuda.synchronize()
    if read(ctypes.cast(acc, ctypes.c_void_p)) != 0:
        raise AssertionError("dsrc_k4_probe failed")
    groups = max(1, acc[2])
    return {"refill_cycles_per_group": acc[0] / groups,
            "steps_cycles_per_step": acc[1] / groups / 16,
            "lane_cycles_per_step": acc[3] / groups / 16,
            "lane_ns_per_step": acc[4] / groups / 16, "groups": acc[2]}


def compare(reps: int, sass: Optional[str]) -> None:
    """The first form (module docstring); with `sass`, K4's machine code
    (cuobjdump -sass of the committed library) is written to that file."""
    import torch
    import chip_smoke as CS
    from dsrc_tpu_torch.ops import cuda_build
    device = torch.device("cuda", 0)
    libs = build_all()
    if sass:
        cuobjdump = os.path.join(os.path.dirname(cuda_build._nvcc()),
                                 "cuobjdump")
        with open(sass, "w") as f:
            subprocess.run([cuobjdump, "-sass", libs["k4"]], stdout=f,
                           check=True)
    least = least_step(device, libs["least"])
    emit(dict(measure="least_step", **least))
    k2_committed = cuda_build._lib_path("rans_dec")
    for n, name in CS.A19_SHAPES:
        st = CS.a19_stream(device, n)
        t = st["t"]
        want = st["syms"][:n]
        for lanes in (st["lanes"], 1):
            emit(dict(measure="k2_probe", stream=name, T=t, lanes=lanes,
                      **k2_probe(libs["k2_probe"], st, lanes)))
            emit(dict(measure="k4_probe", stream=name, T=t, lanes=lanes,
                      **k4_probe(libs["k4_probe"], st, lanes)))
        line = {"measure": "times", "stream": name, "n": n, "T": t,
                "L": st["lanes"], "chain_bound_ms": least["ns"] * t / 1e6}
        for lanes, key in ((0, ""), (1, "_lane0_alone")):
            k2 = k2_call(k2_committed, st, lanes)
            line[f"k2{key}_device_ms"] = CS.time_device_ms(k2, reps)
            for vname in ("k4", "k4_entry32"):
                for lpb in LANES_PER_BLOCK:
                    k4 = k4_call(libs[vname], lpb, st, lanes)
                    got = k4()
                    ref = st["syms"][:t] if lanes else want
                    if not torch.equal(got[:len(ref)].to(torch.int32), ref):
                        raise AssertionError(f"{vname} at {lpb} lanes a "
                                             f"block differs on {name}")
                    line[f"{vname}_{lpb}{key}_device_ms"] = \
                        CS.time_device_ms(k4, reps)
        emit(line)
        del st
        torch.cuda.empty_cache()


def host_issued(times: int) -> None:
    """The second form (module docstring), on the chip_smoke and
    dsrc_tpu_torch first on sys.path."""
    import contextlib
    import torch
    import chip_smoke as CS
    from dsrc_tpu_torch.io.chunker import FastqChunker
    from dsrc_tpu_torch.ops import cuda_build
    cuda_build.load_all()
    device = torch.device("cuda", 0)
    streams = CS.block_streams(device, (8 * CS.MB) // 250,
                               (8 * CS.MB) // 250)[:1]
    big = CS.realistic_of_size(128 * CS.MB - 4096, seed=81)
    block64 = FastqChunker(io.BytesIO(big), 64 * CS.MB).next_block() \
        .tobytes()
    del big
    m1 = [s for s in CS.ctx_streams(device, block64, CS.m1_params(
        64 * CS.MB)) if s["name"] == "quality"]
    runs = {"k1_semi_qual": [], "k2_semi_qual": [], "k1_m1_quality": [],
            "k3_m1_quality": []}
    for _ in range(times):
        with contextlib.redirect_stdout(io.StringIO()):
            semi = CS.kernel_checks(device, streams, reps=50)
            q = CS.ctx_checks(device, m1, "64MB", timed=True,
                              check_plain=False)["quality"]
        runs["k1_semi_qual"].append(semi["rans_encode"]["ms"])
        runs["k2_semi_qual"].append(semi["rans_decode"]["ms"])
        runs["k1_m1_quality"].append(q["k1_ms"])
        runs["k3_m1_quality"].append(q["k3_ms"])
    for k, ms in runs.items():
        emit({"host_issued": k, "ms_median": statistics.median(ms),
              "ms_min": min(ms), "ms_max": max(ms), "ms": ms})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sass", default=None,
                    help="the first form: write K4's machine code here")
    ap.add_argument("--host-issued", type=int, default=0,
                    help="the second form: repeat each timing this often")
    ap.add_argument("--tree", default=ROOT,
                    help="the checkout whose chip_smoke.py and "
                         "dsrc_tpu_torch the second form runs")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        print("k4_variants: needs an NVIDIA card", file=sys.stderr)
        return 2
    CS = importlib.import_module("chip_smoke")
    if args.host_issued:
        emit({"tree": os.path.abspath(args.tree)})
        host_issued(args.host_issued)
    else:
        compare(args.reps, args.sass)
    print(CS.card_info(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
