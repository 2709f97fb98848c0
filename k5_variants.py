#!/usr/bin/env python3
"""Time K5's design alternatives (dsrc_tpu_torch/csrc/hist.cu) beside its
two routes on one NVIDIA card, and K5's host-issued time per call.

    python3 k5_variants.py [--reps 10]
    python3 k5_variants.py --host-repeat 7 [--tree DIR]

Variants, each a kernel of its own on hist.cu's element reading (the
source below includes hist.cu, so it follows the kernel), launched in
place of K5 when hist_kernels._ROUTE names them:
  narrow   a u32 copy of the bins for each of a block's 16 warps, so that
           the warps' atomics on a skewed few bins do not meet on one
           address; the block adds each bin's copies with one global
           atomic; up to HIST_SMEM_BUDGET / 64 bytes of bins
  cluster  one u32 copy spread over the distributed shared memory of a
           thread-block cluster of up to CLUSTER_MAX blocks, each block a
           slice of 2^s bins (cluster_geometry); an element's count goes
           to the owning block's slice by a shared-memory atomic, local or
           remote, after the lanes of a warp on one bin are merged;
           cluster.sync() after the zeroing and before the flush; up to
           CLUSTER_MAX << 15 bins
The first form replays every K5 call of one round trip of a 64 MB -m1
block (chip_smoke.hist_capture), each exact against its plain version and
timed on the committed routes and on each variant that can hold its bins
(chip_smoke.hist_checks); then the route sweep (chip_smoke.
hist_route_sweep) at the variants' widths: 65,536 to 2^18 bins at 0.125
to 16 elements a bin, global against cluster; 32 and 256 bins at 1 M and
25 M elements, shared against narrow; each point's counts on each route
held to the plain version's first.

The second form times each K5 call of one round trip of an 8 MB SEMI
block and an 8 MB mode-0 block as the host issues it (chip_smoke.time_ms
over 10 calls), `--host-repeat` times, and prints each call's median and
range; with --tree it runs the chip_smoke.py and dsrc_tpu_torch of that
checkout (an earlier commit's, unpacked by git archive), so that two
commits are compared in one call: parent, change, change, parent.

Prints one JSON line per group or call, then the card's name and power
limit; needs one CUDA card.
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
from typing import Optional, Tuple

ROOT = os.path.dirname(os.path.abspath(__file__))
VARIANTS = ("narrow", "cluster")
# the narrow variant's copies: one for each warp of a 512-thread block
NARROW_COPIES = 16
# the portable thread-block cluster size: the cluster variant holds at
# most CLUSTER_MAX slices of 2^k bins, each within HIST_SMEM_BUDGET
CLUSTER_MAX = 8
# elements a bin each cluster is given at least (it zeroes and flushes
# every bin): the number of clusters
CLUSTER_MIN_PER_BIN = 1
# the same bytes as hist_kernels.HIST_SMEM_BUDGET, kept here so that the
# geometry needs no import of the port
_SMEM_BUDGET = 227 * 1024
SWEEP = (
    [(b, k, ("global", "cluster")) for b in (65536, 131072, 262144)
     for k in (0.125, 0.25, 0.5, 1, 2, 4, 8, 16)]
    + [(b, n / b, ("shared", "narrow")) for b in (32, 256)
       for n in (1 << 20, 25 << 20)])

_SOURCE = r"""
#include <cooperative_groups.h>
#include "%(hist)s"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = kThreads / kLanes;  // narrow: a copy a warp
constexpr int kClusterThreads = 1024;      // cluster: 128 KB slices
constexpr int kMaxCluster = 8;

struct NarrowCount {  // the copy of this warp
  unsigned* copy;
  __device__ __forceinline__ void operator()(unsigned bin) const {
    if (bin != kNoBin) atomicAdd(copy + bin, 1u);
  }
};

struct ClusterCount {  // the owning block's slice, local or remote
  unsigned* counts;
  int shift;
  unsigned lane;
  __device__ __forceinline__ void operator()(unsigned bin) const {
    const unsigned peers = __match_any_sync(kFull, bin);
    if (bin != kNoBin && lane == static_cast<unsigned>(__ffs(peers) - 1)) {
      unsigned* owner = cg::this_cluster().map_shared_rank(
          counts, static_cast<int>(bin >> shift));
      atomicAdd(owner + (bin & ((1u << shift) - 1)),
                static_cast<unsigned>(__popc(peers)));
    }
  }
};

template <typename V>
__global__ void __launch_bounds__(kThreads)
    narrow_kernel(Params p, unsigned long long* __restrict__ hist) {
  extern __shared__ unsigned counts[];
  const int words = p.nbins * kWarps;
  for (int b = threadIdx.x; b < words; b += kThreads) counts[b] = 0;
  __syncthreads();
  NarrowCount count{counts + (threadIdx.x / kLanes) * p.nbins};
  count_elements<V>(p, count, blockIdx.x * kThreads + threadIdx.x,
                    gridDim.x * kThreads);
  __syncthreads();
  for (int b = threadIdx.x; b < p.nbins; b += kThreads) {
    unsigned v = 0;
    for (int w = 0; w < kWarps; ++w) v += counts[w * p.nbins + b];
    if (v != 0) atomicAdd(hist + b, static_cast<unsigned long long>(v));
  }
}

template <typename V>
__global__ void __launch_bounds__(kClusterThreads)
    cluster_kernel(Params p, int shift,
                   unsigned long long* __restrict__ hist) {
  extern __shared__ unsigned counts[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned slice = 1u << shift;
  for (unsigned b = threadIdx.x; b < slice; b += kClusterThreads)
    counts[b] = 0;
  cluster.sync();
  ClusterCount count{counts, shift, threadIdx.x & (kLanes - 1)};
  count_elements<V>(p, count, blockIdx.x * kClusterThreads + threadIdx.x,
                    gridDim.x * kClusterThreads);
  cluster.sync();
  const unsigned lo = cluster.block_rank() << shift;
  const unsigned nbins = static_cast<unsigned>(p.nbins);
  const unsigned end = lo >= nbins ? 0 : min(slice, nbins - lo);
  for (unsigned b = threadIdx.x; b < end; b += kClusterThreads) {
    const unsigned v = counts[b];
    if (v != 0) atomicAdd(hist + lo + b, static_cast<unsigned long long>(v));
  }
}

template <typename V>
cudaError_t launch_variant(const Params& p, const HistArgs& a, int variant,
                           int size, int shift, int clusters) {
  int sms = 0;
  cudaError_t err = sm_count(a.device, &sms);
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(p.rows) * p.cols;
  auto* hist = static_cast<unsigned long long*>(a.hist);
  auto stream = static_cast<cudaStream_t>(a.stream);
  if (variant == 0) {
    const void* fn = reinterpret_cast<const void*>(narrow_kernel<V>);
    const size_t smem =
        sizeof(unsigned) * kWarps * static_cast<size_t>(p.nbins);
    int per_sm = 0;
    err = blocks_per_sm(a.device, fn, kThreads, smem, &per_sm);
    if (err != cudaSuccess) return err;
    const long long blocks = clamp_blocks(
        (n + kThreads * kVec - 1) / (kThreads * kVec),
        static_cast<long long>(sms) * per_sm);
    narrow_kernel<V><<<static_cast<unsigned>(blocks), kThreads, smem,
                       stream>>>(p, hist);
    return cudaGetLastError();
  }
  const void* fn = reinterpret_cast<const void*>(cluster_kernel<V>);
  err = opt_in(a.device, fn);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(size);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(size));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = sizeof(unsigned) << shift;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  // kind: the cluster size, apart from the shared route's 0 and -1
  err = fact(a.device, fn, cfg.dynamicSmemBytes, size, [&](int* v) {
    return cudaOccupancyMaxActiveClusters(v, fn, &cfg);
  }, &active);
  if (err != cudaSuccess) return err;
  // a cluster the card cannot hold: refused, never another route
  if (active < 1) return cudaErrorLaunchOutOfResources;
  cfg.gridDim = dim3(static_cast<unsigned>(
      (clusters < active ? clusters : active) * size));
  err = cudaLaunchKernelEx(&cfg, cluster_kernel<V>, p, shift, hist);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return cudaGetLastError();
}

}  // namespace

// As dsrc_hist, on variant 0 (narrow) or 1 (cluster: `size` blocks a
// cluster, 2^shift bins a block, at most `clusters` clusters); args->route
// is 0 and vec_head and quads are the shared route's.
extern "C" int dsrc_hist_variant(const HistArgs* args, int variant,
                                 int size, int shift, int clusters) {
  const HistArgs& a = *args;
  if (!valid(a) || a.route != kShared || variant < 0 || variant > 1 ||
      (variant == 0 && sizeof(unsigned) * kWarps *
                               static_cast<size_t>(a.nbins) > kSmemBudget) ||
      (variant == 1 &&
       (size < 1 || size > kMaxCluster || shift < 5 ||
        (sizeof(unsigned) << shift) > static_cast<size_t>(kSmemBudget) ||
        (static_cast<long long>(size) << shift) < a.nbins || clusters < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.rows == 0) return 0;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != a.device) {
    err = cudaSetDevice(a.device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Params p{a.vals, static_cast<const int32_t*>(a.ctx),
                 static_cast<const uint8_t*>(a.mask),
                 static_cast<const int32_t*>(a.lengths), a.ld, a.t0, a.rows,
                 a.cols, a.hi_kind, a.nsym, a.nctx, a.nbins, a.vec_head,
                 a.quads};
  switch (a.vtype) {
    case 0: err = launch_variant<uint8_t>(p, a, variant, size, shift,
                                          clusters); break;
    case 1: err = launch_variant<int16_t>(p, a, variant, size, shift,
                                          clusters); break;
    case 2: err = launch_variant<int32_t>(p, a, variant, size, shift,
                                          clusters); break;
    default: err = launch_variant<int64_t>(p, a, variant, size, shift,
                                           clusters); break;
  }
  if (current != a.device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}
"""


def cluster_geometry(nbins: int, n: int = 0) -> Tuple[int, int, int, int]:
    """The cluster variant's layout of nbins bins: (cluster size, log2 of
    the bins a block owns, a block's shared-memory bytes, clusters for n
    elements).  Block k of a cluster owns the bins [k << s, (k + 1) << s);
    the slices are the least power of two (at least 32 bins) that
    CLUSTER_MAX blocks need, and the cluster has as many blocks as hold
    nbins.  Each cluster zeroes and flushes every bin, so there is one
    cluster for every CLUSTER_MIN_PER_BIN * nbins elements, at least one;
    the kernel takes no more than the card holds at once."""
    per = -(-nbins // CLUSTER_MAX)
    shift = max(5, (per - 1).bit_length())
    size = -(-nbins >> shift)
    return size, shift, 4 << shift, max(1, int(n // (CLUSTER_MIN_PER_BIN
                                                     * nbins)))


def holds(variant: str, nbins: int) -> bool:
    """Whether a launch of `variant` can hold nbins bins."""
    if variant == "narrow":
        return nbins * 4 * NARROW_COPIES <= _SMEM_BUDGET
    if variant == "cluster":
        return cluster_geometry(nbins)[2] <= _SMEM_BUDGET
    raise ValueError(f"no K5 variant {variant!r}")


def variant_plan(variant: str, nbins: int, n: int, hi_kind: int,
                 vals_addr: int, esize: int,
                 mask_addr: Optional[int] = None, ctx_addr: int = 0,
                 t0: int = 0, cols: int = 0, ld: int = 0
                 ) -> Tuple[int, int, int, int, int]:
    """A variant's launch arguments: (vec_head, cluster size, log2 of a
    block's bins, clusters, quads); the reads are the shared route's
    (hist_kernels.read_plan), the cluster's three 0 for the narrow
    variant.  Raises when the variant cannot hold the bins."""
    from dsrc_tpu_torch.ops import hist_kernels as HK
    if not holds(variant, nbins):
        raise ValueError(f"K5 variant {variant} cannot hold {nbins} bins")
    head, quads = HK.read_plan(n, hi_kind, vals_addr, esize, mask_addr,
                               ctx_addr, t0, cols, ld)
    if variant == "narrow":
        return head, 0, 0, 0, quads
    size, shift, _, clusters = cluster_geometry(nbins, n)
    return head, size, shift, clusters, quads


def build(out_dir: str) -> subprocess.Popen:
    """Start nvcc on the variants' source (the port's flags) into
    out_dir/libk5_variants.so; returns the process."""
    from dsrc_tpu_torch.ops import cuda_build
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "k5_variants.cu")
    with open(cu, "w") as f:
        f.write(_SOURCE % {"hist": os.path.join(cuda_build.CSRC, "hist.cu")})
    return subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
         os.path.join(out_dir, "libk5_variants.so"), cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def variant_launch(lib: str, launch):
    """A stand-in for hist_kernels._launch that launches the variant that
    hist_kernels._ROUTE names from `lib`, and passes every other call on
    to `launch`.  Counts nothing in LAUNCHES."""
    import torch
    from dsrc_tpu_torch.ops import hist_kernels as HK
    fn = ctypes.CDLL(lib).dsrc_hist_variant
    fn.argtypes = (ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int)
    fn.restype = ctypes.c_int

    def run(name, hist, vals, ld, t0, rows, cols, hi_kind, nsym, nctx,
            nbins, ctx=None, mask=None, lengths=None):
        variant = HK._ROUTE
        if variant not in VARIANTS:
            return launch(name, hist, vals, ld, t0, rows, cols, hi_kind,
                          nsym, nctx, nbins, ctx=ctx, mask=mask,
                          lengths=lengths)
        if rows * cols == 0:
            return None
        idx = hist.get_device()
        vals_addr = vals.data_ptr()
        mask_addr = None if mask is None else mask.data_ptr()
        ctx_addr = 0 if ctx is None else ctx.data_ptr()
        head, size, shift, clusters, quads = variant_plan(
            variant, nbins, rows * cols, hi_kind, vals_addr,
            vals.element_size(), mask_addr, ctx_addr, t0, cols, ld)
        rc = fn(HK._ARGS.pack(
            vals_addr, ctx_addr, mask_addr or 0,
            0 if lengths is None else lengths.data_ptr(), hist.data_ptr(),
            torch.cuda.current_stream(idx).cuda_stream, ld,
            HK._VTYPE[vals.dtype][0], t0, rows, cols, hi_kind, nsym, nctx,
            nbins, 0, idx, head, quads),
            VARIANTS.index(variant), size, shift, clusters)
        if rc != 0:
            raise AssertionError(f"{name} on the {variant} variant: CUDA "
                                 f"error {rc}")
        return None
    return run


def variants_of(nbins: int) -> list:
    """The committed routes and the variants that can hold nbins bins."""
    import chip_smoke as CS
    return CS.k5_routes(nbins) + [v for v in VARIANTS if holds(v, nbins)]


def compare(reps: int) -> None:
    """The first form (module docstring)."""
    import torch
    import chip_smoke as CS
    from dsrc_tpu_torch.io.chunker import FastqChunker
    from dsrc_tpu_torch.ops import cuda_build
    from dsrc_tpu_torch.ops import hist_kernels as HK
    device = torch.device("cuda", 0)
    out_dir = os.path.join(ROOT, "build", "k5_variants")
    proc = build(out_dir)
    cuda_build.load_all()
    log = proc.communicate()[0].decode(errors="replace")
    if proc.returncode != 0:
        raise AssertionError(f"the K5 variants do not build:\n{log}")
    CS.emit({"phase": "build", "ptxas": cuda_build.ptxas_usage(log)})
    big = CS.realistic_of_size(128 * CS.MB - 4096, seed=81)
    block64 = FastqChunker(io.BytesIO(big), 64 * CS.MB).next_block() \
        .tobytes()
    del big
    calls = CS.hist_capture(device, "hist_m1_64MB", block64,
                            CS.m1_params(64 * CS.MB))
    launch = HK._launch
    HK._launch = variant_launch(os.path.join(out_dir, "libk5_variants.so"),
                                launch)
    try:
        CS.hist_checks(device, "m1_64MB", calls, reps, routes=variants_of)
        del calls
        torch.cuda.empty_cache()
        CS.hist_route_sweep(device, reps, SWEEP,
                            (("cluster", "global"), ("narrow", "shared")))
    finally:
        HK._launch = launch


def host_repeat(times: int) -> None:
    """The second form (module docstring), on the chip_smoke and
    dsrc_tpu_torch first on sys.path."""
    import torch
    import chip_smoke as CS
    from dsrc_tpu_torch.io.chunker import FastqChunker
    from dsrc_tpu_torch.ops import cuda_build
    cuda_build.load_all()
    device = torch.device("cuda", 0)
    blocks = (
        ("semi_8MB", CS.fastq_of_size(16 * CS.MB, seed=7,
                                      fixed_width=False)),
        ("semi_mode0_8MB", CS.umi_fastq_of_size(16 * CS.MB, seed=93)))
    for name, data in blocks:
        block = FastqChunker(io.BytesIO(data), 8 * CS.MB).next_block() \
            .tobytes()
        for i, c in enumerate(CS.hist_capture(device, f"hist_{name}", block,
                                              None)):
            hist = torch.zeros(c["nbins"] + 1, dtype=torch.int64,
                               device=device)
            k5 = CS._hist_fn(c, hist, False)
            ms = [CS.time_ms(k5, 10) for _ in range(times)]
            CS.emit({"stream": f"{name}_hist", "call": i, "form": c["form"],
                     "bins": c["nbins"], "elements": c["rows"] * c["cols"],
                     "route": c["route"], "ms_median": statistics.median(ms),
                     "ms_min": min(ms), "ms_max": max(ms), "ms": ms})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--host-repeat", type=int, default=0,
                    help="the second form: repeat each timing this often")
    ap.add_argument("--tree", default=ROOT,
                    help="the checkout whose chip_smoke.py and "
                         "dsrc_tpu_torch the second form runs")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        print("k5_variants: needs an NVIDIA card", file=sys.stderr)
        return 2
    CS = importlib.import_module("chip_smoke")
    if args.host_repeat:
        print(json.dumps({"tree": os.path.abspath(args.tree)}), flush=True)
        host_repeat(args.host_repeat)
    else:
        compare(args.reps)
    print(CS.card_info(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
