// K5: masked integer histogram, hand-written for Hopper (sm_90a).
//
// Replaces: the JAX package's two histograms for the TPU's matrix unit,
// neither of them a Pallas kernel:
//   dsrc_tpu/ops/ctx.py:_hist_mxu (:134, through hist_update :124), the
//     int8 one-hot outer product hist2d[h, l] = sum_i oh_hi[i, h] *
//     oh_lo[i, l] that counts a band's (ctx, sym) pairs in the
//     context-model codec, and
//   dsrc_tpu/parallel/uniform_pipeline.py:_pos_hist (:183), the
//     nibble-split batched int8 matmul that counts the per-position [P, A]
//     histograms of the UNIFORM and SEMI positional streams.
// Plain PyTorch versions: dsrc_tpu_torch/ops/hist_kernels.py (*_plain).
//
// Function: over the elements (r, c), r < rows, c < cols, of a row-major
// view with row stride ld and first column t0, at offset
// o = r * ld + t0 + c,
//   hist[hi * A + v] += 1   for v = vals[o], when 0 <= v < A,
//                           mask[o] != 0 (when a mask is given) and
//                           t0 + c < lengths[r] (when lengths are given),
// where hi = 0 and A = nbins (flat form), hi = c (positional form), or
// hi = clamp(ctx[o], 0, nctx - 1) (context form).  Counts are exact
// integers, so the result does not depend on the order of the atomics.
//
// What bounds it on this card: bytes.  Each element is read once (1 to 8
// bytes of value, 1 of mask or 4 of context) and costs a few integer
// operations and one atomic; the 64-bit histogram is read and written
// once.  The TPU counted by matmul because a scatter serializes there; on
// this card the cost is contention on the atomics, which the design
// keeps off device memory:
// - Shared route (nbins * 4 bytes within the dynamic shared-memory budget
//   the wrapper gives, 227 KB, and enough elements a bin: the wrapper's
//   hist_route decides): each block zeroes a private u32 copy of the
//   histogram, grid-strides over its elements with shared-memory atomics,
//   then adds its non-zero bins into the 64-bit histogram with one global
//   atomic each.  The grid gives each block at least nbins elements, so
//   the zeroing and the flush stay a fraction of the count.
// - Global route (beyond the budget: quality contexts up to 2^18 bins,
//   order-k DNA up to 2^24): 64-bit global atomics, aggregated per warp:
//   the lanes of a warp that hold one bin (__match_any_sync) issue one
//   atomic of their count.  Quality contexts and DNA symbols are skewed,
//   so many lanes of a warp hit one bin.
// - In both routes an element that is masked off or out of range issues no
//   atomic at all (the plain version sends those to a dump slot, where all
//   their atomics would land on one address).
// - Every lane of a warp runs the same iterations of the grid-stride loop
//   (the warp's first element decides), so the match is over the full
//   warp.  A thread steps its (r, c) by the stride's quotient and
//   remainder, with no division in the loop.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMinPerThread = 8;      // elements a thread before a new block
constexpr unsigned kNoBin = 0xFFFFFFFFu;

enum HiKind { kFlat = 0, kColumn = 1, kContext = 2 };

struct Params {
  const void* vals;        // element type V
  const int32_t* ctx;      // kContext: same layout as vals
  const uint8_t* mask;     // bool, same layout as vals; may be null
  const int32_t* lengths;  // [rows]; may be null
  long long ld;            // row stride of vals, ctx and mask (elements)
  int t0, rows, cols;
  int hi_kind, nsym, nctx, nbins;
};

// The bin of element (r, c), or kNoBin when it is not counted.
template <typename V>
__device__ __forceinline__ unsigned element_bin(const Params& p,
                                                const V* __restrict__ vals,
                                                unsigned r, unsigned c) {
  const long long o = static_cast<long long>(r) * p.ld + p.t0 + c;
  if (p.mask != nullptr && __ldg(p.mask + o) == 0) return kNoBin;
  if (p.lengths != nullptr &&
      p.t0 + static_cast<int>(c) >= __ldg(p.lengths + r))
    return kNoBin;
  const long long v = static_cast<long long>(vals[o]);
  const int a = p.hi_kind == kFlat ? p.nbins : p.nsym;
  if (v < 0 || v >= a) return kNoBin;
  unsigned hi = 0;
  if (p.hi_kind == kColumn) {
    hi = c;
  } else if (p.hi_kind == kContext) {
    hi = static_cast<unsigned>(min(max(__ldg(p.ctx + o), 0), p.nctx - 1));
  }
  return hi * static_cast<unsigned>(a) + static_cast<unsigned>(v);
}

template <typename V, bool kShared>
__global__ void __launch_bounds__(kThreads)
    hist_kernel(Params p, unsigned long long* __restrict__ hist) {
  extern __shared__ unsigned counts[];
  if (kShared) {
    for (int b = threadIdx.x; b < p.nbins; b += kThreads) counts[b] = 0;
    __syncthreads();
  }
  const V* __restrict__ vals = static_cast<const V*>(p.vals);
  const unsigned cols = static_cast<unsigned>(p.cols);
  const unsigned n = static_cast<unsigned>(p.rows) * cols;
  const unsigned stride = gridDim.x * kThreads;
  const unsigned dr = stride / cols, dc = stride % cols;
  const unsigned lane = threadIdx.x & 31;
  const unsigned first = blockIdx.x * kThreads + threadIdx.x;
  unsigned r = first / cols, c = first % cols;
  for (unsigned base = first - lane; base < n; base += stride) {
    const unsigned bin =
        base + lane < n ? element_bin<V>(p, vals, r, c) : kNoBin;
    if (kShared) {
      if (bin != kNoBin) atomicAdd(counts + bin, 1u);
    } else {
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, bin);
      if (bin != kNoBin && lane == static_cast<unsigned>(__ffs(peers) - 1))
        atomicAdd(hist + bin, static_cast<unsigned long long>(__popc(peers)));
    }
    c += dc;
    r += dr;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
  if (kShared) {
    __syncthreads();
    for (int b = threadIdx.x; b < p.nbins; b += kThreads) {
      const unsigned v = counts[b];
      if (v != 0) atomicAdd(hist + b, static_cast<unsigned long long>(v));
    }
  }
}

template <typename V>
cudaError_t launch(const Params& p, bool shared, unsigned long long* hist,
                   int device, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(p.rows) * p.cols;
  long long blocks =
      (n + kThreads * kMinPerThread - 1) / (kThreads * kMinPerThread);
  int per_sm = 0;
  if (shared) {
    auto kernel = hist_kernel<V, true>;
    const size_t smem = sizeof(unsigned) * static_cast<size_t>(p.nbins);
    if (smem > 48 * 1024) {
      // a refused attribute is returned, and cleared so that it does not
      // surface at a later launch's cudaGetLastError()
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) {
        cudaGetLastError();
        return err;
      }
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    // each block zeroes and flushes every bin: give it nbins elements
    const long long by_bins = n / p.nbins;
    blocks = blocks < by_bins ? blocks : by_bins;
    blocks = blocks < 1 ? 1 : blocks;
    const long long resident = static_cast<long long>(sms) * per_sm;
    blocks = blocks < resident ? blocks : resident;
    kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(p,
                                                                       hist);
  } else {
    const long long resident =
        static_cast<long long>(sms) * (2048 / kThreads);
    blocks = blocks < resident ? blocks : resident;
    hist_kernel<V, false>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p, hist);
  }
  return cudaGetLastError();
}

}  // namespace

// Launches K5 on `stream`, adding into hist (int64 [nbins]).  vals: the
// row-major view's base (vtype 0 uint8, 1 int16, 2 int32, 3 int64), row
// stride ld, columns [t0, t0 + cols) of rows [0, rows); ctx: int32, the
// same layout (hi_kind 2; null otherwise); mask: bool, the same layout, or
// null; lengths: int32 [rows] or null.  hi_kind: 0 flat (A = nbins), 1
// positional (bin = c * nsym + v), 2 context (bin = clamp(ctx, 0,
// nctx - 1) * nsym + v).  route: 0 shared memory, 1 global atomics.  The
// caller keeps rows * cols below 2^31 and the bins below 2^31.  Returns
// the first CUDA error of the launch, or cudaGetLastError() after it.
extern "C" int dsrc_hist(const void* vals, int vtype, const void* ctx,
                         const void* mask, const void* lengths, long long ld,
                         int t0, int rows, int cols, int hi_kind, int nsym,
                         int nctx, int nbins, int route, void* hist,
                         int device, void* stream) {
  if (rows < 0 || cols < 1 || nbins < 1 || hi_kind < kFlat ||
      hi_kind > kContext || route < 0 || route > 1 ||
      (hi_kind != kFlat && nsym < 1) || (hi_kind == kContext && nctx < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return 0;
  const Params p{vals, static_cast<const int32_t*>(ctx),
                 static_cast<const uint8_t*>(mask),
                 static_cast<const int32_t*>(lengths), ld, t0, rows, cols,
                 hi_kind, nsym, nctx, nbins};
  auto* out = static_cast<unsigned long long*>(hist);
  auto s = static_cast<cudaStream_t>(stream);
  const bool shared = route == 0;
  switch (vtype) {
    case 0: err = launch<uint8_t>(p, shared, out, device, s); break;
    case 1: err = launch<int16_t>(p, shared, out, device, s); break;
    case 2: err = launch<int32_t>(p, shared, out, device, s); break;
    case 3: err = launch<int64_t>(p, shared, out, device, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
