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
// this card the cost is contention on the atomics, which each route keeps
// off device memory in its own way (the wrapper's hist_route picks one):
// - Shared (nbins * 4 bytes within the 227 KB budget): each block zeroes
//   a private u32 copy, counts with shared-memory atomics, then adds its
//   non-zero bins with one global atomic each.  The grid gives each block
//   at least nbins elements, so zeroing and flushing stay a fraction of
//   the count.
// - Global (wider: the quality contexts' 2^18, order-k DNA up to 2^24;
//   sparse calls): 64-bit global
//   atomics, one for the lanes of a warp that hold one bin, an element a
//   thread on as many SMs as the call fills.
// - In every route an element that is masked off or out of range issues no
//   atomic at all (the plain version sends those to a dump slot, where all
//   their atomics would land on one address).
// Reading: a flat call (one row) whose values and mask are 16-byte
// aligned at some element (the wrapper gives its index, vec_head) is read
// in chunks of 16 elements by 16-byte vector loads, with the elements
// before the first chunk and after the last counted by the grid's first
// warp; a context band whose first column, width and row stride are
// multiples of 4 (the decode's bands: edges 16, 32, 64, ...) is read 4
// steps of a lane at a time (quads); every other call steps each
// thread's (r, c) by the grid stride's quotient and remainder, with no
// division in the loop.  The global route reads element by element: its
// rate is each SM's rate of scattered atomics, so it spreads a call over
// as many threads as it can.  Every lane of a warp runs the same
// iterations (the warp's first element or chunk decides), so
// __match_any_sync is over the full warp.
//
// Launch cost: the SM count, the shared-memory opt-in and the shared
// route's occupancy (blocks an SM) are asked once per device, kernel and
// shared-memory size and kept; the device is set only when it is not
// current, and set back after the launch.
// Alternatives measured against these routes and not taken (a u32 copy of
// the bins for each warp; one copy spread over a thread-block cluster's
// distributed shared memory) are built and timed by k5_variants.py.
#include <cstddef>
#include <cstdint>
#include <mutex>
#include <vector>

#include <cuda_runtime.h>

// Packed launch arguments, one struct from the wrapper (its
// struct.Struct("<6Qq12i")): pointers (null as 0), the row stride, then
// 12 ints.  Outside the unnamed namespace, so that dsrc_hist, which takes
// it, keeps external linkage.
struct HistArgs {
  const void* vals;
  const void* ctx;
  const void* mask;
  const void* lengths;
  void* hist;
  void* stream;
  long long ld;
  int vtype, t0, rows, cols, hi_kind, nsym, nctx, nbins, route, device;
  int vec_head, quads;
};
static_assert(sizeof(HistArgs) == 6 * 8 + 8 + 12 * 4, "HistArgs layout");

namespace {

constexpr int kThreads = 512;
constexpr int kMinPerThread = 8;       // elements a thread before a block
constexpr int kVec = 16;               // elements a vector chunk
constexpr int kLanes = 32;
constexpr int kSmemBudget = 227 * 1024;
constexpr unsigned kNoBin = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;

enum HiKind { kFlat = 0, kColumn = 1, kContext = 2 };
enum Route { kShared = 0, kGlobal = 1 };

struct Params {
  const void* vals;        // element type V
  const int32_t* ctx;      // kContext: same layout as vals
  const uint8_t* mask;     // bool, same layout as vals; may be null
  const int32_t* lengths;  // [rows]; may be null
  long long ld;            // row stride of vals, ctx and mask (elements)
  int t0, rows, cols;
  int hi_kind, nsym, nctx, nbins;
  int vec_head;            // flat form: first element of the first chunk
                           // (-1: no vector reads)
  int quads;               // context form: 4 steps a 16-byte load (1)
};

// 0 <= v < a, in one unsigned compare
template <typename V>
__device__ __forceinline__ bool in_range(V v, int a) {
  if constexpr (sizeof(V) == 8) {
    return static_cast<unsigned long long>(v) <
           static_cast<unsigned long long>(a);
  } else {
    return static_cast<unsigned>(static_cast<int>(v)) <
           static_cast<unsigned>(a);
  }
}

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
  const V v = vals[o];
  const int a = p.hi_kind == kFlat ? p.nbins : p.nsym;
  if (!in_range(v, a)) return kNoBin;
  unsigned hi = 0;
  if (p.hi_kind == kColumn) {
    hi = c;
  } else if (p.hi_kind == kContext) {
    hi = static_cast<unsigned>(min(max(__ldg(p.ctx + o), 0), p.nctx - 1));
  }
  return hi * static_cast<unsigned>(a) + static_cast<unsigned>(v);
}

template <typename V>
__device__ __forceinline__ unsigned flat_bin(V v, bool keep, int nbins) {
  return keep && in_range(v, nbins) ? static_cast<unsigned>(v) : kNoBin;
}

__device__ __forceinline__ unsigned context_bin(const Params& p, int sym,
                                                int ctx, bool keep) {
  if (!keep || !in_range(sym, p.nsym)) return kNoBin;
  return static_cast<unsigned>(min(max(ctx, 0), p.nctx - 1)) *
             static_cast<unsigned>(p.nsym) +
         static_cast<unsigned>(sym);
}

// 16 elements read as 16-byte words
template <typename V>
union Chunk {
  uint4 w[kVec * sizeof(V) / 16];
  V v[kVec];
};
union MaskChunk {
  uint4 w;
  uint8_t b[kVec];
};

// Calls count(bin) for every element of the grid-stride share of the
// thread `first` (kNoBin for the ones not counted), the same number of
// times on every lane of a warp.
template <typename V, class Count>
__device__ __forceinline__ void count_elements(const Params& p, Count& count,
                                               unsigned first,
                                               unsigned stride) {
  const unsigned lane = threadIdx.x & (kLanes - 1);
  if (p.vec_head >= 0) {
    // flat, one row: [0, head) and [tail0, n) one element a lane of the
    // grid's first warp, the chunks between by vector loads
    const V* __restrict__ vals = static_cast<const V*>(p.vals) + p.t0;
    const uint8_t* __restrict__ mask =
        p.mask == nullptr ? nullptr : p.mask + p.t0;
    const unsigned n = static_cast<unsigned>(p.cols);
    const unsigned head = static_cast<unsigned>(p.vec_head);
    const unsigned nchunks = (n - head) / kVec;
    const unsigned tail0 = head + nchunks * kVec;
    if (first < kLanes) {
      const unsigned i = lane < kVec ? lane : tail0 + lane - kVec;
      const bool live = lane < kVec ? i < head : i < n;
      count(live ? flat_bin(vals[i], mask == nullptr || mask[i] != 0,
                            p.nbins)
                 : kNoBin);
    }
    for (unsigned base = first - lane; base < nchunks; base += stride) {
      const unsigned k = base + lane;
      const bool live = k < nchunks;
      Chunk<V> v;
      MaskChunk m;
      m.w = make_uint4(kFull, kFull, kFull, kFull);
      if (live) {
        const uint4* q =
            reinterpret_cast<const uint4*>(vals + head + k * kVec);
#pragma unroll
        for (int w = 0; w < static_cast<int>(kVec * sizeof(V) / 16); ++w)
          v.w[w] = __ldg(q + w);
        if (mask != nullptr)
          m.w = __ldg(
              reinterpret_cast<const uint4*>(mask + head + k * kVec));
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        count(live ? flat_bin(v.v[j], m.b[j] != 0, p.nbins) : kNoBin);
    }
    return;
  }
  if (p.quads) {
    // context form, int32 symbols and contexts: the steps [t, t + 4) of a
    // lane by one 16-byte load of each (t0, cols and ld multiples of 4)
    const int32_t* __restrict__ sym = static_cast<const int32_t*>(p.vals);
    const unsigned quads = static_cast<unsigned>(p.cols) / 4;
    const unsigned n = static_cast<unsigned>(p.rows) * quads;
    const unsigned dr = stride / quads, dq = stride % quads;
    unsigned r = first / quads, q = first % quads;
    for (unsigned base = first - lane; base < n; base += stride) {
      const bool live = base + lane < n;
      int4 s = make_int4(0, 0, 0, 0), c = s;
      int left = 0;                       // steps of the lane from t on
      if (live) {
        const long long o =
            static_cast<long long>(r) * p.ld + p.t0 + 4 * q;
        s = __ldg(reinterpret_cast<const int4*>(sym + o));
        c = __ldg(reinterpret_cast<const int4*>(p.ctx + o));
        left = __ldg(p.lengths + r) - (p.t0 + 4 * static_cast<int>(q));
      }
      count(context_bin(p, s.x, c.x, left > 0));
      count(context_bin(p, s.y, c.y, left > 1));
      count(context_bin(p, s.z, c.z, left > 2));
      count(context_bin(p, s.w, c.w, left > 3));
      q += dq;
      r += dr;
      if (q >= quads) {
        q -= quads;
        ++r;
      }
    }
    return;
  }
  const V* __restrict__ vals = static_cast<const V*>(p.vals);
  const unsigned cols = static_cast<unsigned>(p.cols);
  const unsigned n = static_cast<unsigned>(p.rows) * cols;
  const unsigned dr = stride / cols, dc = stride % cols;
  unsigned r = first / cols, c = first % cols;
  for (unsigned base = first - lane; base < n; base += stride) {
    count(base + lane < n ? element_bin<V>(p, vals, r, c) : kNoBin);
    c += dc;
    r += dr;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

struct SharedCount {  // the block's private copy
  unsigned* counts;
  __device__ __forceinline__ void operator()(unsigned bin) const {
    if (bin != kNoBin) atomicAdd(counts + bin, 1u);
  }
};

struct GlobalCount {  // one 64-bit atomic for the lanes of a warp on a bin
  unsigned long long* hist;
  unsigned lane;
  __device__ __forceinline__ void operator()(unsigned bin) const {
    const unsigned peers = __match_any_sync(kFull, bin);
    if (bin != kNoBin && lane == static_cast<unsigned>(__ffs(peers) - 1))
      atomicAdd(hist + bin, static_cast<unsigned long long>(__popc(peers)));
  }
};

template <typename V>
__global__ void __launch_bounds__(kThreads)
    shared_kernel(Params p, unsigned long long* __restrict__ hist) {
  extern __shared__ unsigned counts[];
  for (int b = threadIdx.x; b < p.nbins; b += kThreads) counts[b] = 0;
  __syncthreads();
  SharedCount count{counts};
  count_elements<V>(p, count, blockIdx.x * kThreads + threadIdx.x,
                    gridDim.x * kThreads);
  __syncthreads();
  for (int b = threadIdx.x; b < p.nbins; b += kThreads) {
    const unsigned v = counts[b];
    if (v != 0) atomicAdd(hist + b, static_cast<unsigned long long>(v));
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
    global_kernel(Params p, unsigned long long* __restrict__ hist) {
  GlobalCount count{hist, threadIdx.x & (kLanes - 1)};
  count_elements<V>(p, count, blockIdx.x * kThreads + threadIdx.x,
                    gridDim.x * kThreads);
}

// ---------------------------------------------------------------------------
// Host side: what a launch asks of the device once, kept
// ---------------------------------------------------------------------------

struct Fact {
  int device;
  const void* fn;  // null: the SM count
  size_t smem;
  int kind;        // 0: blocks an SM; -1: the opt-in
  int value;
};

std::mutex g_mu;
std::vector<Fact> g_facts;

// The fact (device, fn, smem, kind), computed by `ask` at first use.
template <class Ask>
cudaError_t fact(int device, const void* fn, size_t smem, int kind, Ask ask,
                 int* value) {
  {
    std::lock_guard<std::mutex> g(g_mu);
    for (const Fact& f : g_facts)
      if (f.device == device && f.fn == fn && f.smem == smem &&
          f.kind == kind) {
        *value = f.value;
        return cudaSuccess;
      }
  }
  int v = 0;
  cudaError_t err = ask(&v);
  if (err != cudaSuccess) {
    cudaGetLastError();  // not to surface at a later launch's check
    return err;
  }
  std::lock_guard<std::mutex> g(g_mu);
  g_facts.push_back(Fact{device, fn, smem, kind, v});
  *value = v;
  return cudaSuccess;
}

cudaError_t sm_count(int device, int* sms) {
  return fact(device, nullptr, 0, 0, [&](int* v) {
    return cudaDeviceGetAttribute(v, cudaDevAttrMultiProcessorCount, device);
  }, sms);
}

// The kernel may use all of the budget: asked once per device and kernel.
cudaError_t opt_in(int device, const void* fn) {
  int unused = 0;
  return fact(device, fn, 0, -1, [&](int* v) {
    *v = 1;
    return cudaFuncSetAttribute(fn,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmemBudget);
  }, &unused);
}

cudaError_t blocks_per_sm(int device, const void* fn, int threads,
                          size_t smem, int* per_sm) {
  cudaError_t err = opt_in(device, fn);
  if (err != cudaSuccess) return err;
  err = fact(device, fn, smem, 0, [&](int* v) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(v, fn, threads,
                                                         smem);
  }, per_sm);
  if (err == cudaSuccess && *per_sm < 1) err = cudaErrorInvalidConfiguration;
  return err;
}

long long clamp_blocks(long long want, long long most) {
  want = want < most ? want : most;
  return want < 1 ? 1 : want;
}

template <typename V>
cudaError_t launch(const Params& p, const HistArgs& a) {
  int sms = 0;
  cudaError_t err = sm_count(a.device, &sms);
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(p.rows) * p.cols;
  auto* hist = static_cast<unsigned long long*>(a.hist);
  auto stream = static_cast<cudaStream_t>(a.stream);
  int per_sm = 0;
  switch (a.route) {
    case kShared: {
      const void* fn = reinterpret_cast<const void*>(shared_kernel<V>);
      const size_t smem = sizeof(unsigned) * static_cast<size_t>(p.nbins);
      err = blocks_per_sm(a.device, fn, kThreads, smem, &per_sm);
      if (err != cudaSuccess) return err;
      // each block zeroes and flushes every bin: give it nbins elements
      long long want = (n + kThreads * kMinPerThread - 1) /
                       (kThreads * kMinPerThread);
      want = want < n / p.nbins ? want : n / p.nbins;
      const long long blocks =
          clamp_blocks(want, static_cast<long long>(sms) * per_sm);
      shared_kernel<V><<<static_cast<unsigned>(blocks), kThreads, smem,
                         stream>>>(p, hist);
      break;
    }
    case kGlobal: {
      // an element a thread until the card is full: the route is bound by
      // each SM's rate of issue of scattered atomics, so a small call
      // spreads over as many SMs as it can
      const long long blocks = clamp_blocks(
          (n + kThreads - 1) / kThreads,
          static_cast<long long>(sms) * (2048 / kThreads));
      global_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(p, hist);
      break;
    }
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

const int kValueBytes[4] = {1, 2, 4, 8};

bool valid(const HistArgs& a) {
  if (a.rows < 0 || a.cols < 1 || a.nbins < 1 || a.hi_kind < kFlat ||
      a.hi_kind > kContext || a.route < kShared || a.route > kGlobal ||
      a.vtype < 0 || a.vtype > 3 || a.vals == nullptr || a.hist == nullptr ||
      (a.hi_kind != kFlat && a.nsym < 1) ||
      (a.hi_kind == kContext && (a.nctx < 1 || a.ctx == nullptr)))
    return false;
  if (a.vec_head >= 0) {
    // a flat row whose chunks start 16-byte aligned at vec_head
    const long long e = static_cast<long long>(a.t0) + a.vec_head;
    if (a.hi_kind != kFlat || a.rows != 1 || a.vec_head >= kVec ||
        a.vec_head > a.cols ||
        !aligned16(static_cast<const char*>(a.vals) +
                   e * kValueBytes[a.vtype]) ||
        (a.mask != nullptr &&
         !aligned16(static_cast<const char*>(a.mask) + e)))
      return false;
  }
  if (a.quads &&
      (a.hi_kind != kContext || a.vtype != 2 || a.lengths == nullptr ||
       a.vec_head >= 0 || (a.t0 | a.cols) % 4 != 0 || a.ld % 4 != 0 ||
       !aligned16(a.vals) || !aligned16(a.ctx)))
    return false;
  return true;
}

}  // namespace

// Launches K5 on args->stream, adding into hist (int64 [nbins]).  vals: the
// row-major view's base (vtype 0 uint8, 1 int16, 2 int32, 3 int64), row
// stride ld, columns [t0, t0 + cols) of rows [0, rows); ctx: int32, the
// same layout (hi_kind 2; null otherwise); mask: bool, the same layout, or
// null; lengths: int32 [rows] or null.  hi_kind: 0 flat (A = nbins), 1
// positional (bin = c * nsym + v), 2 context (bin = clamp(ctx, 0,
// nctx - 1) * nsym + v).  route: 0 shared, 1 global.  vec_head >= 0: a
// flat row read by 16-element chunks from that element on (the value's
// and the mask's addresses are 16-byte aligned there); -1: element by
// element.  quads: a context band read 4 steps at a time (t0, cols, ld
// multiples of 4; sym and ctx 16-byte aligned).  The caller keeps
// rows * cols below 2^31 and the bins below 2^31.  Leaves the calling
// thread's current device as it was.  Returns the first CUDA error of
// the launch, or cudaGetLastError() after it.
extern "C" int dsrc_hist(const HistArgs* args) {
  const HistArgs& a = *args;
  if (!valid(a)) return static_cast<int>(cudaErrorInvalidValue);
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
    case 0: err = launch<uint8_t>(p, a); break;
    case 1: err = launch<int16_t>(p, a); break;
    case 2: err = launch<int32_t>(p, a); break;
    default: err = launch<int64_t>(p, a); break;
  }
  if (current != a.device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}
