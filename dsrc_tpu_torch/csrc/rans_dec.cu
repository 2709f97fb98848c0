// K2: positional rANS decode, hand-written for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel _dec_kernel (dsrc_tpu/ops/rans_pallas.py:250,
// entry decode_positional_tpu), which computes the same function as the XLA
// wavefront dsrc_tpu/parallel/uniform_pipeline.py:decode_positional.  Its
// plain PyTorch version is dsrc_tpu_torch/ops/rans_kernels.py:rans_decode_plain.
//
// Function: lane l codes records l*G .. l*G+G-1, P positions each; step
// t = g*P + p decodes record l*G+g at position p with model row p of the
// transmitted table.  slot = x & (2^14-1); the symbol s is the largest one
// in [0, nsym) whose cum[p][s] <= slot; x = f*(x >> 14) + slot - cum, and
// one u16 word is shifted in when x < 2^16.  Steps of records >= num_rec
// leave the state alone (their symbol is still written, as the reference
// does).  Output: out [L*G, P] int32, lane l's T = G*P symbols contiguous.
//
// What bounds it on this card: each lane is a chain of T dependent steps
// (T = 800 for the quality stream of an 8 MB block), and the wire format
// gives one u32 state per lane, so a lane cannot be split.  Neither bytes
// nor operations bound it.  The chain holds no device-memory load: a step
// is two rounds of shared-memory reads (the row entries, then cum[s] and
// cum[s+1]), a warp vote or reduction, and integer work.  At the quality
// and title shapes (32 to 40 warps on an SM) the per-step chain of every
// warp is hidden and the SM's instruction issue and shared-memory pipe set
// the time per step; at the value-plane shape (532 lanes, 8 warps on each
// of 67 SMs) one chain's latency does.
//
// Design:
// - One warp per lane, kWarps lanes per block.  The state x, the word
//   pointer and the symbol are uniform across the warp; every thread
//   computes them.  An 8 MB block's 4,256 quality lanes are 4,256 warps
//   (about 32 per SM), not 133 one-warp blocks.
// - The cum table lives in shared memory, one row per position, padded to
//   `stride` ints: row[i] = cum[i] for i <= nsym, INT_MAX past it.  A table
//   larger than the wrapper's budget is walked in tiles of `tile_rows`
//   positions: every lane runs exactly T steps and step t uses row t % P, so
//   the warps of a block walk the tiles together, with a block barrier
//   before and after each tile is loaded.  Warps of lanes past `lanes` load
//   and reach every barrier but decode nothing.
// - The symbol is found in one round: thread k compares row entries
//   1 + k + 32*j (j < kE) with slot and the warp counts those <= slot, by
//   __ballot_sync + __popc for kE <= 2 (one or two votes) and by one
//   __reduce_add_sync of each thread's own count for larger alphabets (8
//   votes and popcounts a step cost more than one reduction there);
//   s = min(count, nsym - 1).  Then cum[s] and cum[s+1] are two broadcast
//   reads of the shared row.  ASSUMPTION: every row is non-decreasing.  On
//   such a row the count equals the binary search of the plain version
//   ("largest s in [0, nsym) with cum[s] <= slot"), zero-frequency ties and
//   all-zero rows included (both give the last symbol of a run, nsym - 1
//   for a zero row); the min covers cum[nsym] <= slot, when every entry
//   counts.  Every caller passes cum_from_freqs of a table of
//   non-negative fields: decode_positional (parallel/uniform_pipeline.py),
//   whose tables are unpacked 14-bit fields (models/block.py), the tests and
//   chip_smoke.py.  On any row s stays in [0, nsym).
// - Payload words come from a window of the lane's next 64 u16 words held in
//   the warp's registers (thread k holds i32 pair k of the window, one
//   coalesced 128-byte load).  The word at the pointer is taken by
//   __shfl_sync.  The next window is loaded as soon as the current one is
//   entered, so it arrives at least 64 consumed words ahead of its first
//   use.  The start word may be odd, negative or past the row; a word
//   outside [0, 2 * pairs) reads as 0.
// - No step's state update waits on a global-memory load issued in that
//   step: cum rows come from shared memory, payload words from the window.
//   The only global accesses in the loop are the next window's load and the
//   output store.
// - Output: thread k keeps the symbol of step t when t % 32 == k, and every
//   32 steps the warp writes one 128-byte run of its lane's output; the
//   tail of T % 32 symbols is written at the end.  The steps run in chunks
//   that end at a run boundary or a tile's end, so a step spends one
//   compare and select on this, not a counter test and branch.
// - Corrupt streams stay bounded: the loop runs exactly T steps, s stays in
//   [0, nsym), and nothing reads outside its buffers.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kProbBits = 14;
constexpr uint32_t kMask = (1u << kProbBits) - 1;
constexpr uint32_t kRansL = 1u << 16;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWindow = 64;               // u16 words per payload window
// __byte_perm selectors: (x << 16) | low or high half of a payload pair
constexpr uint32_t kLowHalf = 0x5410u;
constexpr uint32_t kHighHalf = 0x5432u;

// Rows p0 .. p0+n-1 of cum [P, nsym+1] into tab [n, stride], padded.
__device__ void load_rows(int32_t* tab, const int32_t* __restrict__ cum,
                          int p0, int n, int nsym, int stride) {
  const int total = n * stride;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int r = idx / stride;
    const int i = idx - r * stride;
    tab[idx] = i <= nsym
                   ? __ldg(cum + static_cast<size_t>(p0 + r) * (nsym + 1) + i)
                   : INT_MAX;
  }
}

// kE: row entries each thread compares per step (0 when nsym == 1); -1
// takes the count from `ne` at run time (alphabets above 513).
template <int kE>
__global__ void __launch_bounds__(kThreads)
rans_decode_kernel(const int32_t* __restrict__ payload, int pairs,
                   const uint32_t* __restrict__ states,
                   const int32_t* __restrict__ wptr0,
                   const int32_t* __restrict__ cum, int p, int nsym, int ne,
                   int stride, int tile_rows, int group, int lanes,
                   int num_rec, int32_t* __restrict__ out) {
  extern __shared__ int32_t tab[];
  const int n_e = kE >= 0 ? kE : ne;
  const int k = threadIdx.x & 31;
  const int lane = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool live = lane < lanes;
  const int32_t* prow = payload + static_cast<size_t>(live ? lane : 0) * pairs;
  const size_t t_steps = static_cast<size_t>(group) * p;
  int32_t* orow = out + static_cast<size_t>(live ? lane : 0) * t_steps;

  // the lane's state and payload window (pair index pbase, word offset o)
  uint32_t x = 0;
  long long pbase = 0;
  int o = 0;
  int32_t cur = 0, nxt = 0;
  auto load_pair = [&](long long q) -> int32_t {
    return (q >= 0 && q < pairs) ? __ldg(prow + q) : 0;
  };
  if (live) {
    x = states[lane];
    const int w0 = wptr0[lane];
    pbase = w0 >> 1;                        // floor, also for w0 < 0
    o = w0 & 1;
    cur = load_pair(pbase + k);
    nxt = load_pair(pbase + kWindow / 2 + k);
  }
  int32_t wpair = __shfl_sync(kFull, cur, o >> 1);
  uint32_t wsel = (o & 1) ? kHighHalf : kLowHalf;

  int32_t keep = 0;
  int tt = 0;                               // step within the 32-step run
  size_t t0 = 0;                            // first step of the run
  const bool tiled = tile_rows < p;
  if (!tiled) {
    load_rows(tab, cum, 0, p, nsym, stride);
    __syncthreads();
  }
  for (int g = 0; g < group; ++g) {
    const bool act =
        static_cast<long long>(lane) * group + g < static_cast<long long>(num_rec);
    for (int p0 = 0; p0 < p; p0 += tile_rows) {
      const int n = min(tile_rows, p - p0);
      if (tiled) {
        __syncthreads();
        load_rows(tab, cum, p0, n, nsym, stride);
        __syncthreads();
      }
      if (!live) continue;
      const int32_t* row = tab;
      for (int i = 0; i < n;) {
        // steps i .. i+m-1 end at the next 32-step run boundary or the
        // tile's end; thread k keeps the symbol of step j == kt
        const int m = min(n - i, 32 - tt);
        const int kt = k - tt;
#pragma unroll 1
        for (int j = 0; j < m; ++j, row += stride) {
          const int32_t slot = static_cast<int32_t>(x & kMask);
          int count = 0;
          if constexpr (kE >= 0 && kE <= 2) {
#pragma unroll
            for (int e = 0; e < kE; ++e)
              count += __popc(__ballot_sync(kFull, row[1 + k + 32 * e] <= slot));
          } else {
            int mine = 0;
#pragma unroll
            for (int e = 0; e < n_e; ++e) mine += row[1 + k + 32 * e] <= slot;
            count = __reduce_add_sync(kFull, mine);
          }
          const int s = min(count, nsym - 1);
          if (j == kt) keep = s;
          if (act) {
            const uint32_t c = static_cast<uint32_t>(row[s]);
            const uint32_t f = static_cast<uint32_t>(row[s + 1]) - c;
            x = f * (x >> kProbBits) + static_cast<uint32_t>(slot) - c;
            if (x < kRansL) {
              x = __byte_perm(static_cast<uint32_t>(wpair), x, wsel);
              if (++o == kWindow) {
                cur = nxt;
                pbase += kWindow / 2;
                nxt = load_pair(pbase + kWindow / 2 + k);
                o = 0;
              }
              wpair = __shfl_sync(kFull, cur, o >> 1);
              wsel = (o & 1) ? kHighHalf : kLowHalf;
            }
          }
        }
        i += m;
        tt += m;
        if (tt == 32) {
          orow[t0 + k] = keep;
          t0 += 32;
          tt = 0;
        }
      }
    }
  }
  if (live && k < tt) orow[t0 + k] = keep;
}

template <int kE>
cudaError_t launch(int blocks, size_t smem, cudaStream_t stream,
                   const int32_t* payload, int pairs, const uint32_t* states,
                   const int32_t* wptr, const int32_t* cum, int p, int nsym,
                   int ne, int stride, int tile_rows, int group, int lanes,
                   int num_rec, int32_t* out) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rans_decode_kernel<kE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  rans_decode_kernel<kE><<<blocks, kThreads, smem, stream>>>(
      payload, pairs, states, wptr, cum, p, nsym, ne, stride, tile_rows, group,
      lanes, num_rec, out);
  return cudaGetLastError();
}

}  // namespace

// Launches K2 on `stream`.  payload: int32 [L, pairs], pairs of u16 words
// (low half first); states uint32 [L]; wptr int32 [L] start word per lane;
// cum int32 [P, nsym+1]; out int32 [L*group, P].  ne, stride, tile_rows:
// the shared-memory layout (rans_kernels.dec_layout): entries per thread
// (0, 1, 2, 4, 8, 16, or more for alphabets above 513), padded row length,
// positions per tile.  Returns cudaGetLastError() after the launch.
extern "C" int dsrc_rans_decode(const void* payload, int pairs,
                                const void* states, const void* wptr,
                                const void* cum, int p, int nsym, int ne,
                                int stride, int tile_rows, int group,
                                int lanes, int num_rec, void* out, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (lanes + kWarps - 1) / kWarps;
  const size_t smem =
      static_cast<size_t>(tile_rows < p ? tile_rows : p) * stride * 4;
  const auto* pl = static_cast<const int32_t*>(payload);
  const auto* st = static_cast<const uint32_t*>(states);
  const auto* wp = static_cast<const int32_t*>(wptr);
  const auto* cm = static_cast<const int32_t*>(cum);
  auto* o = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
#define DSRC_LAUNCH(E)                                                      \
  launch<E>(blocks, smem, s, pl, pairs, st, wp, cm, p, nsym, ne, stride,    \
            tile_rows, group, lanes, num_rec, o)
  switch (ne) {
    case 0: err = DSRC_LAUNCH(0); break;
    case 1: err = DSRC_LAUNCH(1); break;
    case 2: err = DSRC_LAUNCH(2); break;
    case 4: err = DSRC_LAUNCH(4); break;
    case 8: err = DSRC_LAUNCH(8); break;
    case 16: err = DSRC_LAUNCH(16); break;
    default: err = DSRC_LAUNCH(-1); break;
  }
#undef DSRC_LAUNCH
  return static_cast<int>(err);
}
