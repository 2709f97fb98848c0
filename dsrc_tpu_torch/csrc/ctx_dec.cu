// K3: band-adaptive context-model rANS decode, hand-written for Hopper
// (sm_90a).
//
// Replaces: the XLA wavefront dsrc_tpu/ops/ctx.py:decode_ctx_lanes (a
// lax.scan; the TPU package has no Pallas kernel for it), reached through
// decode_orderk, decode_ctx_precomputed and models/quality.py:_decode_ctxq.
// Its plain PyTorch version is
// dsrc_tpu_torch/ops/ctx_kernels.py:ctx_decode_band_plain.
//
// Function: one launch decodes steps [t0, t1) (one band) of L lanes with one
// table cum [C, A+1] (the band's quantized model, built by torch between
// launches from the histogram of the earlier bands).  Per lane and step t:
//   ctx   mode 0 (order-k history):  ctx = carry
//         mode 1 (precomputed):      ctx = aux[lane, t]
//         mode 2 (quality coarse):   h = aux & 1 ? 0 : carry;
//                                    ctx = coarse(h) | (aux >> 1) << hb
//   ctx is clamped into [0, C) (the reference's take mode="clip");
//   slot = x & (2^14-1); s = the number of entries cum[ctx][1..A] that are
//   <= slot, at most A-1; when t < lengths[lane] (active):
//   x = f*(x >> 14) + slot - cum[s] with f = cum[s+1] - cum[s], one u16
//   word shifted in when x < 2^16 (a word past the payload reads 0), and
//   the carry updated: mode 0  carry = ((carry << sbits) | s) & cmask,
//                      mode 2  carry = ((h << sbits) | s) & cmask.
//   Inactive steps hold x, the word pointer and the carry.  Every step
//   writes its symbol and its (clamped) context id to osym/octx [L, T].
// coarse(h) packs, for each lag k with width w_k, the top w_k of the qbits
// bits of symbol k of h; a lag wider than qbits contributes 0 bits of value
// (the reference shifts right by a negative amount there and gets 0; a
// negative shift is undefined in C++, so the rule is spelled out).
// State carried across launches, read at the start and written back at
// the end: x (u32 bits), the u16 word pointer and the carry.
//
// What bounds it on this card: each lane is a chain of dependent steps (in
// modes 0 and 2 a step's table row depends on the symbol just decoded),
// and a stream has at most 2,048 lanes.  The bytes bound (symbols and ids
// out, payload in) is far below the chain's latency; with one warp a lane
// the SMs also run out of issue slots (about 4 warps a scheduler, each
// issuing every instruction of a step), so the design cuts both the chain
// and the instructions a lane spends on a step.
//
// Design:
// - kT threads a lane (8, 16 or 32: 32/kT lanes share a warp), kWarps
//   warps a block.  x, the word pointer, the carry and the symbol are
//   uniform across a lane's threads; shuffles take width kT and ballots
//   are masked to the lane's threads.
// - Rows of packed words: entry j of row r is cum[r][j] | cum[r][j+1] << 16
//   for j < A and 0xFFFFFFFF after, kT*kE entries a row (kE = 1, 2, 4, 8
//   a thread), so a row address is a shift and a row one coalesced vector
//   load (thread k: entries kE*k .. kE*k+kE-1).  The count of entries with
//   cum[j+1] <= slot is one ballot a group, comparing the packed word with
//   (slot+1) << 16.  ASSUMPTION: rows are non-decreasing and below 2^16,
//   as cum_from_freqs of a quantized table is (entries <= 2^14; the only
//   caller is ops/ctx.py:decode_ctx_lanes).
// - At one entry a thread, while the ballots count, each thread forms the
//   next x of its symbol (the rANS update and the word shift-in), so that
//   one shuffle from the holder of s returns the new x and a second
//   whether a word went in: the update is off the chain from s to the next
//   step.  At more entries, one shuffle from the holder of s returns
//   cum[s] | cum[s+1] << 16 and the lane updates x after it.
// - Where the rows live (the route, chosen by ops/ctx_kernels.ctx_route
//   from (C, A)): kShared packs the int32 table into each block's shared
//   memory in its staging loop; kGlobal reads rows that the wrapper packed
//   into device memory (rows_packed), where L2 holds them.
// - The step is branch-free: the word shift-in is a select and the
//   payload pair for the next word is fetched every step (one shuffle off
//   the chain).  The register window of 2*kT u16 words moves by kT words
//   at the start of a run of kT steps when it is half used (a run consumes
//   at most kT words).
// - aux is read one run ahead, kT steps a coalesced load (mode 1 clamps
//   each id there), and a step takes its value with one shuffle.
// - Mode 1: the next step's context is known, so its row is loaded while
//   the current step is decoded.
// - Steps run in two loops: while every lane of the warp is active the
//   fast steps above; then general steps (the context from the state,
//   `t < len` as a select) until the run ends.  A lane that ends stays
//   ended, so a warp returns to the fast loop never after.
// - Corrupt streams stay bounded: s stays in [0, A), ctx in [0, C), and
//   nothing reads outside its buffers.
// - Built with -DK3_PROBE (k3_variants.py), the threads of lane 0 sum the
//   clock64 cycles of each part of its fast steps; see dsrc_k3_probe.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kProbBits = 14;
constexpr uint32_t kMask = (1u << kProbBits) - 1;
constexpr uint32_t kRansL = 1u << 16;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// __byte_perm selectors: (x << 16) | low or high half of a payload pair
constexpr uint32_t kLowHalf = 0x5410u;
constexpr uint32_t kHighHalf = 0x5432u;
// each thread forms the next x of its symbols (see the design notes) at
// row layouts of up to this many entries a thread (measured faster at one
// entry a thread, slower at four and eight: k3_variants.py); with more,
// the holder shuffles (cum[s], cum[s+1]) and the lane updates x after it
constexpr int kCandidateEntries = 1;

enum Route { kShared = 0, kGlobal = 1 };

struct Params {
  int pairs;          // payload width, in i32 pairs
  int t0, t1;         // the band
  int t_steps;        // T: row length of aux, osym and octx
  int lanes;
  int nctx, nsym;     // table [nctx, nsym + 1]
  int sbits;          // carry shift (mode 0: sym_bits; mode 2: qbits)
  uint32_t cmask;     // carry mask
  int hb, qbits, nlags;
  uint32_t lags;      // mode 2: lag widths, 8 bits each, lag 0 lowest
};

#ifdef K3_PROBE
// [0..5]: cycles summed over lane 0's fast steps, from mark to mark: step
// start to row load issued (with the shuffles for the payload pair and
// aux), row arrived, symbol search, the shuffles of the holder's x, the
// word pointer's update, next context;
// [6]: fast steps; [7]: cycles of the whole lane; [8]: its ns
// (globaltimer)
__device__ unsigned long long k3_probe_acc[9];
__shared__ uint32_t k3_sink;

__device__ __forceinline__ unsigned long long k3_clock(uint32_t dep) {
  // the volatile store waits for `dep`; the clock is read after it
  *reinterpret_cast<volatile uint32_t*>(&k3_sink) = dep;
  unsigned long long c;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c) :: "memory");
  return c;
}
#define K3_MARK(i, dep)                                       \
  do {                                                        \
    if (probe) {                                              \
      const unsigned long long c_ = k3_clock(dep);            \
      if ((i) > 0) acc[(i) > 0 ? (i) - 1 : 0] += c_ - last;   \
      last = c_;                                              \
    }                                                         \
  } while (0)
#else
#define K3_MARK(i, dep) \
  do {                  \
  } while (0)
#endif

__host__ __device__ constexpr int log2i(int v) {
  return v <= 1 ? 0 : 1 + log2i(v / 2);
}

// entries kE*k .. kE*k+kE-1 of a row into e[]
template <int kE, bool kLdg>
__device__ __forceinline__ void load_entries(const uint32_t* row, int k,
                                             uint32_t (&e)[kE]) {
  if constexpr (kE == 1) {
    e[0] = kLdg ? __ldg(row + k) : row[k];
  } else if constexpr (kE == 2) {
    const auto* r = reinterpret_cast<const uint2*>(row);
    const uint2 w = kLdg ? __ldg(r + k) : r[k];
    e[0] = w.x;
    e[1] = w.y;
  } else {
    const auto* r = reinterpret_cast<const uint4*>(row);
#pragma unroll
    for (int i = 0; i < kE / 4; ++i) {
      const uint4 w = kLdg ? __ldg(r + (kE / 4) * k + i) : r[(kE / 4) * k + i];
      e[4 * i] = w.x;
      e[4 * i + 1] = w.y;
      e[4 * i + 2] = w.z;
      e[4 * i + 3] = w.w;
    }
  }
}

// v[i] for a lane-uniform i < kE, as a tree of selects
template <int kE>
__device__ __forceinline__ uint32_t pick(const uint32_t (&v)[kE], int i) {
  if constexpr (kE == 1) {
    return v[0];
  } else if constexpr (kE == 2) {
    return (i & 1) ? v[1] : v[0];
  } else if constexpr (kE == 4) {
    const uint32_t a = (i & 1) ? v[1] : v[0];
    const uint32_t b = (i & 1) ? v[3] : v[2];
    return (i & 2) ? b : a;
  } else {
    const uint32_t a = (i & 1) ? v[1] : v[0];
    const uint32_t b = (i & 1) ? v[3] : v[2];
    const uint32_t c = (i & 1) ? v[5] : v[4];
    const uint32_t d = (i & 1) ? v[7] : v[6];
    const uint32_t ab = (i & 2) ? b : a;
    const uint32_t cd = (i & 2) ? d : c;
    return (i & 4) ? cd : ab;
  }
}

// the reference's coarse(h)
__device__ __forceinline__ uint32_t coarse(uint32_t h, const Params& p) {
  const uint32_t qmask = (1u << p.qbits) - 1;
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k < p.nlags) {
      const int w = (p.lags >> (8 * k)) & 0xFF;
      const uint32_t sv = (h >> (k * p.qbits)) & qmask;
      c = (c << w) | (w <= p.qbits ? sv >> (p.qbits - w) : 0u);
    }
  }
  return c;
}

__device__ __forceinline__ int32_t clamp_ctx(long long c, int nctx) {
  return static_cast<int32_t>(c < 0 ? 0 : (c >= nctx ? nctx - 1 : c));
}

// the context id of a step from the state and its raw aux value (the
// reference's rule)
template <int kMode>
__device__ __forceinline__ int32_t step_ctx(uint32_t carry, int32_t a,
                                            const Params& p) {
  if constexpr (kMode == 0) {
    return clamp_ctx(static_cast<int32_t>(carry), p.nctx);
  } else if constexpr (kMode == 1) {
    return clamp_ctx(a, p.nctx);
  } else {
    const uint32_t h = (a & 1) ? 0u : carry;
    return clamp_ctx(static_cast<long long>(coarse(h, p)) |
                         (static_cast<long long>(a >> 1) << p.hb),
                     p.nctx);
  }
}

// what a step of mode kMode takes from its aux value
template <int kMode>
__device__ __forceinline__ int32_t prepare_aux(int32_t a, const Params& p) {
  return kMode == 1 ? clamp_ctx(a, p.nctx) : a;
}

template <int kMode, int kT, int kE, int kRoute>
__global__ void __launch_bounds__(kThreads, 2)
ctx_decode_kernel(const int32_t* __restrict__ payload,
                  uint32_t* __restrict__ xs, int32_t* __restrict__ wptrs,
                  int32_t* __restrict__ carries,
                  const int32_t* __restrict__ lengths,
                  const int32_t* __restrict__ cum,
                  const uint32_t* __restrict__ rows,
                  const int32_t* __restrict__ aux, Params p,
                  int32_t* __restrict__ osym, int32_t* __restrict__ octx) {
  extern __shared__ __align__(16) uint32_t stab[];
  constexpr int kLanesPerWarp = 32 / kT;
  constexpr int kWidth = kT * kE;                 // entries a row
  constexpr int kShift = log2i(kWidth);
  constexpr int kEShift = log2i(kE);
  const int k = threadIdx.x & (kT - 1);           // thread of the lane
  const int seg = (threadIdx.x & 31) >> log2i(kT);
  const int lane = (blockIdx.x * kWarps + (threadIdx.x >> 5)) *
                       kLanesPerWarp + seg;
  const bool valid = lane < p.lanes;
  const uint32_t segmask =
      kT == 32 ? kFull : ((1u << (kT & 31)) - 1) << (seg * kT);

  if constexpr (kRoute == kShared) {
    // pack the table: entry j of row r = cum[r][j] | cum[r][j+1] << 16
    const int stride = p.nsym + 1;
    for (int i = threadIdx.x; i < p.nctx * kWidth; i += kThreads) {
      const int r = i >> kShift;
      const int j = i & (kWidth - 1);
      const int32_t* c = cum + r * stride + j;
      stab[i] = j < p.nsym ? static_cast<uint32_t>(__ldg(c)) |
                                 (static_cast<uint32_t>(__ldg(c + 1)) << 16)
                           : 0xFFFFFFFFu;
    }
    __syncthreads();
  }
  auto load_row = [&](int32_t ctx, uint32_t(&e)[kE]) {
    if constexpr (kRoute == kShared)
      load_entries<kE, false>(stab + (ctx << kShift), k, e);
    else
      load_entries<kE, true>(rows + (static_cast<size_t>(ctx) << kShift), k,
                             e);
  };
  // the symbol of a row held as e[] at state x: s, and the next x and
  // whether a word went in (wp: the payload pair of the next word, wsel
  // its half)
  auto decode = [&](const uint32_t(&e)[kE], uint32_t x, int32_t wp,
                    uint32_t wsel, uint32_t& xnext, bool& need) -> int {
    const uint32_t slot = x & kMask;
    const uint32_t lim = (slot + 1) << 16;
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < kE; ++i)
      cnt += __popc(__ballot_sync(kFull, e[i] < lim) & segmask);
    const int s = min(cnt, p.nsym - 1);
    const int src = s >> kEShift;
    auto next_x = [&](uint32_t w, bool& nd) {
      const uint32_t c = w & 0xFFFFu;
      const uint32_t xn = ((w >> 16) - c) * (x >> kProbBits) + slot - c;
      nd = xn < kRansL;
      return nd ? __byte_perm(static_cast<uint32_t>(wp), xn, wsel) : xn;
    };
    if constexpr (kE <= kCandidateEntries) {
      uint32_t xc[kE], nc[kE];
#pragma unroll
      for (int i = 0; i < kE; ++i) {
        bool nd;
        xc[i] = next_x(e[i], nd);
        nc[i] = nd;
      }
      xnext = __shfl_sync(kFull, pick<kE>(xc, s & (kE - 1)), src, kT);
      need = __shfl_sync(kFull, pick<kE>(nc, s & (kE - 1)), src, kT);
    } else {
      xnext = next_x(
          __shfl_sync(kFull, pick<kE>(e, s & (kE - 1)), src, kT), need);
    }
    return s;
  };

  const int32_t* prow = payload + static_cast<size_t>(lane) * p.pairs;
  const size_t obase = static_cast<size_t>(lane) * p.t_steps;
  const int len = valid ? lengths[lane] : 0;
  uint32_t x = valid ? xs[lane] : 0u;
  uint32_t carry = valid ? static_cast<uint32_t>(carries[lane]) : 0u;
  const int w0 = valid ? wptrs[lane] : 0;
  long long pbase = w0 >> 1;                  // floor, also for w0 < 0
  int o = w0 & 1;
  auto load_pair = [&](long long q) -> int32_t {
    return (valid && q >= 0 && q < p.pairs) ? __ldg(prow + q) : 0;
  };
  int32_t cur = load_pair(pbase + k);         // pairs [pbase, pbase + kT)
  int32_t nxt = load_pair(pbase + kT + k);    // [pbase + kT, pbase + 2kT)

  auto raw_aux = [&](int t) -> int32_t {
    return (kMode != 0 && valid && t < p.t_steps) ? __ldg(aux + obase + t)
                                                  : 0;
  };
  int32_t acur = prepare_aux<kMode>(raw_aux(p.t0 + k), p);
  int32_t anxt = prepare_aux<kMode>(raw_aux(p.t0 + kT + k), p);

  // the first step's context and history; mode 1: its row
  const int32_t a0 = raw_aux(p.t0);
  int32_t ctx = step_ctx<kMode>(carry, a0, p);
  uint32_t h = (a0 & 1) ? 0u : carry;
  uint32_t ecur[kE];
  if constexpr (kMode == 1) load_row(ctx, ecur);

#ifdef K3_PROBE
  const bool probe = lane == 0;
  unsigned long long acc[6] = {0, 0, 0, 0, 0, 0}, last = 0, nfast = 0;
  unsigned long long c_start, g_start;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c_start) :: "memory");
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_start) :: "memory");
#endif

  for (int t = p.t0; t < p.t1; t += kT) {
    const int m = min(p.t1 - t, kT);
    // every lane of the warp is active for the first `fast` steps
    const int fast = __reduce_min_sync(kFull, max(0, min(len - t, m)));
    {
      // move the window by kT words when it is half used
      const int src = (k + kT / 2) & (kT - 1);
      const int32_t c2 = __shfl_sync(kFull, k >= kT / 2 ? cur : nxt, src, kT);
      const int32_t n2 = __shfl_sync(kFull, nxt, src, kT);
      if (o >= kT) {
        pbase += kT / 2;
        o -= kT;
        cur = c2;
        nxt = k < kT / 2 ? n2 : load_pair(pbase + kT + k);
      }
    }
    int32_t keep_s = 0, keep_c = 0;
#pragma unroll 1
    for (int j = 0; j < fast; ++j) {
      K3_MARK(0, static_cast<uint32_t>(ctx));
      const int32_t wp = __shfl_sync(kFull, cur, o >> 1, kT);
      const uint32_t wsel = (o & 1) ? kHighHalf : kLowHalf;
      // the next step's aux value (modes 1, 2)
      int32_t an = 0;
      if constexpr (kMode != 0)
        an = __shfl_sync(kFull, j + 1 < kT ? acur : anxt, (j + 1) & (kT - 1),
                         kT);
      uint32_t e[kE];
      if constexpr (kMode == 1) {
#pragma unroll
        for (int i = 0; i < kE; ++i) e[i] = ecur[i];
        load_row(an, ecur);
      } else {
        load_row(ctx, e);
      }
      K3_MARK(1, static_cast<uint32_t>(ctx));
      K3_MARK(2, e[0]);
      bool need;
      const int s = decode(e, x, wp, wsel, x, need);
      K3_MARK(3, static_cast<uint32_t>(s));
      K3_MARK(4, x);
      o += need;
      K3_MARK(5, static_cast<uint32_t>(o));
      if (j == k) {
        keep_s = s;
        keep_c = ctx;
      }
      const uint32_t su = static_cast<uint32_t>(s);
      if constexpr (kMode == 0) {
        carry = ((carry << p.sbits) | su) & p.cmask;
        ctx = static_cast<int32_t>(
            min(carry, static_cast<uint32_t>(p.nctx - 1)));
      } else if constexpr (kMode == 1) {
        ctx = an;
      } else {
        carry = ((h << p.sbits) | su) & p.cmask;
        h = (an & 1) ? 0u : carry;
        ctx = step_ctx<2>(carry, an, p);
      }
      K3_MARK(6, static_cast<uint32_t>(ctx));
#ifdef K3_PROBE
      nfast += probe;
#endif
    }
    // general steps: the context from the state, the state held where a
    // lane has ended
#pragma unroll 1
    for (int j = fast; j < m; ++j) {
      const bool act = t + j < len;
      int32_t a = 0;
      if constexpr (kMode != 0) a = __shfl_sync(kFull, acur, j, kT);
      const int32_t cx = step_ctx<kMode>(carry, a, p);
      const int32_t wp = __shfl_sync(kFull, cur, o >> 1, kT);
      uint32_t e[kE];
      load_row(cx, e);
      uint32_t xn;
      bool need;
      const int s = decode(e, x, wp, (o & 1) ? kHighHalf : kLowHalf, xn,
                           need);
      x = act ? xn : x;
      o += act && need;
      const uint32_t hh = (kMode == 2 && (a & 1)) ? 0u : carry;
      if (act && kMode != 1)
        carry = ((hh << p.sbits) | static_cast<uint32_t>(s)) & p.cmask;
      if (j == k) {
        keep_s = s;
        keep_c = cx;
      }
    }
    if (valid && k < m) {
      osym[obase + t + k] = keep_s;
      octx[obase + t + k] = keep_c;
    }
    if constexpr (kMode != 0) {
      acur = anxt;
      anxt = prepare_aux<kMode>(raw_aux(t + 2 * kT + k), p);
    }
  }
  if (valid && k == 0) {
    xs[lane] = x;
    wptrs[lane] = static_cast<int32_t>(2 * pbase + o);
    carries[lane] = static_cast<int32_t>(carry);
  }
#ifdef K3_PROBE
  if (probe && k == 0) {
    unsigned long long c_end, g_end;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(c_end) :: "memory");
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_end) :: "memory");
    for (int i = 0; i < 6; ++i) k3_probe_acc[i] += acc[i];
    k3_probe_acc[6] += nfast;
    k3_probe_acc[7] += c_end - c_start;
    k3_probe_acc[8] += g_end - g_start;
  }
#endif
}

template <int kMode, int kT, int kE>
cudaError_t launch(int route, int lanes, cudaStream_t stream,
                   const int32_t* payload, uint32_t* x, int32_t* wptr,
                   int32_t* carry, const int32_t* lengths, const int32_t* cum,
                   const uint32_t* rows, const int32_t* aux, const Params& p,
                   int32_t* osym, int32_t* octx) {
  constexpr int kLanesPerBlock = kWarps * 32 / kT;
  const int blocks = (lanes + kLanesPerBlock - 1) / kLanesPerBlock;
  if (route == kGlobal) {
    ctx_decode_kernel<kMode, kT, kE, kGlobal><<<blocks, kThreads, 0, stream>>>(
        payload, x, wptr, carry, lengths, cum, rows, aux, p, osym, octx);
    return cudaGetLastError();
  }
  if (route != kShared) return cudaErrorInvalidValue;
  auto kernel = ctx_decode_kernel<kMode, kT, kE, kShared>;
  const size_t smem = sizeof(uint32_t) * kT * kE * static_cast<size_t>(p.nctx);
  if (smem > 48 * 1024) {
    // a refused attribute is returned, and cleared so that it does not
    // surface at a later launch's cudaGetLastError()
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();
      return err;
    }
  }
  kernel<<<blocks, kThreads, smem, stream>>>(payload, x, wptr, carry,
                                             lengths, cum, rows, aux, p,
                                             osym, octx);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t launch_mode(int threads, int groups, int route, int lanes,
                        cudaStream_t stream, const int32_t* payload,
                        uint32_t* x, int32_t* wptr, int32_t* carry,
                        const int32_t* lengths, const int32_t* cum,
                        const uint32_t* rows, const int32_t* aux,
                        const Params& p, int32_t* osym, int32_t* octx) {
#define DSRC_LAUNCH(T, E)                                                  \
  if (threads == T && groups == E)                                         \
    return launch<kMode, T, E>(route, lanes, stream, payload, x, wptr,     \
                               carry, lengths, cum, rows, aux, p, osym,    \
                               octx);
  DSRC_LAUNCH(8, 1)
  DSRC_LAUNCH(8, 2)
  DSRC_LAUNCH(16, 1)
  DSRC_LAUNCH(16, 2)
  DSRC_LAUNCH(16, 4)
  DSRC_LAUNCH(32, 1)
  DSRC_LAUNCH(32, 2)
  DSRC_LAUNCH(32, 4)
  DSRC_LAUNCH(32, 8)
#undef DSRC_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches K3 for steps [t0, t1) on `stream`.  payload: int32 [L, pairs]
// (u16 word pairs, low half first); x (uint32), wptr, carry: int32 [L],
// read and written back; lengths int32 [L]; cum int32 [nctx, nsym+1];
// rows: route 1's packed rows [nctx, threads*groups] (null otherwise);
// aux int32 [L, t_steps] (modes 1 and 2; may be null in mode 0); osym,
// octx int32 [L, t_steps].  threads: threads a lane (8, 16, 32); groups:
// packed entries a thread (threads*groups >= nsym; the pairs (8, 1..2),
// (16, 1..4), (32, 1..8)); route: 0 the table packed into shared memory,
// 1 rows in device memory.  lags: mode 2's lag widths, 8 bits each.
// Returns the first CUDA error of the launch, or cudaGetLastError() after
// it.
extern "C" int dsrc_ctx_decode(const void* payload, int pairs, void* x,
                               void* wptr, void* carry, const void* lengths,
                               const void* cum, const void* rows, int nctx,
                               int nsym, const void* aux, int t0, int t1,
                               int t_steps, int lanes, int mode, int sbits,
                               int cmask, int hb, int qbits, int nlags,
                               int lags, int threads, int groups, int route,
                               void* osym, void* octx, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p = {};
  p.pairs = pairs;
  p.t0 = t0;
  p.t1 = t1;
  p.t_steps = t_steps;
  p.lanes = lanes;
  p.nctx = nctx;
  p.nsym = nsym;
  p.sbits = sbits;
  p.cmask = static_cast<uint32_t>(cmask);
  p.hb = hb;
  p.qbits = qbits;
  p.nlags = nlags;
  p.lags = static_cast<uint32_t>(lags);
  // mode 0's steps take min(carry, nctx - 1) for the clamp
  if (mode == 0 && cmask < 0) return cudaErrorInvalidValue;
  const auto* pl = static_cast<const int32_t*>(payload);
  auto* xs = static_cast<uint32_t*>(x);
  auto* wp = static_cast<int32_t*>(wptr);
  auto* cr = static_cast<int32_t*>(carry);
  const auto* ln = static_cast<const int32_t*>(lengths);
  const auto* cm = static_cast<const int32_t*>(cum);
  const auto* rw = static_cast<const uint32_t*>(rows);
  const auto* ax = static_cast<const int32_t*>(aux);
  auto* os = static_cast<int32_t*>(osym);
  auto* oc = static_cast<int32_t*>(octx);
  const auto s = static_cast<cudaStream_t>(stream);
#define DSRC_MODE(M)                                                       \
  launch_mode<M>(threads, groups, route, lanes, s, pl, xs, wp, cr, ln, cm, \
                 rw, ax, p, os, oc)
  switch (mode) {
    case 0: err = DSRC_MODE(0); break;
    case 1: err = DSRC_MODE(1); break;
    case 2: err = DSRC_MODE(2); break;
    default: err = cudaErrorInvalidValue;
  }
#undef DSRC_MODE
  return static_cast<int>(err);
}

#ifdef K3_PROBE
// Copies the probe's sums (k3_probe_acc, 9 u64) to `out` and zeroes them.
extern "C" int dsrc_k3_probe(void* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k3_probe_acc,
                                         sizeof(k3_probe_acc));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[9] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(k3_probe_acc, zero, sizeof(zero)));
}
#endif
