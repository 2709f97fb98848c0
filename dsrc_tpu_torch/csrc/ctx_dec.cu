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
// What bounds it on this card: each lane is a chain of dependent steps: in
// modes 0 and 2 the table row of a step depends on the symbol just decoded,
// so each step waits for one row load.  The bytes bound (symbols and ids
// out, payload in) is far below the chain's latency.
//
// Design (K2's, rans_dec.cu, as the template):
// - One warp per lane, kWarps lanes per block.  x, the word pointer, the
//   carry and the symbol are uniform across the warp.
// - The row is read as kE coalesced loads: thread k holds entries
//   1 + k + 32*e (e < kE) of the row; the symbol is one ballot count.
//   cum[s] and cum[s+1] come from the holders' registers by __shfl_sync.
//   ASSUMPTION: every row is non-decreasing and starts with cum[0] = 0, as
//   cum_from_freqs of a quantized table is (the only caller,
//   ops/ctx.py:decode_ctx_lanes); the count then equals the reference's
//   search.
// - The table is staged in shared memory when it fits the wrapper's budget
//   (kShared), else read from device memory, where L2 holds it.
// - Payload words come from a register window of 64 u16 words, the next
//   window loaded as soon as the current one is entered (as in K2).
// - aux (modes 1 and 2) is read 32 steps at a time, one coalesced load per
//   32 steps, the next 32 loaded a run ahead; a step takes its value by
//   __shfl_sync.  Symbols and ids are written as one run of 32 per warp.
// - Corrupt streams stay bounded: s stays in [0, A), ctx in [0, C), and
//   nothing reads outside its buffers.
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

template <int kE>
__device__ __forceinline__ int32_t pick(const int32_t (&v)[kE], int e) {
  int32_t r = v[0];
#pragma unroll
  for (int i = 1; i < kE; ++i)
    if (i == e) r = v[i];
  return r;
}

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

template <int kMode, int kE, bool kShared>
__global__ void __launch_bounds__(kThreads)
ctx_decode_kernel(const int32_t* __restrict__ payload,
                  uint32_t* __restrict__ xs, int32_t* __restrict__ wptrs,
                  int32_t* __restrict__ carries,
                  const int32_t* __restrict__ lengths,
                  const int32_t* __restrict__ table,
                  const int32_t* __restrict__ aux, Params p,
                  int32_t* __restrict__ osym, int32_t* __restrict__ octx) {
  extern __shared__ int32_t stab[];
  const int k = threadIdx.x & 31;
  const int lane = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int stride = p.nsym + 1;
  const int32_t* tab = table;
  if constexpr (kShared) {
    const int total = p.nctx * stride;
    for (int i = threadIdx.x; i < total; i += kThreads) stab[i] = __ldg(table + i);
    __syncthreads();
    tab = stab;
  }
  if (lane >= p.lanes) return;

  const int32_t* prow = payload + static_cast<size_t>(lane) * p.pairs;
  const size_t obase = static_cast<size_t>(lane) * p.t_steps;
  const int len = lengths[lane];
  uint32_t x = xs[lane];
  uint32_t carry = static_cast<uint32_t>(carries[lane]);
  const int w0 = wptrs[lane];
  long long pbase = w0 >> 1;                // floor, also for w0 < 0
  int o = w0 & 1;
  auto load_pair = [&](long long q) -> int32_t {
    return (q >= 0 && q < p.pairs) ? __ldg(prow + q) : 0;
  };
  int32_t cur = load_pair(pbase + k);
  int32_t nxt = load_pair(pbase + kWindow / 2 + k);
  int32_t wpair = __shfl_sync(kFull, cur, o >> 1);
  uint32_t wsel = (o & 1) ? kHighHalf : kLowHalf;

  auto load_aux = [&](int t) -> int32_t {
    return (kMode != 0 && t < p.t_steps) ? __ldg(aux + obase + t) : 0;
  };
  int32_t acur = load_aux(p.t0 + k);
  int32_t anxt = load_aux(p.t0 + 32 + k);

  for (int t = p.t0; t < p.t1; t += 32) {
    const int m = min(p.t1 - t, 32);
    int32_t keep_s = 0, keep_c = 0;
#pragma unroll 1
    for (int j = 0; j < m; ++j) {
      const bool act = t + j < len;
      uint32_t h = carry;
      int32_t ctx;
      if constexpr (kMode == 0) {
        ctx = static_cast<int32_t>(carry);
      } else {
        const int32_t a = __shfl_sync(kFull, acur, j);
        if constexpr (kMode == 1) {
          ctx = a;
        } else {
          h = (a & 1) ? 0u : carry;
          ctx = static_cast<int32_t>(coarse(h, p) |
                                     (static_cast<uint32_t>(a >> 1) << p.hb));
        }
      }
      ctx = ctx < 0 ? 0 : (ctx >= p.nctx ? p.nctx - 1 : ctx);
      const int32_t* row = tab + static_cast<size_t>(ctx) * stride;
      int32_t v[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int i = 1 + k + 32 * e;
        v[e] = i <= p.nsym ? row[i] : INT_MAX;
      }
      const int32_t slot = static_cast<int32_t>(x & kMask);
      int count = 0;
#pragma unroll
      for (int e = 0; e < kE; ++e) count += __popc(__ballot_sync(kFull, v[e] <= slot));
      const int s = min(count, p.nsym - 1);
      // cum[s] is entry s (held by thread (s-1) & 31 in v[(s-1) >> 5]),
      // cum[s+1] is held by thread s & 31 in v[s >> 5]
      const int32_t lo = __shfl_sync(kFull, pick(v, (s - 1) >> 5), (s - 1) & 31);
      const int32_t hi = __shfl_sync(kFull, pick(v, s >> 5), s & 31);
      const uint32_t c = s == 0 ? 0u : static_cast<uint32_t>(lo);
      if (j == k) {
        keep_s = s;
        keep_c = ctx;
      }
      if (act) {
        const uint32_t f = static_cast<uint32_t>(hi) - c;
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
        if constexpr (kMode != 1)
          carry = ((h << p.sbits) | static_cast<uint32_t>(s)) & p.cmask;
      }
    }
    if (k < m) {
      osym[obase + t + k] = keep_s;
      octx[obase + t + k] = keep_c;
    }
    if constexpr (kMode != 0) {
      acur = anxt;
      anxt = load_aux(t + 64 + k);
    }
  }
  if (k == 0) {
    xs[lane] = x;
    wptrs[lane] = static_cast<int32_t>(2 * pbase + o);
    carries[lane] = static_cast<int32_t>(carry);
  }
}

template <int kMode, int kE>
cudaError_t launch(bool shared, int blocks, size_t smem, cudaStream_t stream,
                   const int32_t* payload, uint32_t* x, int32_t* wptr,
                   int32_t* carry, const int32_t* lengths,
                   const int32_t* table, const int32_t* aux, const Params& p,
                   int32_t* osym, int32_t* octx) {
  if (shared) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          ctx_decode_kernel<kMode, kE, true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    ctx_decode_kernel<kMode, kE, true><<<blocks, kThreads, smem, stream>>>(
        payload, x, wptr, carry, lengths, table, aux, p, osym, octx);
  } else {
    ctx_decode_kernel<kMode, kE, false><<<blocks, kThreads, 0, stream>>>(
        payload, x, wptr, carry, lengths, table, aux, p, osym, octx);
  }
  return cudaGetLastError();
}

template <int kMode>
cudaError_t launch_mode(int ne, bool shared, int blocks, size_t smem,
                        cudaStream_t stream, const int32_t* payload,
                        uint32_t* x, int32_t* wptr, int32_t* carry,
                        const int32_t* lengths, const int32_t* table,
                        const int32_t* aux, const Params& p, int32_t* osym,
                        int32_t* octx) {
#define DSRC_LAUNCH(E)                                                      \
  launch<kMode, E>(shared, blocks, smem, stream, payload, x, wptr, carry,  \
                   lengths, table, aux, p, osym, octx)
  switch (ne) {
    case 1: return DSRC_LAUNCH(1);
    case 2: return DSRC_LAUNCH(2);
    case 4: return DSRC_LAUNCH(4);
    case 8: return DSRC_LAUNCH(8);
    default: return cudaErrorInvalidValue;
  }
#undef DSRC_LAUNCH
}

}  // namespace

// Launches K3 for steps [t0, t1) on `stream`.  payload: int32 [L, pairs]
// (u16 word pairs, low half first); x (uint32), wptr, carry: int32 [L],
// read and written back; lengths int32 [L]; table int32 [nctx, nsym+1];
// aux int32 [L, t_steps] (modes 1 and 2; may be null in mode 0); osym, octx
// int32 [L, t_steps].  ne: 32-entry groups a row is read in (1, 2, 4, 8;
// 32 * ne >= nsym); shared: stage the table in `smem` bytes of shared
// memory.  lags: mode 2's lag widths, 8 bits each.  Returns
// cudaGetLastError() after the launch.
extern "C" int dsrc_ctx_decode(const void* payload, int pairs, void* x,
                               void* wptr, void* carry, const void* lengths,
                               const void* table, int nctx, int nsym,
                               const void* aux, int t0, int t1, int t_steps,
                               int lanes, int mode, int sbits, int cmask,
                               int hb, int qbits, int nlags, int lags, int ne,
                               int shared, void* osym, void* octx, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
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
  const int blocks = (lanes + kWarps - 1) / kWarps;
  const size_t smem =
      shared ? static_cast<size_t>(nctx) * (nsym + 1) * sizeof(int32_t) : 0;
  const auto* pl = static_cast<const int32_t*>(payload);
  auto* xs = static_cast<uint32_t*>(x);
  auto* wp = static_cast<int32_t*>(wptr);
  auto* cr = static_cast<int32_t*>(carry);
  const auto* ln = static_cast<const int32_t*>(lengths);
  const auto* tb = static_cast<const int32_t*>(table);
  const auto* ax = static_cast<const int32_t*>(aux);
  auto* os = static_cast<int32_t*>(osym);
  auto* oc = static_cast<int32_t*>(octx);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      err = launch_mode<0>(ne, shared != 0, blocks, smem, s, pl, xs, wp, cr, ln,
                           tb, ax, p, os, oc);
      break;
    case 1:
      err = launch_mode<1>(ne, shared != 0, blocks, smem, s, pl, xs, wp, cr, ln,
                           tb, ax, p, os, oc);
      break;
    case 2:
      err = launch_mode<2>(ne, shared != 0, blocks, smem, s, pl, xs, wp, cr, ln,
                           tb, ax, p, os, oc);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
