// K1: positional rANS encode, hand-written for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel _enc_kernel (dsrc_tpu/ops/rans_pallas.py:73,
// entry rans_encode_from_freqs_tpu), which computes the same function as the
// XLA wavefront dsrc_tpu/ops/rans.py:205 rans_encode_from_freqs.  Its plain
// PyTorch version is dsrc_tpu_torch/ops/rans_kernels.py:rans_encode_plain.
//
// Function: per lane, a reverse rANS pass over t = T-1 .. 0 with a u32
// state starting at 2^16.  For an active step with model (f, c), f in
// [1, 2^14): emit the low 16 bits when x >= f << 18, then
// x = (x / f) << 14 + c + x % f.  (At f = 2^14, which no wire alphabet of
// 8 or more symbols reaches, the kernel follows the plain version: it
// never emits.)  Emission k of a lane lands at u16 slot 2*Wp - 1 - k of
// its payload row (the i32 pair array read as little-endian u16), so the
// words sit right-aligned in decode order, zeros left of them.  Outputs:
// payload [L, Wp], nwords [L], final states [L].
//
// What bounds it on this card: neither bytes nor operations (both bounds
// are a few microseconds).  The wire format gives each lane one u32 state
// and one serial chain of T steps, and an 8 MB block has only 4,256 quality
// lanes (T = 800), 532 value-plane lanes (T = 448) or 4,224 title lanes
// (T = 416): about one warp of lanes per SM.  The time is T times the
// latency of one step, so the design keeps all but the step's dependent
// integer ops off the chain.
//
// Design:
// - Warp specialisation.  A block serves 32 lanes: warp 0 (the consumer)
//   runs one lane per thread; kProducers producer warps stage the steps'
//   model entries into a two-stage ring in shared memory, kChunk steps a
//   stage, walking t down from T-1.  Producers stage chunk k+1 while the
//   consumer runs chunk k, and one block barrier a chunk hands the stages
//   over.  Their device-memory loads are issued two chunks ahead into two
//   register buffers that take turns, and no load is conditional, so a
//   producer never waits on a load it has just issued.  Lanes are the
//   minor axis of the [T, L] inputs, so a staged row is a coalesced
//   128-byte load.  Every thread, also of lanes past `lanes`, reaches every
//   barrier.  Before the first barrier the producers zero the block's
//   payload rows, so the caller need not.
// - The divisor's f-only work is done when an entry is staged: the
//   Granlund-Montgomery magic number m = floor(2^32 (2^l - f) / f) + 1,
//   l = ceil(log2 f), read from a table the compiler computes, so that
//   x / f = (x + mulhi(x, m)) >> l exactly for every u32 x (the sum taken
//   in 33 bits); the remainder folds into x + q (2^14 - f) + c.  The entry
//   is {(f << 18) - 1, m, (2^14 - f) | l << 16, c}, one 16-byte shared load
//   a step.  rans_kernels.py:recip_divmod_plain is the same rule in
//   PyTorch, tested against floor division for every f; the table is held
//   to it on the card by a stream that uses every f in [1, 2^14).
// - Branchless steps.  An inactive step (and the padding of the last,
//   partial chunk) is the entry {~0, 0, 0, 0}: it never emits and leaves x
//   unchanged, so the consumer runs every chunk as kChunk unrolled steps
//   with no test.  Both successors of x (with and without the emission)
//   are computed, so the emit compare runs beside the divide: the chain of
//   a step is mulhi, a 33-bit add, a funnel shift, a multiply-add and the
//   select.
// - Emissions are paired in a register: emission 2k is the high half and
//   2k+1 the low half of pair Wp-1-k; a pair is stored as one u32 when it
//   completes, by a predicated store, and a trailing odd word as a high
//   half over a zero low half.
// - Measured choices: k1_variants.py builds each alternative from this
//   source and times it beside this kernel at the main path's three
//   shapes (PERF.md has the numbers).  At the quality shape the
//   alternatives took longer by: 2, 4 or 16 producer warps 47%, 24%, 4%;
//   16- or 64-step chunks 30%, 4% (64 spills); m by a divide when staging
//   61%; one successor of x 7%; the pair store under an `if` 1.5%.
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr uint32_t kProbBits = 14;
constexpr uint32_t kM = 1u << kProbBits;
constexpr uint32_t kRansL = 1u << 16;
constexpr uint32_t kEncShift = kProbBits + 4;
constexpr int kChunk = 32;                 // steps a ring stage holds
constexpr int kProducers = 8;              // producer warps a block
constexpr int kThreads = 32 * (1 + kProducers);
constexpr int kPerThread = kChunk / kProducers;   // entries a producer stages
static_assert(kChunk % kProducers == 0, "producers split a chunk evenly");
constexpr size_t kRingBytes = 2 * kChunk * 32 * sizeof(uint4);
static_assert(kRingBytes <= 48 * 1024, "the ring fits the default budget");

// Block barrier 0 over all kThreads threads.  The consumer and producer
// warps reach it from different branches, each the same number of times.
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 0, %0;" ::"n"(kThreads) : "memory");
}

// *dst = v where p holds, as a predicated store: no branch on a step.
__device__ __forceinline__ void store_if(bool p, uint32_t* dst, uint32_t v) {
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t"
      "@q st.global.u32 [%0], %1;\n\t}" ::"l"(dst),
      "r"(v), "r"(static_cast<uint32_t>(p)));
}

// x -> (x / f) << 14 + c + x % f, as x + q (2^14 - f) + c with
// q = (x + mulhi(x, m)) >> l, the sum taken in 33 bits: the reciprocal
// rule of rans_kernels.recip_divmod_plain.
__device__ __forceinline__ uint32_t step(uint32_t x, uint32_t m, uint32_t l,
                                         uint32_t cm, uint32_t c) {
  const unsigned long long sum =
      static_cast<unsigned long long>(x) + __umulhi(x, m);
  const uint32_t q = __funnelshift_r(static_cast<uint32_t>(sum),
                                     static_cast<uint32_t>(sum >> 32), l);
  return q * cm + x + c;
}

// One producer thread's raw inputs of one chunk, for steps j = warp +
// kProducers * i: f, c and active as loaded, and bit i of `in` set where
// step j exists (t >= 0, lane < lanes).  Loads outside the stream read
// element 0, so no load is conditional and nothing waits for one here.
struct Raw {
  uint32_t f[kPerThread];
  uint32_t c[kPerThread];
  uint32_t a[kPerThread];
  uint32_t in;
};

__device__ __forceinline__ Raw load_chunk(const int32_t* __restrict__ freq,
                                          const int32_t* __restrict__ cum,
                                          const uint8_t* __restrict__ active,
                                          int t_steps, int lanes, int lane,
                                          int pw, int chunk) {
  Raw r;
  r.in = 0;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int t = t_steps - 1 - chunk * kChunk - (pw + kProducers * i);
    const bool in = t >= 0 && lane < lanes;
    const size_t idx = in ? static_cast<size_t>(t) * lanes + lane : 0;
    r.f[i] = static_cast<uint32_t>(__ldg(freq + idx));
    r.c[i] = static_cast<uint32_t>(__ldg(cum + idx));
    r.a[i] = __ldg(active + idx);
    r.in |= static_cast<uint32_t>(in) << i;
  }
  return r;
}

// K1's Granlund-Montgomery magic numbers m[f] = floor(2^32 (2^l - f) / f)
// + 1, l = ceil(log2 f), for f in [1, 2^14], computed by the compiler: a
// 64 KB read-only table in device memory.
struct MagicTable {
  uint32_t m[kM + 1];
  constexpr MagicTable() : m() {
    for (uint32_t f = 1; f <= kM; ++f) {
      uint32_t l = 0;
      while ((1u << l) < f) ++l;
      m[f] = static_cast<uint32_t>(
          (((static_cast<unsigned long long>(1) << l) - f) << 32) / f + 1);
    }
  }
};
__device__ const MagicTable kMagic = MagicTable();

// The staged entry of a step with model (f, c); f == 0 marks an inactive
// step.  At f = 2^14, (f << 18) - 1 wraps to ~0, which never emits, as
// the plain version's x >= 2^32 never holds.
__device__ __forceinline__ uint4 make_entry(uint32_t f, uint32_t c) {
  if (f == 0) return make_uint4(~0u, 0u, 0u, 0u);
  const uint32_t l = 32 - __clz(f - 1);          // ceil(log2 f)
  // a freq above 2^14 (outside the domain) never reads outside the table
  const uint32_t m = __ldg(&kMagic.m[min(f, kM)]);
  return make_uint4((f << kEncShift) - 1, m, (kM - f) | (l << 16), c);
}

__device__ __forceinline__ void stage_chunk(uint4* __restrict__ stage,
                                            const Raw& r, int pw, int k) {
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const bool on = ((r.in >> i) & 1) && r.a[i];
    stage[(pw + kProducers * i) * 32 + k] =
        make_entry(on ? r.f[i] : 0u, on ? r.c[i] : 0u);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
rans_encode_kernel(const int32_t* __restrict__ freq,
                   const int32_t* __restrict__ cum,
                   const uint8_t* __restrict__ active, int t_steps, int lanes,
                   int wp, uint32_t* __restrict__ payload,
                   int32_t* __restrict__ nwords, uint32_t* __restrict__ states) {
  extern __shared__ uint4 ring[];               // [2][kChunk][32]
  const int k = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lane = blockIdx.x * 32 + k;
  const int n_chunks = (t_steps + kChunk - 1) / kChunk;

  if (warp == 0) {
    // consumer: one lane per thread
    const bool live = lane < lanes;
    uint32_t* row = payload + static_cast<size_t>(live ? lane : 0) * wp;
    uint32_t x = kRansL;
    uint32_t acc = 0;                           // the last two words
    uint32_t* dst = row + (wp - 1);             // the pair being filled
    bool odd = false;                           // words emitted is odd
    block_sync();
    for (int ch = 0; ch < n_chunks; ++ch) {
      const uint4* st = ring + (ch & 1) * (kChunk * 32) + k;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const uint4 e = st[j * 32];
        const bool emit = x > e.x;
        acc = emit ? __byte_perm(x, acc, 0x5410) : acc;  // acc << 16 | x&0xFFFF
        // an emission after an odd count completes pair dst; a lane with
        // no emissions never stores, live or not
        const bool put = emit && odd;
        store_if(put, dst, acc);
        dst -= put;
        odd ^= emit;
        // both successors of x, with and without the emission, so that the
        // compare runs beside the divide and only a select waits for it
        const uint32_t sh = e.z >> 16;
        const uint32_t cm = e.z & 0xFFFFu;
        const uint32_t x0 = step(x, e.y, sh, cm, e.w);
        const uint32_t x1 = step(x >> 16, e.y, sh, cm, e.w);
        x = emit ? x1 : x0;
      }
      block_sync();
    }
    if (live) {
      if (odd) *dst = acc << 16;
      nwords[lane] = 2 * static_cast<int32_t>(row + (wp - 1) - dst) + odd;
      states[lane] = x;
    }
  } else {
    // producers: stage chunk ch + 1 while the consumer runs chunk ch.  Two
    // register buffers take turns (ra: even chunks, rb: odd), so a chunk's
    // loads are issued two chunks before it is staged and never copied.
    const int pw = warp - 1;
    uint4* const ring1 = ring + kChunk * 32;
    Raw ra, rb;
    // zero the block's payload rows; the consumer's pair stores follow the
    // first barrier, which orders them after these
    const int lane0 = blockIdx.x * 32;
    const int n16 = min(32, lanes - lane0) * (wp / 4);
    uint4* const zrow =
        reinterpret_cast<uint4*>(payload + static_cast<size_t>(lane0) * wp);
    for (int i = threadIdx.x - 32; i < n16; i += kThreads - 32)
      zrow[i] = make_uint4(0u, 0u, 0u, 0u);
    if (n_chunks > 0) {
      ra = load_chunk(freq, cum, active, t_steps, lanes, lane, pw, 0);
      rb = load_chunk(freq, cum, active, t_steps, lanes, lane, pw, 1);
      stage_chunk(ring, ra, pw, k);
      ra = load_chunk(freq, cum, active, t_steps, lanes, lane, pw, 2);
    }
    block_sync();
    for (int ch = 0; ch < n_chunks; ch += 2) {
      if (ch + 1 < n_chunks) {
        stage_chunk(ring1, rb, pw, k);
        rb = load_chunk(freq, cum, active, t_steps, lanes, lane, pw, ch + 3);
      }
      block_sync();
      if (ch + 1 < n_chunks) {
        if (ch + 2 < n_chunks) {
          stage_chunk(ring, ra, pw, k);
          ra = load_chunk(freq, cum, active, t_steps, lanes, lane, pw, ch + 4);
        }
        block_sync();
      }
    }
  }
}

}  // namespace

// Launches K1 on `stream` (a cudaStream_t from PyTorch).  Pointers are device
// pointers of contiguous tensors: freq, cum int32 [T, L], active bool [T, L],
// payload int32 [L, wp] (written whole: wp a multiple of 4, as
// payload_pairs gives it), nwords int32 [L], states uint32 [L].  Leaves the
// calling thread's current device as it was.  Returns the first CUDA error
// of the launch, or cudaGetLastError() after it.
extern "C" int dsrc_rans_encode(const void* freq, const void* cum,
                                const void* active, int t_steps, int lanes,
                                int wp, void* payload, void* nwords,
                                void* states, int device, void* stream) {
  if (wp % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (lanes + 31) / 32;
  return static_cast<int>(dsrc::on_device(device, [&] {
    rans_encode_kernel<<<blocks, kThreads, kRingBytes,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(freq), static_cast<const int32_t*>(cum),
        static_cast<const uint8_t*>(active), t_steps, lanes, wp,
        static_cast<uint32_t*>(payload), static_cast<int32_t*>(nwords),
        static_cast<uint32_t*>(states));
    return cudaGetLastError();
  }));
}
