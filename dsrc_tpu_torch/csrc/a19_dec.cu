// K4: the static order-0 rANS decode of DNA scheme A19, hand-written for
// Hopper (sm_90a).
//
// Replaces: the XLA scan dsrc_tpu/ops/rans.py:rans_decode (:305, lax.scan at
// :363) as dsrc_tpu/models/dna.py:_a19_decode (:80-94) drives it: one shared
// table of 19 frequencies, lane j decoding records j*T + t while they are
// below n.  Its plain PyTorch version is
// dsrc_tpu_torch/ops/a19_kernels.py:a19_decode_plain.
//
// Function: cum = prefix sums of the 19 frequencies (cum[0] = 0).  Step t of
// lane j: slot = x & (2^14-1); s = min(#{i in 1..19 : cum[i] <= slot}, 18),
// which is K2's rule (rans_dec.cu, ops/rans_kernels.count_search_plain) on
// the one row; x = f*(x >> 14) + slot - cum[s] with f = cum[s+1] - cum[s]
// (u32 arithmetic); one u16 word is shifted in when x < 2^16.  Steps t with
// j*T + t >= n hold the state and still write the symbol of it.  Output:
// out uint8 [L*T], lane j's T symbols at j*T: stream order.
//
// What bounds it on this card: each lane is one chain of T dependent steps
// (T = 2,048 at n = 3.3 M, 16,384 at a 64 MB -m1 block, 65,536 at a 256 MB
// -m2 block; at most 2,048 lanes), so the stream takes at least T times the
// latency of one step; the bytes (a few MB) and the operations are far below
// that.  The least step the card allows is one shared-memory load, one
// multiply-add and a compare-select (k4_variants.py measures it).  K2 at P
// = 1 served this stream before and spent about 700 cycles a step on its
// record, tile and run loops, a warp vote and two more dependent shared
// reads, with 31 of a warp's 32 threads idle.
//
// Design:
// - One slot table in shared memory, built by each block from the 19
//   frequencies (kernel parameters): entry[slot] = (f, bias = slot -
//   cum[s]) and sym[slot] = s, so a step is x = f * (x >> 14) + bias after
//   ONE load.  Both fields are below 2^14: f is one 14-bit field, and
//   cum[s] <= slot (the table is filled by the ranges [cum[s], cum[s+1])
//   clipped to the 2^14 slots; symbol 18 also takes every slot from
//   cum[19] up when the fields sum below 2^14, with f = freq[18], maybe 0:
//   then x = bias < 2^16 and a word comes in, as in K2).  The entries are
//   two u32 (kWideEntries: one 8-byte load and no unpacking on the chain;
//   128 KB) or f << 14 | bias (64 KB); the symbols are a u8 table off the
//   chain (16 KB).  Dynamic shared memory, opted in above 48 KB.
// - A thread per lane.  The lane's payload words wait in a ring of 128
//   words in shared memory, filled by cp.async (no register is the target
//   of a load, so no step waits on another lane's load: the per-warp
//   register scoreboard would make a window of words held in registers
//   wait on the latest load of any lane of the warp).  Pair p of a lane's
//   ring sits in the lane's own bank, so the word loads of a warp never
//   conflict.  The ring is refilled at the start of each group of 16
//   steps, a warp-uniform point, and at least 16 words that landed two
//   boundaries ago lie ahead of the lane.  A step loads the word at its
//   read position on every step, beside the table's load and off the
//   chain (loaded only on the steps that take a word, the load sat on the
//   chain behind the compare), and takes at most one word.  A word outside
//   the row reads as 0, as in K2.
// - Steps run in groups of 16: the symbols are packed into four u32 and
//   stored as one 16-byte store (T a multiple of 16; else a byte a step).
//   A lane's inactive steps (j*T + t >= n, a suffix) hold the state: their
//   symbol is written without stepping.
// - Blocks of 128 threads build the table together; the first
//   `lanes_per_block` of them decode one lane each and the rest exit, so
//   2,048 lanes spread over the card (the wrapper picks 16: 128 blocks,
//   one on each of 128 SMs; fewer lanes a warp meet fewer bank conflicts
//   on the table).
// - Corrupt streams stay bounded: the loop runs exactly T steps, s stays
//   in [0, 19), and nothing reads outside its buffers.
#include <atomic>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kProbBits = 14;
constexpr int kSlots = 1 << kProbBits;
constexpr uint32_t kMask = kSlots - 1;
constexpr uint32_t kRansL = 1u << 16;
constexpr int kNsym = 19;
constexpr int kThreads = 128;
constexpr int kGroup = 16;                 // steps a 16-byte output store
// __byte_perm selectors: (x << 16) | low or high half of a payload pair
constexpr uint32_t kLowHalf = 0x5410u;
constexpr uint32_t kHighHalf = 0x5432u;
// entries of two u32 (f, bias); false packs f << 14 | bias into one u32
// (k4_variants.py times that form)
constexpr bool kWideEntries = true;

struct WideEntry {
  uint32_t f, bias;
};
using Entry = typename std::conditional<kWideEntries, WideEntry,
                                        uint32_t>::type;
constexpr size_t kTableBytes = kSlots * (sizeof(Entry) + 1);

template <typename E>
__device__ __forceinline__ E make_entry(uint32_t f, uint32_t bias) {
  if constexpr (std::is_same<E, WideEntry>::value) {
    return WideEntry{f, bias};
  } else {
    return (f << kProbBits) | bias;
  }
}

// f * (x >> 14) + bias of one entry (u32 arithmetic)
__device__ __forceinline__ uint32_t next_state(WideEntry e, uint32_t x) {
  return e.f * (x >> kProbBits) + e.bias;
}
__device__ __forceinline__ uint32_t next_state(uint32_t e, uint32_t x) {
  return (e >> kProbBits) * (x >> kProbBits) + (e & kMask);
}

struct Freqs {
  int32_t f[kNsym];
};

// Shared-memory loads as volatile asm at shared addresses: each step's three
// loads are issued in this order (the table's first, it is on the chain)
// and unconditionally, so the compiler cannot sink the ring's word load
// into the branch of the steps that take a word, where it would lie on the
// chain.
__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t load_u32(unsigned a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void load_entry(unsigned a, WideEntry& e) {
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(e.f), "=r"(e.bias)
               : "r"(a));
}
__device__ __forceinline__ void load_entry(unsigned a, uint32_t& e) {
  e = load_u32(a);
}
__device__ __forceinline__ uint32_t load_u8(unsigned a) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}

// Each lane's ring of payload words in shared memory: kRing u16 words as
// kRing / 2 u32 pairs (low half first); pair p of thread j's ring lies at
// [p * kThreads + j], so the 32 lanes of a warp read 32 banks whatever
// pairs they are at.
constexpr int kRing = 128;
constexpr int kRingPairs = kRing / 2;
constexpr size_t kRingBytes = kRingPairs * kThreads * 4;
constexpr int kChunk = 8;                  // words a fetch: 4 pairs
// cp.async groups that may still be in flight when a group of steps
// starts: the words fetched at the last two group boundaries
constexpr int kInFlight = 2;

__device__ __forceinline__ void cp_async4(uint32_t* dst, const int32_t* src,
                                          bool in_row) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(shared_addr(dst)), "l"(src), "r"(in_row ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kGroups>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kGroups) : "memory");
}

// Fetches pairs q .. q+3 of a lane's row into its ring from word wq on (a
// multiple of 8), asynchronously; a pair outside [0, pairs) reads as 0.
__device__ __forceinline__ void fetch_chunk(uint32_t* ring, int wq,
                                            const int32_t* row, int pairs,
                                            long long q) {
  uint32_t* dst = ring + ((wq >> 1) & (kRingPairs - 1)) * kThreads;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool in_row = q + i >= 0 && q + i < pairs;
    cp_async4(dst + i * kThreads, in_row ? row + q + i : row, in_row);
  }
}

template <bool kVecOut>
__global__ void __launch_bounds__(kThreads)
a19_decode_kernel(const int32_t* __restrict__ payload, int pairs,
                  const uint32_t* __restrict__ states,
                  const int32_t* __restrict__ wptr0, Freqs fr, long long n,
                  int t_steps, int lanes, int lanes_per_block,
                  uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Entry* tab = reinterpret_cast<Entry*>(smem);
  uint8_t* sym = smem + kSlots * sizeof(Entry);

  const int j = threadIdx.x;
  const int lane = blockIdx.x * lanes_per_block + j;
  const bool decodes = j < lanes_per_block && lane < lanes;
  const int32_t* prow =
      payload + static_cast<size_t>(decodes ? lane : 0) * pairs;
  uint32_t* ring = reinterpret_cast<uint32_t*>(sym + kSlots) + j;
  // the ring's first kRing words, fetched while the table is built: chunk
  // k holds words 8k .. 8k+7 counted from pair q0 = floor(w0 / 8) * 4, so
  // the lane's first word is word w0 mod 8
  const int w0 = decodes ? wptr0[lane] : 0;
  long long q = static_cast<long long>(w0 >> 3) * 4;   // floor, also < 0
  int rp = w0 & 7;                          // next word to consume
  int wq = 0;                               // words fetched
  if (decodes) {
    for (; wq < kRing; wq += kChunk, q += 4)
      fetch_chunk(ring, wq, prow, pairs, q);
  }
  cp_async_commit();

  // the slot table: symbol s takes the slots [cum[s], cum[s+1]) below
  // 2^14, symbol 18 every slot from cum[18] up
  int c = 0;
#pragma unroll
  for (int s = 0; s < kNsym; ++s) {
    const int f = fr.f[s];
    const int lo = min(c, kSlots);
    const int hi = s + 1 < kNsym ? min(c + f, kSlots) : kSlots;
    for (int slot = lo + j; slot < hi; slot += kThreads) {
      tab[slot] = make_entry<Entry>(static_cast<uint32_t>(f),
                                    static_cast<uint32_t>(slot - c));
      sym[slot] = static_cast<uint8_t>(s);
    }
    c += f;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!decodes) return;

  uint8_t* orow = out + static_cast<size_t>(lane) * t_steps;
  const long long rem = n - static_cast<long long>(lane) * t_steps;
  const int len = rem <= 0 ? 0
                           : (rem >= t_steps ? t_steps
                                             : static_cast<int>(rem));
  uint32_t x = states[lane];

  // one step: one table load on the state's chain; the word load beside
  // it reads the ring at rp, which the previous step set
  const unsigned tab_at = shared_addr(tab), sym_at = shared_addr(sym);
  const unsigned ring_at = shared_addr(ring);
  auto step = [&]() -> uint32_t {
    const uint32_t slot = x & kMask;
    Entry e;
    load_entry(tab_at + slot * static_cast<unsigned>(sizeof(Entry)), e);
    const uint32_t pr = load_u32(
        ring_at + ((rp >> 1) & (kRingPairs - 1)) * (kThreads * 4));
    const uint32_t s = load_u8(sym_at + slot);
    const uint32_t xs = next_state(e, x);
    const uint32_t xr =
        __byte_perm(pr, xs, (rp & 1) ? kHighHalf : kLowHalf);
    const bool need = xs < kRansL;
    x = need ? xr : xs;
    rp += need;
    return s;
  };
  // before each group of kGroup steps (at most kGroup words): refill the
  // ring up to kRing words ahead, two chunks at most, and wait for the
  // fetches of all but the last kInFlight boundaries, which leaves at
  // least kRing - 2 * kChunk - kInFlight * 2 * kChunk >= kGroup words
  // landed ahead of rp
  auto boundary = [&]() {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (wq - rp <= kRing - kChunk) {
        fetch_chunk(ring, wq, prow, pairs, q);
        wq += kChunk;
        q += 4;
      }
    }
    cp_async_commit();
    cp_async_wait<kInFlight>();
  };

  int t = 0;
  for (; t + kGroup <= len; t += kGroup) {
    boundary();
    if constexpr (kVecOut) {
      uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int i = 0; i < kGroup; ++i) w[i >> 2] |= step() << (8 * (i & 3));
      *reinterpret_cast<uint4*>(orow + t) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        orow[t + i] = static_cast<uint8_t>(step());
    }
  }
  if (t < len) {                    // the group of the lane's last step
    boundary();
    if constexpr (kVecOut) {
      uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const uint32_t s = t + i < len ? step() : sym[x & kMask];
        w[i >> 2] |= s << (8 * (i & 3));
      }
      *reinterpret_cast<uint4*>(orow + t) = make_uint4(w[0], w[1], w[2], w[3]);
      t += kGroup;
    } else {
      for (; t < len; ++t) orow[t] = static_cast<uint8_t>(step());
    }
  }
  cp_async_wait<0>();
  // the held state's symbol for the rest
  const uint32_t h = sym[x & kMask];
  if constexpr (kVecOut) {
    const uint32_t v = h * 0x01010101u;
    for (; t < t_steps; t += kGroup)
      *reinterpret_cast<uint4*>(orow + t) = make_uint4(v, v, v, v);
  } else {
    for (; t < t_steps; ++t) orow[t] = static_cast<uint8_t>(h);
  }
}

constexpr size_t kSmemBytes = kTableBytes + kRingBytes;

template <bool kVecOut>
cudaError_t launch(int device, int blocks, cudaStream_t stream,
                   const int32_t* payload, int pairs, const uint32_t* states,
                   const int32_t* wptr, const Freqs& fr, long long n,
                   int t_steps, int lanes, int lanes_per_block,
                   uint8_t* out) {
  // the shared-memory opt-in, once per card (devices 0..63)
  static std::atomic<unsigned long long> opted{0};
  const unsigned long long bit = 1ull << (device & 63);
  if (!(opted.load() & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        a19_decode_kernel<kVecOut>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return err;
    opted.fetch_or(bit);
  }
  a19_decode_kernel<kVecOut><<<blocks, kThreads, kSmemBytes, stream>>>(
      payload, pairs, states, wptr, fr, n, t_steps, lanes, lanes_per_block,
      out);
  return cudaGetLastError();
}

}  // namespace

// Launches K4 on `stream`.  payload: int32 [L, pairs], pairs of u16 words
// (low half first); states uint32 [L]; wptr int32 [L], each lane's start
// word; freqs: 19 host ints in [0, 2^14) (the caller checks them); n: the
// stream's symbols; out uint8 [L * t_steps].  lanes_per_block in [1, 128]:
// lanes a block decodes.  Leaves the calling thread's current device as it
// was.  Returns the first CUDA error of the launch, or cudaGetLastError()
// after it.
extern "C" int dsrc_a19_decode(const void* payload, int pairs,
                               const void* states, const void* wptr,
                               const int* freqs, long long n, int t_steps,
                               int lanes, int lanes_per_block, void* out,
                               int device, void* stream) {
  if (lanes_per_block < 1 || lanes_per_block > kThreads || t_steps < 0 ||
      lanes < 0 || pairs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == 0 || t_steps == 0) return 0;
  Freqs fr;
  for (int s = 0; s < kNsym; ++s) fr.f[s] = freqs[s];
  const int blocks = (lanes + lanes_per_block - 1) / lanes_per_block;
  const bool vec_out = reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                       t_steps % kGroup == 0;
  const auto* pl = static_cast<const int32_t*>(payload);
  const auto* st = static_cast<const uint32_t*>(states);
  const auto* wp = static_cast<const int32_t*>(wptr);
  auto* o = static_cast<uint8_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dsrc::on_device(device, [&] {
    return vec_out ? launch<true>(device, blocks, s, pl, pairs, st, wp, fr,
                                  n, t_steps, lanes, lanes_per_block, o)
                   : launch<false>(device, blocks, s, pl, pairs, st, wp, fr,
                                   n, t_steps, lanes, lanes_per_block, o);
  }));
}
