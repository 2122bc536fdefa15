// span_lookback.cuh — the tile-status machinery of the span kernels'
// single-pass scans with decoupled look-back (span_compact.cu,
// span_segment.cu): both rank rows across tiles by an integer count, so the
// look-back may sum in any order.
//
// Each tile has one 64-bit status word, epoch (22 bits) | state (2) |
// count (40), published with one release store: first the tile's own count
// (kAggregate), then the count of every row up to its end (kPrefix); tile
// 0 publishes its prefix at once.  A word counts only when it carries the
// launch's epoch, so the words need no memset between launches: the
// kernel's last block advances the epoch on the card (and zeroes the words
// when it wraps, every 4,194,303 calls), and the wrapper keeps the scratch
// per device and stream.
//
// What else is here: relaxed and release accesses, the waiting lanes'
// back-off, the bit mask of four mask bytes and a warp sum.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kLook = 4;                        // status words a lane reads a step
constexpr int kWindow = 32 * kLook;             // tiles a look-back step reads
constexpr unsigned kSpinNs = 32;                // first back-off of a waiting lane
constexpr unsigned kSpinMaxNs = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCountBits = 40;
constexpr unsigned long long kCountMask = (1ull << kCountBits) - 1;
constexpr unsigned kEpochMax = (1u << 22) - 1;

enum : unsigned { kInvalid = 0, kAggregate = 1, kPrefix = 2 };

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A waiting lane sleeps between reads, longer each time (up to 256 ns),
// so that spinning warps do not crowd the cache lines that the tiles
// they wait for are publishing to.
__device__ __forceinline__ void back_off(unsigned& ns) {
  __nanosleep(ns);
  ns = ns < kSpinMaxNs ? 2 * ns : kSpinMaxNs;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long status_word(unsigned e,
                                                          unsigned state,
                                                          long long count) {
  return ((unsigned long long)e << (kCountBits + 2)) |
         ((unsigned long long)state << kCountBits) |
         (unsigned long long)count;
}

__device__ __forceinline__ unsigned status_epoch(unsigned long long w) {
  return (unsigned)(w >> (kCountBits + 2));
}

__device__ __forceinline__ unsigned status_state(unsigned long long w) {
  return (unsigned)(w >> kCountBits) & 3u;
}

// the low bit of each byte of w, set where the byte is nonzero
__device__ __forceinline__ unsigned byte_bits(unsigned w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

__device__ __forceinline__ long long warp_sum(long long x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
  return x;
}

// The valid rows before tile t > 0: the published counts back to the
// nearest inclusive prefix.  Called by all of warp 0, which reads 128
// status words a step (four a lane, relaxed loads in flight together),
// newest first.  Only the tiles from t-1 down to that prefix must have
// published: the walk waits for no older tile, so a tile does not wait for
// the slowest of its window's mask loads.  Tile 0 always publishes its
// prefix at once.
__device__ long long look_back(const unsigned long long* status, long long t,
                               unsigned e) {
  const int lane = threadIdx.x & 31;
  long long sum = 0;
  for (long long lo = t - kWindow;; lo -= kWindow) {
    unsigned long long w[kLook];
#pragma unroll
    for (int i = 0; i < kLook; ++i) {
      const long long j = lo + 32 * i + lane;
      w[i] = j >= 0 ? ld_relaxed(status + j) : 0;
    }
    for (unsigned ns = kSpinNs;;) {
      long long prefix = -1, waiting = -1;  // newest of each, this lane
#pragma unroll
      for (int i = 0; i < kLook; ++i) {
        const long long j = lo + 32 * i + lane;
        if (j < 0) continue;
        if (status_epoch(w[i]) != e || status_state(w[i]) == kInvalid) {
          waiting = j;
        } else if (status_state(w[i]) == kPrefix) {
          prefix = j;
        }
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        const long long p = __shfl_xor_sync(kFull, prefix, d);
        const long long q = __shfl_xor_sync(kFull, waiting, d);
        prefix = p > prefix ? p : prefix;
        waiting = q > waiting ? q : waiting;
      }
      if (waiting < prefix || (waiting < 0 && prefix < 0)) {
        long long part = 0;  // the prefix and the counts after it
#pragma unroll
        for (int i = 0; i < kLook; ++i) {
          const long long j = lo + 32 * i + lane;
          if (j >= 0 && j >= prefix) part += (long long)(w[i] & kCountMask);
        }
        sum += warp_sum(part);
        if (prefix >= 0 || lo <= 0) return sum;
        break;  // all published, none a prefix: the window before
      }
      back_off(ns);
#pragma unroll
      for (int i = 0; i < kLook; ++i) {
        const long long j = lo + 32 * i + lane;
        if (j >= 0 &&
            (status_epoch(w[i]) != e || status_state(w[i]) == kInvalid)) {
          w[i] = ld_relaxed(status + j);
        }
      }
    }
  }
}

}  // namespace
