// span_compact — the megakernel span's interior boundary: the stable
// valids-first pack of K live columns and the validity mask into C slots,
// and the pre-compaction valid count.
//
// Replaces the boundary work of the Pallas TPU span
// `repro/kernels/megakernel.py:_pallas_block_call` (lines 261-319,
// `pl.pallas_call` at 313), which packs each interior boundary inside one
// VMEM-resident whole-block call.  Hopper has no 128 MiB of on-chip memory
// to hold a span, so the packed columns go to device memory; what this
// kernel keeps from the TPU design is that only the live columns move and
// that the pack is one pass over the rows instead of the composed path's
// prefix sum + binary search + clamp + one gather per column.
//
// Semantics (= `MaskedBatch.compact(C)` on every slot): valid row r (its
// rank among valid rows) goes to slot r when r < C; slots at or past the
// valid count hold the last input row (the clamp of `scans.pack_indices`);
// valid' = slot < count; the count may exceed C (truncation) or be 0.
//
// Design: one launch of a persistent grid (blocks a multiprocessor × the
// multiprocessors, from the occupancy calculator) for up to 32 columns, in
// two phases.
//   1. Ranking.  A block takes 16,384-row tiles from an atomic ticket until
//      none is left, so tiles start in launch order and a look-back waits
//      only on running blocks.  Each of 256 threads turns its 64 mask bytes
//      (four 16-byte loads) into a bit mask and ranks its rows by popcount
//      and a warp shuffle scan; warp 0 publishes the tile's count, looks
//      back 128 tiles a step for the counts before it (single-pass scan
//      with decoupled look-back; counts are integers, so any order of
//      summing is exact) and publishes its inclusive count; then each
//      thread writes the source row of each of its valid rows ranked below
//      C into src[slot].  A block works a tile ahead: the next ticket is
//      taken while a tile is ranked, and the next tile's mask loads go out
//      before the index writes.
//   2. Moving.  Every block waits until every tile's src is written (a
//      count beside the ticket) and reads the total (the last tile's
//      inclusive count), then the grid moves the slots a column at a time, each
//      thread a stride of slots: slot s < min(count, C) from row src[s]
//      (four loads in flight before their stores), the slots past the
//      count from the last row (16-byte stores where aligned), and valid'.
//      Moving after the ranking spreads the moves over the whole grid:
//      a packed input, whose valid rows all sit in its first tile, would
//      otherwise leave them to one block.
// Columns move as raw words (8, 4, 2 or 1 bytes, several per row for a
// 2-D column), so every data-plane type is bit-exact.  The column
// descriptors travel as one by-value kernel parameter (under 1 KB of the
// 4 KB limit); past 32 columns the call launches once per group of 32,
// each launch writing the same valid' and count.
//
// Scratch, without a memset launch or a per-call allocation: a control
// block (ticket, done count, epoch, ranked count) and one 64-bit status
// word a tile, epoch (22 bits) | state (2) | count (40), published with
// one release store; src, C source rows, is a second cached buffer.  A
// status word counts only when it carries this launch's epoch; the last
// block to finish resets the counts and advances the epoch (on its wrap it
// zeroes the status words), so the state lives on the card.  (The count
// shares the word with the epoch, so the epoch has 22 bits and wraps every
// 4,194,303 calls; zeroing the words then needs every block finished,
// hence the done count, once a block at the end of a persistent grid.
// segmented_scan keeps its values apart from its status words and needs
// none.)  The wrapper caches the scratch per device and stream.
//
// Bound: bytes — the mask, the moved rows (and the last row) read once;
// the C slots of every column, valid' and the count written once.  The
// source-row index costs 16 bytes a moved row beyond that.
//
// Interface: plain C, loaded with ctypes.  Launches go on the caller's
// stream, do not synchronise, and the first launch error is returned.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;                       // mask bytes a thread
constexpr int kTile = kThreads * kRows;         // rows a tile
constexpr int kMaxK = 32;                       // columns a launch
constexpr int kUnroll = 4;                      // slots in flight a thread
constexpr int kLook = 4;                        // status words a lane reads a step
constexpr unsigned kSpinNs = 32;                // first back-off of a waiting lane
constexpr unsigned kSpinMaxNs = 256;
constexpr int kWindow = 32 * kLook;             // tiles a look-back step reads
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCountBits = 40;
constexpr unsigned long long kCountMask = (1ull << kCountBits) - 1;
constexpr unsigned kEpochMax = (1u << 22) - 1;

enum : unsigned { kInvalid = 0, kAggregate = 1, kPrefix = 2 };

struct Control {
  unsigned ticket, done, epoch, ranked;  // ranked: tiles whose src is written
};

// Scratch layout: Control (16 bytes), then status[tiles] (8 bytes each).
constexpr long long kFixedBytes = 16;
constexpr long long kTileBytes = 8;

struct Cols {
  const void* in[kMaxK];
  void* out[kMaxK];
  int wsz[kMaxK];  // bytes per word: 8, 4, 2 or 1
  int wpr[kMaxK];  // words per row
  int k;
};

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

// A thread's kRows mask bytes: 16-byte loads, issued a tile ahead of
// their use (`mask_bits`) where the rows are whole and aligned.
constexpr int kVecs = kRows / 16;
static_assert(kRows % 16 == 0 && kRows <= 64, "mask bits fit one word");

struct MaskWords {
  uint4 v[kVecs];
};

__device__ __forceinline__ bool whole(long long first, long long n, bool vec) {
  return vec && first + kRows <= n;
}

__device__ __forceinline__ MaskWords load_mask(const unsigned char* valid,
                                               long long first, long long n,
                                               bool vec) {
  MaskWords m{};
  if (whole(first, n, vec)) {
    const uint4* p = reinterpret_cast<const uint4*>(valid + first);
#pragma unroll
    for (int q = 0; q < kVecs; ++q) m.v[q] = p[q];
  }
  return m;
}

// bit j: row first + j is valid
__device__ __forceinline__ unsigned long long mask_bits(
    const unsigned char* valid, long long first, long long n, bool vec,
    const MaskWords& w) {
  unsigned long long m = 0;
  if (whole(first, n, vec)) {
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
      m |= (unsigned long long)(byte_bits(w.v[q].x) | byte_bits(w.v[q].y) << 4 |
                                byte_bits(w.v[q].z) << 8 |
                                byte_bits(w.v[q].w) << 12)
           << (16 * q);
    }
    return m;
  }
  for (int j = 0; j < kRows; ++j) {
    if (first + j < n && valid[first + j]) m |= 1ull << j;
  }
  return m;
}

__device__ __forceinline__ unsigned long long load_word(const void* p, int wsz,
                                                        long long i) {
  switch (wsz) {
    case 8: return static_cast<const unsigned long long*>(p)[i];
    case 4: return static_cast<const unsigned*>(p)[i];
    case 2: return static_cast<const unsigned short*>(p)[i];
    default: return static_cast<const unsigned char*>(p)[i];
  }
}

__device__ __forceinline__ void store_word(void* p, int wsz, long long i,
                                           unsigned long long w) {
  switch (wsz) {
    case 8: static_cast<unsigned long long*>(p)[i] = w; break;
    case 4: static_cast<unsigned*>(p)[i] = (unsigned)w; break;
    case 2: static_cast<unsigned short*>(p)[i] = (unsigned short)w; break;
    default: static_cast<unsigned char*>(p)[i] = (unsigned char)w; break;
  }
}

// out[s] = w (a word of wsz bytes) for s in [lo, hi), spread over the
// grid's threads (i0, i0 + stride, ...): 16 bytes a store where aligned,
// a word at a time at the two ends.
__device__ void fill_words(void* out, int wsz, unsigned long long w,
                           long long lo, long long hi, long long i0,
                           long long stride) {
  if (lo >= hi) return;
  unsigned char* base = static_cast<unsigned char*>(out);
  const long long b1 = hi * wsz;
  long long v0 = (long long)((((uintptr_t)(base + lo * wsz) + 15) & ~(uintptr_t)15) -
                             (uintptr_t)base);
  if (v0 > b1) v0 = b1;
  const long long v1 = v0 + (b1 - v0) / 16 * 16;
  for (long long s = lo + i0; s < v0 / wsz; s += stride) store_word(out, wsz, s, w);
  for (long long s = v1 / wsz + i0; s < hi; s += stride) store_word(out, wsz, s, w);
  unsigned long long p = w;  // the word repeated over 8 bytes
  if (wsz == 1) p = (w & 0xffull) * 0x0101010101010101ull;
  if (wsz == 2) p = (w & 0xffffull) * 0x0001000100010001ull;
  if (wsz == 4) p = (w & 0xffffffffull) * 0x0000000100000001ull;
  const uint4 q = make_uint4((unsigned)p, (unsigned)(p >> 32), (unsigned)p,
                             (unsigned)(p >> 32));
  for (long long o = v0 + 16 * i0; o < v1; o += 16 * stride) {
    *reinterpret_cast<uint4*>(base + o) = q;
  }
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

__global__ void __launch_bounds__(kThreads)
compact_lookback(const unsigned char* __restrict__ valid, long long n,
                 long long cap, const __grid_constant__ Cols cols,
                 unsigned char* __restrict__ valid_out,
                 long long* __restrict__ count_out,
                 unsigned char* __restrict__ scratch, long long tiles_cap,
                 long long* __restrict__ src) {
  __shared__ const void* s_in[kMaxK];
  __shared__ void* s_out[kMaxK];
  __shared__ int s_wsz[kMaxK];
  __shared__ int s_wpr[kMaxK];
  __shared__ int s_warp[kWarps];
  __shared__ long long s_base;  // the tile's first slot
  __shared__ long long s_total;
  __shared__ unsigned s_tile, s_epoch;
  __shared__ bool s_last;

  Control* ctl = reinterpret_cast<Control*>(scratch);
  unsigned long long* status =
      reinterpret_cast<unsigned long long*>(scratch + kFixedBytes);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = cols.k;
  const long long ntiles = (n + kTile - 1) / kTile;
  if (threadIdx.x < k) {
    s_in[threadIdx.x] = cols.in[threadIdx.x];
    s_out[threadIdx.x] = cols.out[threadIdx.x];
    s_wsz[threadIdx.x] = cols.wsz[threadIdx.x];
    s_wpr[threadIdx.x] = cols.wpr[threadIdx.x];
  }
  if (threadIdx.x == 0) {  // the ticket and the epoch in flight together
    const unsigned first = atomicAdd(&ctl->ticket, 1u);
    s_epoch = *reinterpret_cast<volatile unsigned*>(&ctl->epoch) + 1;
    s_tile = first;
  }
  const bool vec = (reinterpret_cast<uintptr_t>(valid) & 15) == 0;
  __syncthreads();
  const unsigned e = s_epoch;
  long long t = s_tile;
  MaskWords mw = load_mask(valid, t * kTile + threadIdx.x * kRows, n, vec);

  // 1. rank the tiles' valid rows: src[slot] = row for slots below C
  unsigned mine = 0;  // tiles this block ranked
  while (t < ntiles) {
    ++mine;
    const long long base = t * kTile;
    // the next tile's ticket, in flight while this tile is ranked
    unsigned next = 0;
    if (threadIdx.x == 0) next = atomicAdd(&ctl->ticket, 1u);
    const unsigned long long m =
        mask_bits(valid, base + threadIdx.x * kRows, n, vec, mw);
    const int c = __popcll(m);
    int x = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    int rank = x - c, count = 0;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) {
      if (j < warp) rank += s_warp[j];
      count += s_warp[j];
    }
    if (warp == 0) {
      if (lane == 0) {
        st_release(status + t, status_word(e, t == 0 ? kPrefix : kAggregate,
                                           count));
      }
      const long long before = t > 0 ? look_back(status, t, e) : 0;
      if (lane == 0) {
        if (t > 0) st_release(status + t, status_word(e, kPrefix, before + count));
        if (t == ntiles - 1) *count_out = before + count;
        s_base = before;
        s_tile = next;
      }
    }
    // (thread 0 writes s_base and s_tile again only after the next
    // tile's first barrier, which every thread reaches after reading them)
    __syncthreads();
    const long long tn = s_tile;
    long long slot = s_base + rank;
    // the next tile's mask loads go out before this tile's index writes
    mw = load_mask(valid, tn * kTile + threadIdx.x * kRows, n, vec);
    for (unsigned long long mm = m; mm && slot < cap; mm &= mm - 1) {
      src[slot++] = base + threadIdx.x * kRows + __ffsll(mm) - 1;
    }
    t = tn;
  }

  // every tile's src written (a tile publishes its prefix before it
  // writes src, so the total alone would not do), then the total: the
  // last tile's inclusive count
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(&ctl->ranked, mine);
    for (unsigned ns = kSpinNs; ld_relaxed(&ctl->ranked) < ntiles;) back_off(ns);
    __threadfence();
    s_total = (long long)(ld_relaxed(status + ntiles - 1) & kCountMask);
  }
  __syncthreads();
  __threadfence();
  const long long total = s_total;
  const long long moved = total < cap ? total : cap;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long i0 = (long long)blockIdx.x * kThreads + threadIdx.x;

  // 2. every block moves its share of the slots, a column at a time:
  // slots below the count from their rows, the rest from the last row
  for (int j = 0; j < k; ++j) {
    const void* in = s_in[j];
    void* out = s_out[j];
    const int wpr = s_wpr[j], wsz = s_wsz[j];
    if (wpr == 1) {
      for (long long s0 = i0; s0 < moved; s0 += stride * kUnroll) {
        unsigned long long w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long s = s0 + u * stride;
          if (s < moved) w[u] = load_word(in, wsz, __ldcg(src + s));
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long s = s0 + u * stride;
          if (s < moved) store_word(out, wsz, s, w[u]);
        }
      }
      fill_words(out, wsz, load_word(in, wsz, n - 1), moved, cap, i0, stride);
    } else {  // a 2-D column: its words in turn
      for (long long s = i0; s < cap; s += stride) {
        const long long r = s < moved ? __ldcg(src + s) : n - 1;
        for (int q = 0; q < wpr; ++q) {
          store_word(out, wsz, s * wpr + q, load_word(in, wsz, r * wpr + q));
        }
      }
    }
  }
  fill_words(valid_out, 1, 1, 0, moved, i0, stride);
  fill_words(valid_out, 1, 0, moved, cap, i0, stride);

  // the last block to finish resets the ticket and advances the epoch
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(&ctl->done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last) {
    if (e == kEpochMax) {
      for (long long i = threadIdx.x; i < tiles_cap; i += kThreads) status[i] = 0;
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      ctl->ticket = 0;
      ctl->done = 0;
      ctl->ranked = 0;
      ctl->epoch = e == kEpochMax ? 0 : e;
    }
  }
}

// Blocks a launch: as many as fit on the card at once, no more than the
// tiles or the tail need.
long long grid_size(long long ntiles, long long cap, cudaError_t* err) {
  static int per_sm[64], sms[64];  // by device, 0 until asked
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev >= 64) dev = 63;
  if (per_sm[dev] == 0) {
    int b = 0, m = 0;
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, compact_lookback,
                                                         kThreads, 0);
    if (*err == cudaSuccess) {
      *err = cudaDeviceGetAttribute(&m, cudaDevAttrMultiProcessorCount, dev);
    }
    if (*err != cudaSuccess) return 0;
    sms[dev] = m;
    per_sm[dev] = b > 0 ? b : 1;
  }
  const long long fit = (long long)per_sm[dev] * sms[dev];
  const long long tail = (cap + kTile - 1) / kTile;
  const long long want = ntiles > tail ? ntiles : tail;
  return want < fit ? want : fit;
}

}  // namespace

// [rows a tile, fixed scratch bytes, scratch bytes a tile]: the wrapper
// sizes the scratch from these once.
extern "C" void repro_span_compact_layout(long long* out) {
  out[0] = kTile;
  out[1] = kFixedBytes;
  out[2] = kTileBytes;
}

// valid [n] bytes (n >= 1); k >= 0 columns, column j described by desc[4j
// .. 4j+3] = (input pointer, output pointer, bytes a word, words a row):
// a row-major [n, ...] array packed into [cap, ...]; valid_out [cap]
// bytes; count: the valid count (int64); scratch: `bytes` bytes, zeroed
// once before its first use, at least the layout's size for n rows; src:
// cap int64 (each slot's source row, any contents); one call at a time
// may use scratch and src.
extern "C" int repro_span_compact(const unsigned char* valid, long long n,
                                  int k, const long long* desc, long long cap,
                                  unsigned char* valid_out, long long* count,
                                  void* scratch, long long bytes,
                                  long long* src, void* stream) {
  if (n < 1 || cap < 1 || k < 0 || n > (long long)kCountMask) {
    return (int)cudaErrorInvalidValue;
  }
  const long long ntiles = (n + kTile - 1) / kTile;
  const long long tiles_cap = (bytes - kFixedBytes) / kTileBytes;
  if (tiles_cap < ntiles) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const long long grid = grid_size(ntiles, cap, &err);
  if (grid < 1) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  // one launch per group of kMaxK columns (one for k = 0: it still writes
  // valid_out and the count)
  for (int g = 0; g == 0 || g < k; g += kMaxK) {
    Cols cols{};
    cols.k = k - g < kMaxK ? k - g : kMaxK;
    for (int j = 0; j < cols.k; ++j) {
      const long long* d = desc + 4 * (g + j);
      cols.in[j] = reinterpret_cast<const void*>(d[0]);
      cols.out[j] = reinterpret_cast<void*>(d[1]);
      cols.wsz[j] = (int)d[2];
      cols.wpr[j] = (int)d[3];
    }
    compact_lookback<<<(unsigned)grid, kThreads, 0, s>>>(
        valid, n, cap, cols, valid_out, count,
        static_cast<unsigned char*>(scratch), tiles_cap, src);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
