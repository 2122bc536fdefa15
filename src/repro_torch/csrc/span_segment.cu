// span_segment — segment numbering of a packed, key-ordered batch inside a
// megakernel span: is_start, seg = max(cumsum(is_start) - 1, 0) and the
// group count.
//
// Replaces the segmentation step of the Pallas TPU span
// `repro/kernels/megakernel.py:_pallas_block_call` (lines 261-319,
// `pl.pallas_call` at 313): a Reduce whose input the span just packed
// segments with adjacent-slot compares (`masked._segments_contiguous`)
// inside the VMEM-resident block.  On Hopper the packed batch sits in
// device memory; this kernel replaces the composed path's gap-tolerant
// walk (a prefix sum, a binary search, two gathers and a key gather per
// key column) and the separate group-count reduction with one pass.
//
// Semantics (= `_segments_contiguous` on every slot, for any mask): slot i
// starts a segment when it is valid and is slot 0, or slot i-1 is invalid,
// or some key differs from slot i-1's (`!=`: float keys compare as IEEE
// values, so -0.0 equals 0.0 and NaN differs from itself, as in torch).
//
// Bound: bytes — the mask and the keys of the valid rows read once (an
// invalid slot's flag does not depend on its keys), seg (int64) and
// is_start written once, and the count.  seg is 8 of the 9 bytes written
// a slot, so the bound falls little with the valid count: at q15's first
// call (1,048,576 rows, 239,603 valid, one int64 key) 12.4 MB, 3.7 us at
// 3.35 TB/s.
//
// Design: one launch a call for up to 32 keys.  A block of 256 threads
// takes a 4,096-row tile from an atomic ticket, so that tiles start in
// launch order and a look-back waits only on running blocks; each thread
// owns 16 consecutive rows of it.
//   1. Flags.  Each thread turns its 16 mask bytes (one 16-byte load; lane
//      0 loads the byte before with it) into a bit mask.  Only a row whose
//      predecessor is valid too has its flag decided by the keys, and
//      only for such rows are keys read, a key at a time until none is
//      left open (`key_pass`: staged in shared memory by asynchronous
//      copies spread over the threads, then read back and compared by
//      each row's owner).  A tile with no valid row reads no key.
//   2. Ranking.  popc of the start bits, a warp shuffle scan and one
//      barrier give each thread its rank in the tile and warp 0 the tile's
//      count; warp 0 publishes it, looks back over the tiles before for
//      their counts (span_lookback.cuh: 128 status words a step, waiting
//      only for tiles newer than the nearest published prefix; counts are
//      integers, so any order of summing is exact) and publishes its
//      inclusive count.  The last tile writes the group count.
//   3. Writing.  Each thread writes its 16 is_start flags (one 16-byte
//      store) before the look-back; after it a whole tile writes seg as
//      row pairs spread over the threads (a thread reads the pair's
//      owner's flags and rank from shared memory).
// So each warp's global loads and stores cover contiguous bytes (the keys
// are read, and seg written, by threads spread over the tile rather than
// by the rows' owners), and the keys in flight take no registers, so that
// four blocks fit on a multiprocessor.
// Keys travel as one by-value kernel parameter (32 pointers and kinds).
// Past 32 keys, and only there, the call makes more than one launch:
// `key_differs` first ORs each group of 32 keys' slot-to-slot differences
// into one byte flag a slot, and the look-back launch reads that flag as
// its only key.
//
// Scratch, without a memset launch or a per-call allocation: a control
// block (ticket, done count, epoch) and one status word a tile
// (span_lookback.cuh); the last block to finish resets the ticket and the
// done count and advances the epoch.
//
// Interface: plain C, loaded with ctypes.  Launches go on the caller's
// stream, do not synchronise, and the first launch error is returned.

#include <cuda_runtime.h>

#include <cstdint>

#include "span_lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                       // rows a thread
constexpr int kTile = kThreads * kRows;         // rows a tile
constexpr int kMaxK = 32;                       // keys a launch
constexpr unsigned kAll = (1u << kRows) - 1;

// kFlag: a byte per slot that already says whether slot i's keys differ
// from slot i-1's (the output of key_differs)
enum { kI64 = 0, kI32 = 1, kI16 = 2, kI8 = 3, kF64 = 4, kF32 = 5, kFlag = 6 };

struct Control {
  unsigned ticket, done, epoch, unused;
};

// Scratch layout: Control (16 bytes), then status[tiles] (8 bytes each).
constexpr long long kFixedBytes = 16;
constexpr long long kTileBytes = 8;

struct Keys {
  const void* key[kMaxK];
  int kind[kMaxK];
  int k;
};

// A key's value at slot i as raw bits (zero-extended).
__device__ __forceinline__ unsigned long long load_key(const void* p, int kind,
                                                       long long i) {
  switch (kind) {
    case kI64:
    case kF64: return static_cast<const unsigned long long*>(p)[i];
    case kI32:
    case kF32: return static_cast<const unsigned*>(p)[i];
    case kI16: return static_cast<const unsigned short*>(p)[i];
    default: return static_cast<const unsigned char*>(p)[i];
  }
}

// An asynchronous copy of B = 4, 8 or 16 bytes from global to shared
// memory (no register holds the data), and the wait for all of a thread's.
template <int B>
__device__ __forceinline__ void copy_async(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (B == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
                 "l"(gmem) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(dst),
                 "l"(gmem), "n"(B) : "memory");
  }
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// How key_pass compares: raw bits (integers), IEEE values, or a flag that
// already holds the compare with the row before.
enum Compare { kBits, kDouble, kFloat, kFlagged };

template <int cmp, typename T>
__device__ __forceinline__ bool ne(T a, T b) {
  if constexpr (cmp == kDouble) {
    return __longlong_as_double((long long)a) !=
           __longlong_as_double((long long)b);
  } else if constexpr (cmp == kFloat) {
    return __int_as_float((int)a) != __int_as_float((int)b);
  } else {
    return a != b;
  }
}

// ne for a key kind known only at run time (the flag pass)
__device__ __forceinline__ bool differ(int kind, unsigned long long a,
                                       unsigned long long b) {
  if (kind == kF64) return ne<kDouble>(a, b);
  if (kind == kF32) return ne<kFloat>((unsigned)a, (unsigned)b);
  return a != b;
}

// row r's key in a 16-byte word of 16 / sizeof(T) keys
template <typename T>
__device__ __forceinline__ T unpack(const uint4& w, int r) {
  const unsigned c[4] = {w.x, w.y, w.z, w.w};
  const int b = r * (int)sizeof(T);  // byte offset in the word
  if constexpr (sizeof(T) == 8) {
    return (T)(c[b / 4] | (unsigned long long)c[b / 4 + 1] << 32);
  } else {
    return (T)(c[b / 4] >> (8 * (b % 4)));
  }
}

// The slot of 16-byte chunk c of a tile's keys in shared memory: an
// owner's C = sizeof(T) chunks keep their slots but are XOR-permuted, so
// that eight lanes reading their owners' j-th chunks (or writing eight
// consecutive chunks) touch eight different groups of banks.
template <typename T>
__device__ __forceinline__ int chunk_slot(int c) {
  constexpr int C = sizeof(T);
  const int o = c / C, j = c % C;
  return o * C + (j ^ ((o / (8 / C)) & (C - 1)));
}

// One key's compares over a tile.  The rows whose flag the keys still
// decide are open in `s_need` (16 bits an owner thread, bit j: row
// 16 * owner + j; `need` this thread's).  A row's key is wanted when its
// flag or the next row's is open (both rows are then valid), and only
// wanted keys are read:
//   1. into shared memory `s_key`, by asynchronous copies spread over the
//      threads so that a warp's copies cover contiguous bytes: 16 bytes
//      at a time where all of a 16-byte chunk is wanted, else a row at a
//      time (one- and two-byte keys through registers);
//   2. each thread reads its own 16 rows back (16-byte loads) and the row
//      before them (the tile's first row: the row before the tile, one
//      global load) and returns the open rows that differ from the row
//      before.
// A flag key (`kFlagged`) already holds the compare with the row before.
// Called by every thread of the block.
template <typename T, int cmp>
__device__ __forceinline__ unsigned key_pass(const void* p, long long base,
                                             unsigned need,
                                             const unsigned short* s_need,
                                             unsigned char* s_bytes) {
  constexpr bool is_flag = cmp == kFlagged;
  constexpr int C = sizeof(T);               // chunks an owner's rows take
  constexpr int V = 16 / C;                  // rows a chunk
  constexpr unsigned kChunk = (1u << V) - 1;
  const int tid = threadIdx.x;
  T* s_key = reinterpret_cast<T*>(s_bytes);
  const T* q = static_cast<const T*>(p) + base;
  const bool aligned = (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  T first_prev = 0;  // the row before the tile, for thread 0
  if (!is_flag && tid == 0 && (need & 1u)) first_prev = q[-1];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int c = i * kThreads + tid;  // the chunk
    const int row = c * V;             // its first row in the tile
    const unsigned open = (s_need[row / kRows] >> (row % kRows)) & kChunk;
    unsigned want = open;
    if (!is_flag) {
      want |= open >> 1;
      const int next = row + V;
      if (next < kTile) {
        want |= ((s_need[next / kRows] >> (next % kRows)) & 1u) << (V - 1);
      }
    }
    T* dst = s_key + chunk_slot<T>(c) * V;
    if (want == kChunk && aligned) {
      copy_async<16>(dst, q + row);
    } else if (want) {
#pragma unroll
      for (int r = 0; r < V; ++r) {
        if (want >> r & 1) {
          if constexpr (C >= 4) {
            copy_async<C>(dst + r, q + row + r);
          } else {
            dst[r] = q[row + r];
          }
        }
      }
    }
  }
  copy_wait();
  __syncthreads();
  unsigned d = 0;
  T prev = tid ? s_key[chunk_slot<T>(C * tid - 1) * V + V - 1] : first_prev;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const uint4 w =
        *reinterpret_cast<const uint4*>(s_key + chunk_slot<T>(C * tid + j) * V);
#pragma unroll
    for (int r = 0; r < V; ++r) {
      const T a = unpack<T>(w, r);
      if constexpr (is_flag) {
        d |= (unsigned)(a != 0) << (j * V + r);
      } else {
        d |= (unsigned)ne<cmp>(a, prev) << (j * V + r);
        prev = a;
      }
    }
  }
  return d & need;
}

// A thread's 16 mask bytes (one 16-byte load where whole and aligned) and,
// for lane 0, the byte of the row before them, loaded together.
struct MaskLoad {
  uint4 w;
  unsigned prev;  // lane 0: row r0 - 1 is valid
};

__device__ __forceinline__ bool whole(const unsigned char* valid, long long r0,
                                      long long n) {
  return r0 + kRows <= n && (reinterpret_cast<uintptr_t>(valid + r0) & 15) == 0;
}

__device__ __forceinline__ MaskLoad load_mask(const unsigned char* valid,
                                              long long r0, long long n) {
  MaskLoad m{};
  if (whole(valid, r0, n)) m.w = *reinterpret_cast<const uint4*>(valid + r0);
  if ((threadIdx.x & 31) == 0 && r0 > 0 && r0 <= n) m.prev = valid[r0 - 1];
  return m;
}

// bit j: row r0 + j is valid
__device__ __forceinline__ unsigned mask_bits(const unsigned char* valid,
                                              long long r0, long long n,
                                              const MaskLoad& m) {
  if (whole(valid, r0, n)) {
    return byte_bits(m.w.x) | byte_bits(m.w.y) << 4 | byte_bits(m.w.z) << 8 |
           byte_bits(m.w.w) << 12;
  }
  unsigned bits = 0;
  for (int j = 0; j < kRows; ++j) {
    if (r0 + j < n && valid[r0 + j]) bits |= 1u << j;
  }
  return bits;
}

// row j's seg: the starts up to and including it, less one, floored at 0
__device__ __forceinline__ long long seg_of(long long run, unsigned bits,
                                            int j) {
  const long long inc = run + __popc(bits & ((2u << j) - 1));
  return inc > 0 ? inc - 1 : 0;
}

// is_start of this thread's rows (bit j: row r0 + j): one 16-byte store
// where whole and aligned, four flags a word
__device__ __forceinline__ void write_starts(unsigned char* start,
                                            long long r0, long long n,
                                            unsigned bits) {
  if (r0 + kRows <= n && (reinterpret_cast<uintptr_t>(start + r0) & 15) == 0) {
    uint4 f;
    f.x = ((bits & 0xfu) * 0x00204081u) & 0x01010101u;
    f.y = ((bits >> 4 & 0xfu) * 0x00204081u) & 0x01010101u;
    f.z = ((bits >> 8 & 0xfu) * 0x00204081u) & 0x01010101u;
    f.w = ((bits >> 12 & 0xfu) * 0x00204081u) & 0x01010101u;
    *reinterpret_cast<uint4*>(start + r0) = f;
    return;
  }
  for (int j = 0; j < kRows && r0 + j < n; ++j) start[r0 + j] = bits >> j & 1;
}

// The tile's seg.  Thread t owns rows t*16 .. t*16+15 of the tile:
// `s_bits[t]` their flags, `before + s_rank[t]` the starts before them.  A
// whole, aligned tile is written as row pairs spread over the threads, so
// that each warp store covers 512 contiguous bytes; a partial tile as each
// thread's own rows.
__device__ __forceinline__ void write_seg(long long* seg, long long base,
                                         long long n, long long before,
                                         const unsigned short* s_bits,
                                         const int* s_rank) {
  const int tid = threadIdx.x;
  if (base + kTile <= n && (reinterpret_cast<uintptr_t>(seg + base) & 15) == 0) {
#pragma unroll
    for (int i = 0; i < kRows / 2; ++i) {
      const int p = i * kThreads + tid;     // the pair: rows 2p, 2p + 1
      const int o = 2 * p / kRows;          // their owner
      const int j = (2 * p) % kRows;        // the first one's bit
      const long long run = before + s_rank[o];
      const unsigned bits = s_bits[o];
      reinterpret_cast<longlong2*>(seg + base)[p] =
          make_longlong2(seg_of(run, bits, j), seg_of(run, bits, j + 1));
    }
    return;
  }
  const long long r0 = base + (long long)tid * kRows;
  const long long run = before + s_rank[tid];
  for (int j = 0; j < kRows && r0 + j < n; ++j) {
    seg[r0 + j] = seg_of(run, s_bits[tid], j);
  }
}

// At most 64 registers a thread, so that 4 blocks share a multiprocessor
// (35 KB of shared memory each): fewer blocks leave the latency of the
// ticket, the mask, the keys and the look-back exposed on large calls,
// fewer registers spill.
__global__ void __launch_bounds__(kThreads, 4)
segment_lookback(const __grid_constant__ Keys keys,
                 const unsigned char* __restrict__ valid, long long n,
                 long long* __restrict__ seg, unsigned char* __restrict__ start,
                 long long* __restrict__ count_out,
                 unsigned char* __restrict__ scratch, long long tiles_cap) {
  __shared__ int s_warp[kWarps];
  __shared__ unsigned short s_need[kThreads];  // flags the keys still decide
  __shared__ __align__(16) unsigned char s_key[kTile * 8];  // a key's rows
  __shared__ unsigned short s_bits[kThreads];  // each thread's start flags
  __shared__ int s_rank[kThreads];  // the starts before them in the tile
  __shared__ long long s_before;  // the starts before the tile
  __shared__ unsigned s_tile, s_epoch;
  __shared__ bool s_last;

  Control* ctl = reinterpret_cast<Control*>(scratch);
  unsigned long long* status =
      reinterpret_cast<unsigned long long*>(scratch + kFixedBytes);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {  // the ticket and the epoch in flight together
    const unsigned tile = atomicAdd(&ctl->ticket, 1u);
    s_epoch = *reinterpret_cast<volatile unsigned*>(&ctl->epoch) + 1;
    s_tile = tile;
  }
  __syncthreads();
  const unsigned e = s_epoch;
  const long long t = s_tile;
  const long long ntiles = (n + kTile - 1) / kTile;
  const long long base = t * kTile;
  const long long r0 = base + (long long)threadIdx.x * kRows;

  // 1. the start flags of this thread's rows
  const MaskLoad ml = load_mask(valid, r0, n);
  const unsigned vm = mask_bits(valid, r0, n, ml);
  unsigned prev = __shfl_up_sync(kFull, vm >> (kRows - 1), 1) & 1u;
  if (lane == 0) prev = ml.prev != 0;
  // valid rows with a valid predecessor: their keys decide, a key at a
  // time until none is left open
  unsigned need = vm & ((vm << 1) | prev) & kAll;
  for (int j = 0; j < keys.k; ++j) {
    s_need[threadIdx.x] = (unsigned short)need;
    if (!__syncthreads_or(need != 0)) break;
    const void* p = keys.key[j];
    unsigned d;
    switch (keys.kind[j]) {
      case kI64: d = key_pass<unsigned long long, kBits>(p, base, need, s_need, s_key); break;
      case kF64: d = key_pass<unsigned long long, kDouble>(p, base, need, s_need, s_key); break;
      case kI32: d = key_pass<unsigned, kBits>(p, base, need, s_need, s_key); break;
      case kF32: d = key_pass<unsigned, kFloat>(p, base, need, s_need, s_key); break;
      case kI16: d = key_pass<unsigned short, kBits>(p, base, need, s_need, s_key); break;
      case kFlag: d = key_pass<unsigned char, kFlagged>(p, base, need, s_need, s_key); break;
      default: d = key_pass<unsigned char, kBits>(p, base, need, s_need, s_key); break;
    }
    need &= ~d;
  }
  const unsigned starts = vm & ~need;
  write_starts(start, r0, n, starts);

  // 2. rank them: in the warp, in the tile, then across tiles
  const int c = __popc(starts);
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
  s_bits[threadIdx.x] = (unsigned short)starts;
  s_rank[threadIdx.x] = rank;
  if (warp == 0) {
    if (lane == 0) {
      st_release(status + t,
                 status_word(e, t == 0 ? kPrefix : kAggregate, count));
    }
    const long long before = t > 0 ? look_back(status, t, e) : 0;
    if (lane == 0) {
      if (t > 0) st_release(status + t, status_word(e, kPrefix, before + count));
      if (t == ntiles - 1) *count_out = before + count;
      s_before = before;
    }
  }
  __syncthreads();

  // 3. seg of every row
  write_seg(seg, t * kTile, n, s_before, s_bits, s_rank);

  // The last block to finish resets the ticket and advances the epoch.
  // (No fence first: every block's ticket, epoch and status reads are
  // consumed before its done count goes up.)
  if (threadIdx.x == 0) s_last = atomicAdd(&ctl->done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (s_last) {
    if (e == kEpochMax) {
      for (long long i = threadIdx.x; i < tiles_cap; i += kThreads) status[i] = 0;
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      ctl->ticket = 0;
      ctl->done = 0;
      ctl->epoch = e == kEpochMax ? 0 : e;
    }
  }
}

// flags[i] |= some key of this group differs between slots i-1 and i (the
// first group writes every flag, later ones only set); slot 0 gets 0.
// Only a call with more than kMaxK keys launches it.
__global__ void key_differs(const __grid_constant__ Keys keys, long long n,
                            bool first, unsigned char* __restrict__ flags) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    bool d = false;
    for (int j = 0; j < keys.k && i > 0 && !d; ++j) {
      d = differ(keys.kind[j], load_key(keys.key[j], keys.kind[j], i),
                 load_key(keys.key[j], keys.kind[j], i - 1));
    }
    if (first) flags[i] = d;
    else if (d) flags[i] = 1;
  }
}

}  // namespace

// [rows a tile, fixed scratch bytes, scratch bytes a tile]: the wrapper
// sizes the scratch from these once.
extern "C" void repro_span_segment_layout(long long* out) {
  out[0] = kTile;
  out[1] = kFixedBytes;
  out[2] = kTileBytes;
}

// k >= 0 key columns, key j described by desc[2j], desc[2j+1] = (pointer
// to [n] values, kind: 0 int64, 1 int32, 2 int16, 3 one-byte integer or
// bool, 4 float64, 5 float32); valid [n] bytes (n >= 1); outputs seg [n]
// int64, start [n] bytes, count: the number of starts (int64); scratch:
// `bytes` bytes, zeroed once before its first use, at least the layout's
// size for n rows; flags: n bytes (any contents) when k > 32, else unused;
// one call at a time may use scratch and flags.
extern "C" int repro_span_segment(int k, const long long* desc,
                                  const unsigned char* valid, long long n,
                                  long long* seg, unsigned char* start,
                                  long long* count, void* scratch,
                                  long long bytes, unsigned char* flags,
                                  void* stream) {
  const long long ntiles = (n + kTile - 1) / kTile;
  const long long tiles_cap = (bytes - kFixedBytes) / kTileBytes;
  if (n < 1 || k < 0 || n > (long long)kCountMask || tiles_cap < ntiles ||
      (k > kMaxK && flags == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int j = 0; j < k; ++j) {
    if (desc[2 * j + 1] < kI64 || desc[2 * j + 1] > kF32) {
      return (int)cudaErrorInvalidValue;
    }
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  Keys keys{};
  if (k <= kMaxK) {
    keys.k = k;
    for (int j = 0; j < k; ++j) {
      keys.key[j] = reinterpret_cast<const void*>(desc[2 * j]);
      keys.kind[j] = (int)desc[2 * j + 1];
    }
  } else {  // the flag pass: the one case with more than one launch
    const long long want = (n + kThreads - 1) / kThreads;
    const unsigned grid = (unsigned)(want < 8192 ? want : 8192);
    for (int g = 0; g < k; g += kMaxK) {
      Keys grp{};
      grp.k = k - g < kMaxK ? k - g : kMaxK;
      for (int j = 0; j < grp.k; ++j) {
        grp.key[j] = reinterpret_cast<const void*>(desc[2 * (g + j)]);
        grp.kind[j] = (int)desc[2 * (g + j) + 1];
      }
      key_differs<<<grid, kThreads, 0, s>>>(grp, n, g == 0, flags);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    keys.k = 1;
    keys.key[0] = flags;
    keys.kind[0] = kFlag;
  }
  segment_lookback<<<(unsigned)ntiles, kThreads, 0, s>>>(
      keys, valid, n, seg, start, count, static_cast<unsigned char*>(scratch),
      tiles_cap);
  return (int)cudaGetLastError();
}
