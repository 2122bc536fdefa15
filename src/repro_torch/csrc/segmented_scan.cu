// segmented_scan — inclusive segmented add/max/min scan with reset flags,
// and its segment_reduce entry (each segment's last row, scattered to its id).
//
// Replaces the Pallas TPU kernel `repro/kernels/segmented_scan.py:
// segmented_scan` (`pl.pallas_call` at line 83).  The TPU form walks
// 512-row blocks in grid order and carries the running value in VMEM from
// one grid step to the next.  Hopper runs blocks in parallel and in no
// order, so the carry becomes a reduce-then-scan over 2048-row tiles:
//
//   1. tile_reduce  — each block computes its tile's segmented aggregate
//                     (value after the tile's last reset, any-reset flag);
//   2. tile_carries — one block scans the tile aggregates into each tile's
//                     carry-in (exclusive, resets respected);
//   3. tile_apply   — each block rescans its tile seeded with its carry-in
//                     and writes either the full scan or, for
//                     segment_reduce, only each segment's last row.
//
// Inside a tile, 256 threads take 8 rounds of 256 consecutive rows (so
// every load is coalesced); a round is a warp-shuffle scan plus one pass
// over the 8 warp totals, with the running carry folded in.  Values stay in
// their native type (int64 or float64): integer sums are exact, unlike the
// TPU wrapper's float32 cast.  The combine is the
// classic segmented one, (v1,f1)·(v2,f2) = (f2 ? v2 : v1∘v2, f1|f2), and
// rows before the first flag form one open segment seeded with the op
// identity, as in the reference.
//
// Bound: bytes.  The work is one read of values and flags and one write;
// this design reads values twice (phases 1 and 3), which a single-pass
// decoupled look-back would avoid — left for a later change.
//
// Interface: plain C, loaded with ctypes.  Launches go on the caller's
// stream, do not synchronise, and the first launch error is returned.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;
constexpr long long kTile = (long long)kThreads * kRounds;
constexpr int kMaxC = 4;
constexpr unsigned kFull = 0xffffffffu;

enum { kAdd = 0, kMax = 1, kMin = 2 };

template <typename T> struct Bounds;
template <> struct Bounds<long long> {
  __device__ static long long lo() { return LLONG_MIN; }
  __device__ static long long hi() { return LLONG_MAX; }
};
template <> struct Bounds<double> {
  __device__ static double lo() { return -__longlong_as_double(0x7ff0000000000000LL); }
  __device__ static double hi() { return __longlong_as_double(0x7ff0000000000000LL); }
};

template <int OP, typename T>
__device__ __forceinline__ T identity() {
  if (OP == kAdd) return T(0);
  if (OP == kMax) return Bounds<T>::lo();
  return Bounds<T>::hi();
}

template <int OP, typename T>
__device__ __forceinline__ T combine(T a, T b) {
  if (OP == kAdd) return a + b;
  if (OP == kMax) return a > b ? a : b;
  return a < b ? a : b;
}

// Shared state of one block: warp totals and the running carry.
template <typename T>
struct Shared {
  T warp_v[kWarps][kMaxC];
  int warp_f[kWarps];
  T carry_v[kMaxC];
  int carry_f;
};

// Inclusive segmented scan of one row per thread across the block, folded
// onto the running carry (cv, cf), which it then advances to the block's
// last row.  Ends with every thread past its reads of `sh`.
template <int OP, typename T>
__device__ __forceinline__ void block_round(T (&v)[kMaxC], int& f, int C,
                                            T (&cv)[kMaxC], int& cf,
                                            Shared<T>& sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int of = __shfl_up_sync(kFull, f, d);
    T ov[kMaxC];
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c < C) ov[c] = __shfl_up_sync(kFull, v[c], d);
    }
    if (lane >= d) {
      if (!f) {
#pragma unroll
        for (int c = 0; c < kMaxC; ++c) {
          if (c < C) v[c] = combine<OP>(ov[c], v[c]);
        }
      }
      f |= of;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c < C) sh.warp_v[warp][c] = v[c];
    }
    sh.warp_f[warp] = f;
  }
  __syncthreads();
  // prefix of the preceding warps' totals, then of the carry
  T pv[kMaxC];
  int pf = cf;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) pv[c] = cv[c];
  for (int j = 0; j < warp; ++j) {
    const int wf = sh.warp_f[j];
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c < C) pv[c] = wf ? sh.warp_v[j][c] : combine<OP>(pv[c], sh.warp_v[j][c]);
    }
    pf |= wf;
  }
  if (!f) {
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c < C) v[c] = combine<OP>(pv[c], v[c]);
    }
  }
  f |= pf;
  if (threadIdx.x == kThreads - 1) {
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c < C) sh.carry_v[c] = v[c];
    }
    sh.carry_f = f;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < C) cv[c] = sh.carry_v[c];
  }
  cf = sh.carry_f;
  __syncthreads();
}

template <int OP, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ values,
                                         const unsigned char* __restrict__ flags,
                                         long long row, long long n, int C,
                                         T (&v)[kMaxC], int& f) {
  if (row < n) {
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c < C) v[c] = values[row * C + c];
    }
    f = flags[row] != 0;
  } else {
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) v[c] = identity<OP, T>();
    f = 0;
  }
}

// Phase 1: each tile's segmented aggregate.
template <int OP, typename T>
__global__ void tile_reduce(const T* __restrict__ values,
                            const unsigned char* __restrict__ flags,
                            long long n, int C, T* __restrict__ agg,
                            unsigned char* __restrict__ agg_f) {
  __shared__ Shared<T> sh;
  T cv[kMaxC];
  int cf = 0;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) cv[c] = identity<OP, T>();
  const long long base = (long long)blockIdx.x * kTile;
  for (int r = 0; r < kRounds; ++r) {
    T v[kMaxC];
    int f;
    load_row<OP>(values, flags, base + (long long)r * kThreads + threadIdx.x,
                 n, C, v, f);
    block_round<OP>(v, f, C, cv, cf, sh);
  }
  if (threadIdx.x == 0) {
    for (int c = 0; c < C; ++c) agg[(long long)blockIdx.x * C + c] = cv[c];
    agg_f[blockIdx.x] = (unsigned char)cf;
  }
}

// Phase 2: exclusive segmented scan of the tile aggregates (one block).
template <int OP, typename T>
__global__ void tile_carries(const T* __restrict__ agg,
                             const unsigned char* __restrict__ agg_f,
                             long long ntiles, int C, T* __restrict__ carry) {
  __shared__ Shared<T> sh;
  T cv[kMaxC];
  int cf = 0;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) cv[c] = identity<OP, T>();
  if (threadIdx.x == 0) {
    for (int c = 0; c < C; ++c) carry[c] = identity<OP, T>();
  }
  for (long long base = 0; base < ntiles; base += kThreads) {
    const long long i = base + threadIdx.x;
    T v[kMaxC];
    int f;
    load_row<OP>(agg, agg_f, i, ntiles, C, v, f);
    block_round<OP>(v, f, C, cv, cf, sh);
    if (i + 1 < ntiles) {
      for (int c = 0; c < C; ++c) carry[(i + 1) * C + c] = v[c];
    }
  }
}

// Phase 3: rescan each tile from its carry-in; write the scan, or scatter
// each segment's last row to `out_reduce[seg_ids[row]]`.
template <int OP, typename T>
__global__ void tile_apply(const T* __restrict__ values,
                           const unsigned char* __restrict__ flags,
                           long long n, int C, const T* __restrict__ carry,
                           T* __restrict__ out_scan,
                           const long long* __restrict__ seg_ids,
                           T* __restrict__ out_reduce, long long num_segments) {
  __shared__ Shared<T> sh;
  T cv[kMaxC];
  int cf = 0;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    cv[c] = c < C ? carry[(long long)blockIdx.x * C + c] : identity<OP, T>();
  }
  const long long base = (long long)blockIdx.x * kTile;
  for (int r = 0; r < kRounds; ++r) {
    const long long row = base + (long long)r * kThreads + threadIdx.x;
    T v[kMaxC];
    int f;
    load_row<OP>(values, flags, row, n, C, v, f);
    block_round<OP>(v, f, C, cv, cf, sh);
    if (row < n) {
      if (out_scan != nullptr) {
        for (int c = 0; c < C; ++c) out_scan[row * C + c] = v[c];
      } else {
        const bool last = row == n - 1 || flags[row + 1] != 0;
        const long long s = seg_ids[row];
        if (last && s >= 0 && s < num_segments) {
          for (int c = 0; c < C; ++c) out_reduce[s * C + c] = v[c];
        }
      }
    }
  }
}

template <int OP, typename T>
int run(const void* values, const unsigned char* flags, long long n, int C,
        void* out_scan, const long long* seg_ids, void* out_reduce,
        long long num_segments, void* agg, unsigned char* agg_f, void* carry,
        cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (C < 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
  const long long ntiles = (n + kTile - 1) / kTile;
  tile_reduce<OP, T><<<(unsigned)ntiles, kThreads, 0, stream>>>(
      (const T*)values, flags, n, C, (T*)agg, agg_f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_carries<OP, T><<<1, kThreads, 0, stream>>>(
      (const T*)agg, agg_f, ntiles, C, (T*)carry);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_apply<OP, T><<<(unsigned)ntiles, kThreads, 0, stream>>>(
      (const T*)values, flags, n, C, (const T*)carry, (T*)out_scan, seg_ids,
      (T*)out_reduce, num_segments);
  return (int)cudaGetLastError();
}

template <typename T>
int run_op(int op, const void* values, const unsigned char* flags, long long n,
           int C, void* out_scan, const long long* seg_ids, void* out_reduce,
           long long num_segments, void* agg, unsigned char* agg_f, void* carry,
           cudaStream_t s) {
  switch (op) {
    case kAdd: return run<kAdd, T>(values, flags, n, C, out_scan, seg_ids,
                                   out_reduce, num_segments, agg, agg_f, carry, s);
    case kMax: return run<kMax, T>(values, flags, n, C, out_scan, seg_ids,
                                   out_reduce, num_segments, agg, agg_f, carry, s);
    case kMin: return run<kMin, T>(values, flags, n, C, out_scan, seg_ids,
                                   out_reduce, num_segments, agg, agg_f, carry, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Number of tiles (scratch rows) the wrapper allocates for n rows.
extern "C" long long repro_segmented_scan_tiles(long long n) {
  return (n + kTile - 1) / kTile;
}

// dtype: 0 int64, 1 float64; op: 0 add, 1 max, 2 min.
// values [n, C] row-major; flags [n] bytes; exactly one of out_scan [n, C]
// and (seg_ids [n], out_reduce [num_segments, C]) is given.  Scratch: agg
// and carry [tiles, C] of the value type, agg_f [tiles] bytes.
extern "C" int repro_segmented_scan(int dtype, int op, const void* values,
                                    const unsigned char* flags, long long n,
                                    int C, void* out_scan,
                                    const long long* seg_ids, void* out_reduce,
                                    long long num_segments, void* agg,
                                    unsigned char* agg_f, void* carry,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return run_op<long long>(op, values, flags, n, C, out_scan, seg_ids,
                                     out_reduce, num_segments, agg, agg_f, carry, s);
    case 1: return run_op<double>(op, values, flags, n, C, out_scan, seg_ids,
                                  out_reduce, num_segments, agg, agg_f, carry, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
