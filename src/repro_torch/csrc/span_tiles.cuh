// span_tiles.cuh — the chunk-offset scheme of span_segment.cu.
//
// The kernel turns a per-row 0/1 flag (a segment start) into its running
// rank over the whole array.  Hopper runs blocks in no order, so the rank
// is built in three launches over 256-row chunks, one chunk per warp,
// eight warps (2,048 rows) a block:
//
//   1. a per-chunk count of the flags (`segment_count`), and per block the
//      sum of its chunks' counts (`chunk_counts`);
//   2. `block_offsets` — one block scans the block counts into each
//      block's exclusive offset and writes the grand total;
//   3. each warp re-reads its chunk in 8 rounds of 32 rows and ranks every
//      flagged row with a ballot, on top of its block's offset plus the
//      counts of the block's earlier chunks (`chunk_offset`).
//
// Who uses what: span_segment.cu uses all of it (the sizes, chunk_counts,
// chunk_offset, block_offsets through launch_offsets).  span_compact.cu
// used it until it became one single-pass launch with decoupled look-back
// of its own; it includes nothing from here now.
//
// Scratch (int64): chunk counts [chunks], block counts [blocks], block
// offsets [blocks].  A single block scans, so it scans per block, not per
// chunk: eight times fewer entries on its serial path.

#pragma once

#include <cuda_runtime.h>

namespace {
namespace span {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;
constexpr long long kChunk = 32LL * kRounds;             // rows a warp
constexpr long long kBlockRows = kChunk * kWarps;        // rows a block
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 8;                            // entries a thread
constexpr unsigned kFull = 0xffffffffu;

// sizes of n rows' work, used by the launches and by the kernels alike
__host__ __device__ inline long long chunks(long long n) {
  return (n + kChunk - 1) / kChunk;
}
__host__ __device__ inline unsigned blocks(long long n) {
  return (unsigned)((n + kBlockRows - 1) / kBlockRows);
}
__host__ __device__ inline long long scratch_size(long long n) {
  return chunks(n) + 2LL * blocks(n);
}

__device__ __forceinline__ long long warp_chunk() {
  return (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
}

__device__ __forceinline__ int lane() { return threadIdx.x & 31; }

// Phase 1's tail: each lane's flag count `c` summed over its warp into
// chunk_out[chunk] (chunks inside the n rows only), and over the block
// into block_out[block].  Every thread of the block calls it (one
// barrier).
__device__ __forceinline__ void chunk_counts(int c, long long n,
                                             long long* __restrict__ chunk_out,
                                             long long* __restrict__ block_out) {
  __shared__ int warp_sum[kWarps];
  c = __reduce_add_sync(kFull, c);
  const long long w = warp_chunk();
  if (lane() == 0) {
    warp_sum[threadIdx.x >> 5] = c;
    if (w * kChunk < n) chunk_out[w] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long t = 0;
    for (int j = 0; j < kWarps; ++j) t += warp_sum[j];
    block_out[blockIdx.x] = t;
  }
}

// Phase 3's start: the exclusive offset of this warp's chunk — its block's
// offset plus the counts of the block's earlier chunks (lanes below the
// warp's index load one each).  Call with the whole warp, for a chunk
// inside the n rows.
__device__ __forceinline__ long long chunk_offset(
    const long long* __restrict__ counts,
    const long long* __restrict__ block_offs) {
  const int w_in = threadIdx.x >> 5;
  const long long first = (long long)blockIdx.x * kWarps;
  int c = lane() < w_in ? (int)counts[first + lane()] : 0;
  c = __reduce_add_sync(kFull, c);
  return block_offs[blockIdx.x] + c;
}

// Exclusive scan of `counts[m]` into `offs`, the total into *total.  One
// block of kScanThreads threads, kScanItems consecutive entries a thread;
// the launch bound keeps a thread within the 64 registers 1024 threads
// leave it.
__global__ void __launch_bounds__(kScanThreads)
block_offsets(const long long* __restrict__ counts, long long m,
              long long* __restrict__ offs, long long* __restrict__ total) {
  __shared__ long long warp_tot[kScanThreads / 32];
  __shared__ long long carry;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (long long base = 0; base < m;
       base += (long long)kScanThreads * kScanItems) {
    const long long first = base + (long long)threadIdx.x * kScanItems;
    long long v[kScanItems];
    long long sum = 0;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      v[i] = first + i < m ? counts[first + i] : 0;
      sum += v[i];
    }
    long long x = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(kFull, x, d);
      if (lane() >= d) x += y;
    }
    if (lane() == 31) warp_tot[warp] = x;
    __syncthreads();
    long long pre = carry;
    for (int j = 0; j < warp; ++j) pre += warp_tot[j];
    long long run = pre + x - sum;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      if (first + i < m) offs[first + i] = run;
      run += v[i];
    }
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry = pre + x;
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = carry;
}

// Phase 2 over the block counts of `scratch` (laid out as above).
inline cudaError_t launch_offsets(long long n, long long* scr,
                                  long long* total, cudaStream_t stream) {
  long long* bcounts = scr + chunks(n);
  block_offsets<<<1, kScanThreads, 0, stream>>>(bcounts, blocks(n),
                                                bcounts + blocks(n), total);
  return cudaGetLastError();
}

}  // namespace span
}  // namespace
