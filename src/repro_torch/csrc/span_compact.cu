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
// Design: the chunk-offset scheme of span_tiles.cuh.  `compact_count`
// counts each warp's 256-row chunk and each block's chunks,
// `block_offsets` scans the block counts (the total is the observed
// count), and `compact_scatter` loads its chunk's mask, ranks the chunk's
// valid rows by ballot, then moves them column by column: a lane issues
// the loads of its 8 rows before their stores, so a warp waits about one
// memory latency per column, not one per row (at 3% valid rows a round
// holds about one).  Rows ranked past C are not moved.  The same launch
// fills the slots past the count and writes valid' with a grid-stride
// loop.  Columns are copied as raw words (8, 4, 2 or 1 bytes, several per
// row for a 2-D column), so int64, float64 and every other data-plane type
// are bit-exact.  A scatter launch moves at most kMaxK = 8 columns (they
// travel as kernel parameters); a wider live set takes one scatter launch
// per group of 8 on the one count and offsets.
//
// Bound: bytes — the mask, the gathered rows and the C written slots, once
// each at 3.35 TB/s.  This design reads the mask twice (count and scatter),
// which a single pass with decoupled look-back would avoid.
//
// Interface: plain C, loaded with ctypes.  Launches go on the caller's
// stream, do not synchronise, and the first launch error is returned.

#include <cuda_runtime.h>

#include "span_tiles.cuh"

namespace {

constexpr int kMaxK = 8;

struct Cols {
  const void* in[kMaxK];
  void* out[kMaxK];
  int wsz[kMaxK];  // bytes per word: 8, 4, 2 or 1
  int wpr[kMaxK];  // words per row
  int k;
};

template <typename W>
__device__ __forceinline__ void copy_words(const void* in, void* out, int w,
                                           long long src, long long dst) {
  const W* i = static_cast<const W*>(in) + src * w;
  W* o = static_cast<W*>(out) + dst * w;
  for (int j = 0; j < w; ++j) o[j] = i[j];
}

__device__ __forceinline__ void copy_row(const Cols& c, long long src,
                                         long long dst) {
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k >= c.k) break;
    switch (c.wsz[k]) {
      case 8: copy_words<unsigned long long>(c.in[k], c.out[k], c.wpr[k], src, dst); break;
      case 4: copy_words<unsigned int>(c.in[k], c.out[k], c.wpr[k], src, dst); break;
      case 2: copy_words<unsigned short>(c.in[k], c.out[k], c.wpr[k], src, dst); break;
      default: copy_words<unsigned char>(c.in[k], c.out[k], c.wpr[k], src, dst); break;
    }
  }
}

// One column of a chunk's ranked rows: the lane's 8 rows (round r is row
// base + 32 r + lane) loaded together, then stored to their slots.
// Ranks are offsets within the chunk (< 256), added to the chunk's offset
// `run`; a negative rank marks a row that is not moved.
template <typename W>
__device__ __forceinline__ void move_column(const void* in, void* out, int wpr,
                                            long long base, long long run,
                                            const int (&rank)[span::kRounds]) {
  const W* src = static_cast<const W*>(in);
  W* o = static_cast<W*>(out);
  for (int j = 0; j < wpr; ++j) {
    W t[span::kRounds] = {};
#pragma unroll
    for (int r = 0; r < span::kRounds; ++r) {
      if (rank[r] >= 0) t[r] = src[(base + r * 32 + span::lane()) * wpr + j];
    }
#pragma unroll
    for (int r = 0; r < span::kRounds; ++r) {
      if (rank[r] >= 0) o[(run + rank[r]) * wpr + j] = t[r];
    }
  }
}

__global__ void compact_count(const unsigned char* __restrict__ valid,
                              long long n, long long* __restrict__ scratch) {
  const long long base = span::warp_chunk() * span::kChunk;
  int c = 0;
#pragma unroll
  for (int r = 0; r < span::kRounds; ++r) {
    const long long row = base + r * 32 + span::lane();
    if (row < n) c += valid[row] != 0;
  }
  span::chunk_counts(c, n, scratch, scratch + span::chunks(n));
}

// Four blocks an SM: the launch bound caps a thread at 64 registers.
// ptxas then spills about 1 KB a thread (the unrolled column loop inlines
// the word copy for every column and word size); on the card this ran
// faster than 106 registers without spills, two blocks an SM (PERF.md).
__global__ void __launch_bounds__(span::kThreads, 4)
compact_scatter(const unsigned char* __restrict__ valid,
                                long long n,
                                const long long* __restrict__ scratch,
                                const long long* __restrict__ total,
                                long long cap, Cols cols,
                                unsigned char* __restrict__ valid_out) {
  const long long base = span::warp_chunk() * span::kChunk;
  if (base < n) {
    // the chunk's mask first: eight independent loads, not a chain
    bool v[span::kRounds];
#pragma unroll
    for (int r = 0; r < span::kRounds; ++r) {
      const long long row = base + r * 32 + span::lane();
      v[r] = row < n && valid[row] != 0;
    }
    const unsigned below = (1u << span::lane()) - 1u;
    const long long run = span::chunk_offset(
        scratch, scratch + span::chunks(n) + span::blocks(n));
    int rank[span::kRounds];
    int seen = 0;  // valid rows of the chunk's earlier rounds
#pragma unroll
    for (int r = 0; r < span::kRounds; ++r) {
      const unsigned ballot = __ballot_sync(span::kFull, v[r]);
      const int rk = seen + __popc(ballot & below);
      rank[r] = v[r] && run + rk < cap ? rk : -1;
      seen += __popc(ballot);
    }
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k >= cols.k) break;
      switch (cols.wsz[k]) {
        case 8: move_column<unsigned long long>(cols.in[k], cols.out[k], cols.wpr[k], base, run, rank); break;
        case 4: move_column<unsigned int>(cols.in[k], cols.out[k], cols.wpr[k], base, run, rank); break;
        case 2: move_column<unsigned short>(cols.in[k], cols.out[k], cols.wpr[k], base, run, rank); break;
        default: move_column<unsigned char>(cols.in[k], cols.out[k], cols.wpr[k], base, run, rank); break;
      }
    }
  }
  // slots at or past the count: the last input row, invalid
  const long long count = *total;
  const long long stride = (long long)gridDim.x * span::kThreads;
  for (long long i = (long long)blockIdx.x * span::kThreads + threadIdx.x;
       i < cap; i += stride) {
    const bool live = i < count;
    valid_out[i] = live;
    if (!live) copy_row(cols, n - 1, i);
  }
}

}  // namespace

// int64 scratch entries the wrapper allocates for n input rows.
extern "C" long long repro_span_scratch(long long n) { return span::scratch_size(n); }

// valid [n] bytes (n >= 1); k >= 0 columns, column j a row-major [n, ...]
// array of wpr[j] words of wsz[j] bytes per row, packed into out[j] [cap,
// ...]; valid_out [cap] bytes; total: the valid count (int64); scratch:
// repro_span_scratch(n) int64.
extern "C" int repro_span_compact(const unsigned char* valid, long long n,
                                  int k, const void* const* in,
                                  void* const* out, const int* wsz,
                                  const int* wpr, long long cap,
                                  unsigned char* valid_out, long long* scratch,
                                  long long* total, void* stream) {
  if (n < 1 || cap < 1 || k < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  compact_count<<<span::blocks(n), span::kThreads, 0, s>>>(valid, n, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = span::launch_offsets(n, scratch, total, s);
  if (err != cudaSuccess) return (int)err;
  // one scatter per group of kMaxK columns (one for k = 0: it still writes
  // valid_out); every group writes the same valid_out
  for (int g = 0; g == 0 || g < k; g += kMaxK) {
    Cols cols{};
    cols.k = k - g < kMaxK ? k - g : kMaxK;
    for (int j = 0; j < cols.k; ++j) {
      cols.in[j] = in[g + j];
      cols.out[j] = out[g + j];
      cols.wsz[j] = wsz[g + j];
      cols.wpr[j] = wpr[g + j];
    }
    compact_scatter<<<span::blocks(n), span::kThreads, 0, s>>>(
        valid, n, scratch, total, cap, cols, valid_out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
