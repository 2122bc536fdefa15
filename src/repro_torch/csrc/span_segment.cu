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
// key column) and the separate group-count reduction with one ranked pass.
//
// Semantics (= `_segments_contiguous` on every slot, for any mask): slot i
// starts a segment when it is valid and is slot 0, or slot i-1 is invalid,
// or some key differs from slot i-1's (`!=`: float keys compare as IEEE
// values, so -0.0 equals 0.0 and NaN differs from itself, as in torch).
//
// Design: the chunk-offset scheme of span_tiles.cuh over the start flags:
// `segment_count` counts each warp chunk's and each block's starts,
// `block_offsets` scans the block counts (the total is the group count),
// `segment_write` ranks each start by ballot and writes seg and is_start
// for every slot.  Keys travel as kernel parameters, at most kMaxK = 8 a
// launch; with more, `key_differs` first ORs each group of 8 keys'
// slot-to-slot differences into one byte flag per slot, and the three
// launches read that flag as their only key.
//
// Bound: bytes — K key columns and the mask read once, seg (int64) and
// is_start written once, at 3.35 TB/s.  This design reads the keys and the
// mask twice, and each key again at the neighbouring slot (from L1/L2).
//
// Interface: plain C, loaded with ctypes.  Launches go on the caller's
// stream, do not synchronise, and the first launch error is returned.

#include <cuda_runtime.h>

#include "span_tiles.cuh"

namespace {

constexpr int kMaxK = 8;

// kFlag: a byte per slot that already says whether slot i's keys differ
// from slot i-1's (the output of key_differs)
enum { kI64 = 0, kI32 = 1, kI16 = 2, kI8 = 3, kF64 = 4, kF32 = 5, kFlag = 6 };

struct Keys {
  const void* key[kMaxK];
  int kind[kMaxK];
  int k;
};

template <typename T>
__device__ __forceinline__ bool differs_at(const void* p, long long i) {
  const T* v = static_cast<const T*>(p);
  return v[i] != v[i - 1];
}

// some key of slot i (i >= 1) differs from slot i-1's
__device__ __forceinline__ bool keys_differ(const Keys& keys, long long i) {
  bool d = false;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k >= keys.k || d) break;
    switch (keys.kind[k]) {
      case kI64: d = differs_at<long long>(keys.key[k], i); break;
      case kI32: d = differs_at<int>(keys.key[k], i); break;
      case kI16: d = differs_at<short>(keys.key[k], i); break;
      case kI8: d = differs_at<unsigned char>(keys.key[k], i); break;
      case kF64: d = differs_at<double>(keys.key[k], i); break;
      case kF32: d = differs_at<float>(keys.key[k], i); break;
      default: d = static_cast<const unsigned char*>(keys.key[k])[i] != 0; break;
    }
  }
  return d;
}

__device__ __forceinline__ bool is_start(const Keys& keys,
                                         const unsigned char* __restrict__ valid,
                                         long long i, long long n) {
  if (i >= n || !valid[i]) return false;
  if (i == 0 || !valid[i - 1]) return true;
  return keys_differ(keys, i);
}

// flags[i] |= some key of this group differs between slots i-1 and i (the
// first group writes every flag, later ones only set); slot 0 gets 0
__global__ void key_differs(Keys keys, long long n, bool first,
                            unsigned char* __restrict__ flags) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const bool d = i > 0 && keys_differ(keys, i);
    if (first) flags[i] = d;
    else if (d) flags[i] = 1;
  }
}

__global__ void segment_count(Keys keys, const unsigned char* __restrict__ valid,
                              long long n, long long* __restrict__ scratch) {
  const long long base = span::warp_chunk() * span::kChunk;
  int c = 0;
#pragma unroll
  for (int r = 0; r < span::kRounds; ++r) {
    c += is_start(keys, valid, base + r * 32 + span::lane(), n);
  }
  span::chunk_counts(c, n, scratch, scratch + span::chunks(n));
}

__global__ void segment_write(Keys keys, const unsigned char* __restrict__ valid,
                              long long n, const long long* __restrict__ scratch,
                              long long* __restrict__ seg,
                              unsigned char* __restrict__ start) {
  const long long base = span::warp_chunk() * span::kChunk;
  if (base >= n) return;  // the whole warp lies past the end
  const unsigned upto = span::lane() == 31 ? span::kFull
                                           : (2u << span::lane()) - 1u;
  long long run = span::chunk_offset(
      scratch, scratch + span::chunks(n) + span::blocks(n));
#pragma unroll
  for (int r = 0; r < span::kRounds; ++r) {
    const long long row = base + r * 32 + span::lane();
    const bool s = is_start(keys, valid, row, n);
    const unsigned ballot = __ballot_sync(span::kFull, s);
    if (row < n) {
      // inclusive count of starts up to this row, minus one, floored at 0
      const long long inc = run + __popc(ballot & upto);
      seg[row] = inc > 0 ? inc - 1 : 0;
      start[row] = s;
    }
    run += __popc(ballot);
  }
}

}  // namespace

// int64 scratch entries the wrapper allocates for n rows.
extern "C" long long repro_span_segment_scratch(long long n) { return span::scratch_size(n); }

// k >= 0 key columns [n] of kind[j] (0 int64, 1 int32, 2 int16, 3 one-byte
// integer or bool, 4 float64, 5 float32); valid [n] bytes; outputs seg [n]
// int64, start [n] bytes, total (int64): the number of starts; scratch:
// repro_span_segment_scratch(n) int64; flags: n bytes when k > 8, else
// unused.
extern "C" int repro_span_segment(int k, const void* const* key,
                                  const int* kind, const unsigned char* valid,
                                  long long n, long long* seg,
                                  unsigned char* start, unsigned char* flags,
                                  long long* scratch, long long* total,
                                  void* stream) {
  if (n < 1 || k < 0 || (k > kMaxK && flags == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  Keys keys{};
  if (k <= kMaxK) {
    keys.k = k;
    for (int j = 0; j < k; ++j) {
      keys.key[j] = key[j];
      keys.kind[j] = kind[j];
    }
  } else {
    const long long want = (n + span::kThreads - 1) / span::kThreads;
    const unsigned grid = (unsigned)(want < 8192 ? want : 8192);
    for (int g = 0; g < k; g += kMaxK) {
      Keys grp{};
      grp.k = k - g < kMaxK ? k - g : kMaxK;
      for (int j = 0; j < grp.k; ++j) {
        grp.key[j] = key[g + j];
        grp.kind[j] = kind[g + j];
      }
      key_differs<<<grid, span::kThreads, 0, s>>>(grp, n, g == 0, flags);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    keys.k = 1;
    keys.key[0] = flags;
    keys.kind[0] = kFlag;
  }
  segment_count<<<span::blocks(n), span::kThreads, 0, s>>>(keys, valid, n, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = span::launch_offsets(n, scratch, total, s);
  if (err != cudaSuccess) return (int)err;
  segment_write<<<span::blocks(n), span::kThreads, 0, s>>>(
      keys, valid, n, scratch, seg, start);
  return (int)cudaGetLastError();
}
