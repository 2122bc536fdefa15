// sorted_probe — leftmost insertion positions (searchsorted side='left'),
// and the join probe's clamped int64 positions in the same launch.
//
// Replaces the Pallas TPU kernel `repro/kernels/sorted_probe.py:sorted_probe`
// (`pl.pallas_call` at line 63).  The TPU form counts `key < query` over a
// (M/1024, N/1024) grid of broadcast compares, O(M·N) work, because per-lane
// gathers serialize on the TPU's vector unit.  On Hopper a gather is cheap,
// so each query runs its own binary search: O(M·log N) work, one thread per
// query, in the keys' native type (int64 or float64).
//
// Bound: bytes.  Each query reads itself once and writes one position; the
// key array stays resident in the 50 MB L2 after the first probes touch it,
// and the top levels of the search, which every query visits, in L1.  A
// two-level search (every 16th key staged in shared memory per block, then
// one window in L2) measured no faster at a join's size, where the launch
// sets the time, and slower at a million queries, where staging the
// samples in every block costs more than the L1 hits it replaces; so the
// search stays plain.  There is no padding: the search never looks past
// the N real keys, which keeps the reference's contract that padded keys
// never count.
//
// The epilogue writes either int32 positions (`sorted_probe`) or int64
// positions clamp(max(pos, *first_valid), 0, hi) (`probe_positions`), the
// join probe's whole index computation, so the caller needs no cast, max or
// clamp launch of its own.  `first_valid` is read from device memory, so
// the caller never synchronises to learn it.
//
// Interface: plain C, loaded with ctypes.  The launch goes on the caller's
// stream, does not synchronise and returns `cudaGetLastError()`.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T, bool kClamp>
__global__ void __launch_bounds__(kThreads)
    probe_kernel(const T* __restrict__ keys, long long n,
                 const T* __restrict__ queries, long long m,
                 void* __restrict__ out,
                 const long long* __restrict__ first_valid, long long hi) {
  const long long low = (kClamp && first_valid) ? *first_valid : 0;
  const long long stride = (long long)blockDim.x * gridDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    const T q = queries[i];
    long long lo = 0, up = n;
    while (lo < up) {
      const long long mid = lo + ((up - lo) >> 1);
      if (keys[mid] < q) {
        lo = mid + 1;
      } else {
        up = mid;
      }
    }
    if (kClamp) {
      lo = lo > low ? lo : low;
      lo = lo > 0 ? lo : 0;
      reinterpret_cast<long long*>(out)[i] = lo < hi ? lo : hi;
    } else {
      reinterpret_cast<int*>(out)[i] = (int)lo;
    }
  }
}

template <typename T>
int launch(const void* keys, long long n, const void* queries, long long m,
           void* out, int clamp, const void* first_valid, long long hi,
           cudaStream_t stream) {
  if (m <= 0) return (int)cudaSuccess;
  long long blocks = (m + kThreads - 1) / kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond this
  if (clamp) {
    probe_kernel<T, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const T*)keys, n, (const T*)queries, m, out,
        (const long long*)first_valid, hi);
  } else {
    probe_kernel<T, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const T*)keys, n, (const T*)queries, m, out, nullptr, 0);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 int64, 1 float64.  clamp 0: out is int32 positions.  clamp 1:
// out is int64 clamp(max(pos, *first_valid), 0, hi); first_valid may be
// null (no lower clamp but 0).
extern "C" int repro_sorted_probe(int dtype, const void* keys, long long n,
                                  const void* queries, long long m, void* out,
                                  int clamp, const void* first_valid,
                                  long long hi, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<long long>(keys, n, queries, m, out, clamp, first_valid, hi, s);
    case 1: return launch<double>(keys, n, queries, m, out, clamp, first_valid, hi, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
