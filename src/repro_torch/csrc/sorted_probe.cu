// sorted_probe — leftmost insertion positions (searchsorted side='left').
//
// Replaces the Pallas TPU kernel `repro/kernels/sorted_probe.py:sorted_probe`
// (`pl.pallas_call` at line 63).  The TPU form counts `key < query` over a
// (M/1024, N/1024) grid of broadcast compares, O(M·N) work, because per-lane
// gathers serialize on the TPU's vector unit.  On Hopper a gather is cheap,
// so each query runs its own binary search: O(M·log N) work, one thread per
// query, in the keys' native type (int64 or float64).
//
// Bound: bytes.  Each query reads itself once and writes one int32; the key
// array (8 MB at N=1M int64) stays resident in the 50 MB L2 after the first
// probes touch it, so the log N dependent loads per query hit L2, not HBM.
// There is no padding: the search never looks past the N real keys, which
// keeps the reference's contract that padded keys never count.
//
// Interface: plain C, loaded with ctypes.  The launch goes on the caller's
// stream, does not synchronise and returns `cudaGetLastError()`.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void probe_kernel(const T* __restrict__ keys, long long n,
                             const T* __restrict__ queries, long long m,
                             int* __restrict__ out) {
  const long long stride = (long long)blockDim.x * gridDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    const T q = queries[i];
    long long lo = 0, hi = n;
    while (lo < hi) {
      const long long mid = lo + ((hi - lo) >> 1);
      if (keys[mid] < q) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    out[i] = (int)lo;
  }
}

template <typename T>
int launch(const void* keys, long long n, const void* queries, long long m,
           int* out, cudaStream_t stream) {
  if (m <= 0) return (int)cudaSuccess;
  long long blocks = (m + kThreads - 1) / kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond this
  probe_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)keys, n, (const T*)queries, m, out);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 int64, 1 float64.
extern "C" int repro_sorted_probe(int dtype, const void* keys, long long n,
                                  const void* queries, long long m, int* out,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<long long>(keys, n, queries, m, out, s);
    case 1: return launch<double>(keys, n, queries, m, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
