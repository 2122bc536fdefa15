// linear_scan — the diagonal affine recurrence of the RG-LRU:
//
//     h_t = a_t · h_{t-1} + b_t      (elementwise over D channels)
//
// a, b [G,T,D] float32 -> h [G,T,D] float32, with h_{-1} = 0 or the
// optional h0 [G,D] (then h_0 = a_0·h0 + b_0, the reference's fold of h0
// into b_0).
//
// Replaces the Pallas TPU kernel `repro/kernels/linear_scan.py:linear_scan`
// (`pl.pallas_call` at line 57).  The TPU kernel runs an associative scan
// over 256-step blocks on [256, D] tiles (log2(256) vector combine steps)
// and carries h across blocks, the sequential last grid axis, in VMEM
// scratch.  On Hopper one thread owns one (g, d) channel and loops over T
// itself: the recurrence is one FMA a step, so the work is the T·G·D FMAs
// and no more, against the associative scan's log-factor.  Neighbouring
// threads own neighbouring channels, so every load and store of a step is
// coalesced along d; each thread loads eight steps of a and b before it
// runs them, so eight loads are in flight while the FMAs wait.  Any T.
//
// Bound: bytes.  At the served prefill shape (G=4, D=2560, T≈1,900) the
// kernel must read a and b and write h, ~0.23 GB in float32 (~0.07 ms at
// 3.35 TB/s); its ~20 MFLOP are nothing.  The design does not reach it:
// G·D = 10,240 threads (80 blocks of 128) under-fill 132 SMs, so the
// bytes in flight, not the memory's rate, set the time.  The chunked
// two-pass form (each chunk's affine aggregate, then the carries, then the
// chunks in parallel) would fill the card; it is later work.
//
// Interface: plain C, loaded with ctypes.  The launch goes on the caller's
// stream, does not synchronise and returns `cudaGetLastError()`.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kAhead = 8;  // steps loaded before they are run

__global__ void __launch_bounds__(kThreads)
    linear_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       const float* __restrict__ h0, float* __restrict__ out,
                       long long T, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const long long g = blockIdx.y;
  const long long base = g * T * D + d;
  float h = h0 != nullptr ? h0[g * D + d] : 0.f;
  long long t = 0;
  for (; t + kAhead <= T; t += kAhead) {
    float av[kAhead], bv[kAhead];
#pragma unroll
    for (int s = 0; s < kAhead; ++s) {
      av[s] = a[base + (t + s) * D];
      bv[s] = b[base + (t + s) * D];
    }
#pragma unroll
    for (int s = 0; s < kAhead; ++s) {
      h = fmaf(av[s], h, bv[s]);
      out[base + (t + s) * D] = h;
    }
  }
  for (; t < T; ++t) {
    h = fmaf(a[base + t * D], h, b[base + t * D]);
    out[base + t * D] = h;
  }
}

}  // namespace

// h0 may be null.  G blocks in grid y (at most 65,535).
extern "C" int repro_linear_scan(const float* a, const float* b,
                                 const float* h0, float* out, long long g,
                                 long long t, int d, void* stream) {
  if (g <= 0 || t <= 0 || d <= 0) return (int)cudaSuccess;
  if (g > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((d + kThreads - 1) / kThreads, (unsigned)g);
  linear_scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a, b, h0,
                                                                  out, t, d);
  return (int)cudaGetLastError();
}
