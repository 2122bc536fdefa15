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
// scratch.
//
// Design: one pass that reads a and b once and writes h once.  A block
// owns (g, a tile of 32 channels) and splits T among its 8 warps: the lanes
// lie along the channels, so every load and store is one coalesced 128-byte
// row, and warp j takes steps [8j, 8j+8) of each 64-step slab.  For each
// slab:
//   1. each thread holds its 8 steps of a and b in registers (the next
//      slab's loads start before this slab's scan, so they are in flight
//      while it runs);
//   2. it folds them into one affine pair (A, B) = (Π a, h after 8 steps
//      from 0), and stores it in shared memory;
//   3. after one barrier every thread walks the 8 warps' pairs of its
//      channel, (a1,b1)⊕(a2,b2) = (a1·a2, a2·b1 + b2), starting from the
//      slab's carry (h0 or the last slab's h): that gives its own exclusive
//      carry and the next slab's carry, with no second barrier (the pairs
//      are double-buffered);
//   4. it reruns its 8 steps from registers from that carry and writes h.
// Steps past T are the identity (a = 1, b = 0), so any T and any D take
// the same path.  The result equals the sequential recurrence in exact
// arithmetic; its float order differs, as the reference's associative
// scan's does.
//
// Bound: bytes.  At the served prefill shape (G=4, D=2560, T≈1,900) the
// kernel must read a and b and write h, ~0.23 GB in float32 (~0.07 ms at
// 3.35 TB/s); its ~20 MFLOP are nothing.  320 blocks of 256 threads keep
// 64 bytes a thread in flight across every SM, which one thread per
// channel (10,240 threads, the previous design's 0.27 ms) could not.  It
// takes 0.096 ms there on an H100 80GB HBM3 at 700 W, 1.4x the bound
// (PERF.md §6).
//
// Interface: plain C, loaded with ctypes.  The launch goes on the caller's
// stream, does not synchronise and returns `cudaGetLastError()`.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;                // channels a block
constexpr int kRows = 8;                  // warps a block, along time
constexpr int kSteps = 8;                 // steps a thread a slab
constexpr int kSlab = kRows * kSteps;     // steps a slab
constexpr int kThreads = kLanes * kRows;

__global__ void __launch_bounds__(kThreads)
    linear_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       const float* __restrict__ h0, float* __restrict__ out,
                       long long T, int D) {
  __shared__ float2 pairs[2][kRows][kLanes];
  const int lane = threadIdx.x & (kLanes - 1), row = threadIdx.x / kLanes;
  const int d = blockIdx.x * kLanes + lane;
  const bool live = d < D;
  const long long g = blockIdx.y;
  const long long base = g * T * D + d;
  const long long slabs = (T + kSlab - 1) / kSlab;

  float av[kSteps], bv[kSteps];
  auto load = [&](long long slab, float (&an)[kSteps], float (&bn)[kSteps]) {
    const long long t0 = slab * kSlab + row * kSteps;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const bool ok = live && t0 + s < T;
      an[s] = ok ? __ldg(a + base + (t0 + s) * D) : 1.f;
      bn[s] = ok ? __ldg(b + base + (t0 + s) * D) : 0.f;
    }
  };
  float carry = h0 != nullptr && live ? h0[g * D + d] : 0.f;
  load(0, av, bv);
  for (long long sl = 0; sl < slabs; ++sl) {
    float an[kSteps], bn[kSteps];
    if (sl + 1 < slabs) load(sl + 1, an, bn);
    float A = 1.f, B = 0.f;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      B = fmaf(av[s], B, bv[s]);
      A *= av[s];
    }
    float2(*pr)[kLanes] = pairs[sl & 1];
    pr[row][lane] = make_float2(A, B);
    __syncthreads();
    float c = carry, mine = carry;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (j == row) mine = c;
      const float2 e = pr[j][lane];
      c = fmaf(e.x, c, e.y);
    }
    carry = c;
    const long long t0 = sl * kSlab + row * kSteps;
    float hv = mine;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      hv = fmaf(av[s], hv, bv[s]);
      if (live && t0 + s < T) out[base + (t0 + s) * D] = hv;
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      av[s] = an[s];
      bv[s] = bn[s];
    }
  }
}

}  // namespace

// h0 may be null.  G blocks in grid y (at most 65,535), ceil(D / 32) in x.
extern "C" int repro_linear_scan(const float* a, const float* b,
                                 const float* h0, float* out, long long g,
                                 long long t, int d, void* stream) {
  if (g <= 0 || t <= 0 || d <= 0) return (int)cudaSuccess;
  if (g > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((d + kLanes - 1) / kLanes, (unsigned)g);
  linear_scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a, b, h0,
                                                                  out, t, d);
  return (int)cudaGetLastError();
}
