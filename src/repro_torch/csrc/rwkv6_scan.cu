// rwkv6_scan — the WKV6 recurrence of RWKV-6 (Finch), per (batch, head):
//
//     out_t = r_t · (S + diag(u) · k_tᵀ v_t)
//     S     = diag(w_t) · S + k_tᵀ v_t
//
// r, k, w [B,H,T,Dk], v [B,H,T,Dv], u [H,Dk] -> out [B,H,T,Dv] in r's type;
// S [Dk,Dv] float32, zeros or the optional state in, and the optional final
// state out, both [B,H,Dk,Dv] float32.
//
// Replaces the Pallas TPU kernel `repro/kernels/rwkv6_scan.py:rwkv6_scan`
// (`pl.pallas_call` at line 69).  The TPU kernel walks 128-step time chunks
// as the sequential last grid axis and carries S in VMEM scratch from one
// grid step to the next; it takes no state and returns none.  On Hopper
// blocks run in no order, so one block owns one (b, h) and the loop over T
// runs inside it.  With no state in, it computes what the Pallas kernel
// computes; with a state in and out it is the reference's `ref.rwkv6(...,
// state=, return_state=True)`, which the prefill path needs.
//
// Layout: Dv threads; thread j holds column S[:, j] in Dk float32
// registers, so out_j = Σ_i r_i S_ij + v_j Σ_i r_i u_i k_i needs no
// reduction across threads (the scalar Σ r u k is computed once a step
// when a chunk lands).  r, k, v (one type) and w (its own) for a chunk of
// up to 32 steps are copied with `cp.async` into one of two shared-memory
// buffers while the other buffer's chunk is computed, and read from there
// in their own type (bf16 or float32) as broadcasts, with float32
// accumulation, so the caller makes no cast copies.  Any T: the last chunk
// is ragged.
//
// Bound: at the served prefill shape (B=4, H=40, Dk=Dv=64, T≈1,900) the
// kernel must read r/k/v in bf16 and w in float32 and write bf16, ~0.24 GB
// (~0.07 ms at 3.35 TB/s), and do ~5·Dk·Dv flops a step (~6 GFLOP, ~0.09 ms
// at 67 TFLOP/s on the CUDA cores): operations by a little.  The design does
// not reach it: 160 blocks of 2 warps on 132 SMs leave each SM a few warps,
// and every step is ~Dk FMAs a thread that no other warp hides, so the
// kernel is bound by the issue of T serial steps.  The copies are off that
// path (the first revision loaded each chunk element by element and waited
// on every load: 2.1 ms at the served shape).  Splitting Dk across warps
// (more threads a head, a reduction a step), or a chunked form on tensor
// cores, is later work.
//
// Interface: plain C, loaded with ctypes.  The launch goes on the caller's
// stream, does not synchronise and returns `cudaGetLastError()`.  r, k, v,
// w must be 16-byte aligned and Dv a multiple of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kF32 = 0, kBF16 = 1;  // type codes of the inputs
constexpr int kMaxDv = 256;         // threads a block
constexpr int kMaxSteps = 32;       // steps a chunk
constexpr int kSmemBytes = 48 * 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// four consecutive values from shared memory as float32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// `bytes` (a multiple of 16) from global to shared memory, 16 bytes a
// cp.async, spread over the block; complete after the matching wait
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int bytes, int tid, int nthr) {
  const unsigned base = (unsigned)__cvta_generic_to_shared(dst);
  const char* s = static_cast<const char*>(src);
  for (int off = tid * 16; off < bytes; off += nthr * 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(base + off),
                 "l"(s + off));
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int DK, typename TR, typename TW>
__global__ void __launch_bounds__(kMaxDv)
    wkv6_kernel(const TR* __restrict__ r, const TR* __restrict__ k,
                const TR* __restrict__ v, const TW* __restrict__ w,
                const void* __restrict__ u, int cu,
                const float* __restrict__ state_in,
                float* __restrict__ state_out, TR* __restrict__ out, int H,
                int T, int DV, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  // two buffers, each r [L][DK], k [L][DK], v [L][DV] in TR and w [L][DK]
  // in TW; then u [DK] and Σ r u k [L] in float32
  const int buf_bytes = L * (2 * DK + DV) * (int)sizeof(TR) +
                        L * DK * (int)sizeof(TW);
  float* su = reinterpret_cast<float*>(smem + 2 * buf_bytes);
  float* sruk = su + DK;

  const int bh = blockIdx.x;
  const int h = bh % H;
  const int j = threadIdx.x;
  const int nthr = blockDim.x;
  const long long row0 = (long long)bh * T;  // the first step's row

  auto buf_r = [&](int c) {
    return reinterpret_cast<TR*>(smem + (c & 1) * buf_bytes);
  };
  auto buf_w = [&](int c) {
    return reinterpret_cast<TW*>(buf_r(c) + L * (2 * DK + DV));
  };
  auto issue = [&](int c) {  // chunk c into buffer c & 1
    TR* br = buf_r(c);
    const int t0 = c * L;
    const int n = min(L, T - t0);
    const long long rk = (row0 + t0) * DK;
    copy_async(br, r + rk, n * DK * (int)sizeof(TR), j, nthr);
    copy_async(br + L * DK, k + rk, n * DK * (int)sizeof(TR), j, nthr);
    copy_async(br + 2 * L * DK, v + (row0 + t0) * DV,
               n * DV * (int)sizeof(TR), j, nthr);
    copy_async(buf_w(c), w + rk, n * DK * (int)sizeof(TW), j, nthr);
    commit();
  };

  const int chunks = (T + L - 1) / L;
  if (chunks > 0) issue(0);
  for (int i = j; i < DK; i += nthr) {
    su[i] = cu == kBF16
                ? __bfloat162float(static_cast<const bf16*>(u)[h * DK + i])
                : static_cast<const float*>(u)[h * DK + i];
  }

  float S[DK];
  const long long base_s = (long long)bh * DK * DV + j;
#pragma unroll
  for (int i = 0; i < DK; ++i)
    S[i] = state_in != nullptr ? state_in[base_s + (long long)i * DV] : 0.f;

  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      issue(c + 1);  // lands while this chunk is computed
      wait_groups<1>();
    } else {
      wait_groups<0>();
    }
    __syncthreads();  // chunk c (and u) visible to every thread
    const TR* br = buf_r(c);
    const TR* bk = br + L * DK;
    const TR* bv = br + 2 * L * DK;
    const TW* bw = buf_w(c);
    const int t0 = c * L;
    const int n = min(L, T - t0);
    for (int s = j; s < n; s += nthr) {
      // thread s starts at column s: no two threads of a warp share a bank
      float acc = 0.f;
#pragma unroll
      for (int ii = 0; ii < DK; ++ii) {
        const int i = (ii + s) & (DK - 1);
        acc = fmaf(to_f(br[s * DK + i]) * su[i], to_f(bk[s * DK + i]), acc);
      }
      sruk[s] = acc;
    }
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      const float vj = to_f(bv[s * DV + j]);
      const TR* rs = br + s * DK;
      const TR* ks = bk + s * DK;
      const TW* ws = bw + s * DK;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int q = 0; q < DK / 4; ++q) {
        const float4 rr = ld4(rs + 4 * q), kk = ld4(ks + 4 * q),
                     ww = ld4(ws + 4 * q);
        a0 = fmaf(rr.x, S[4 * q + 0], a0);
        a1 = fmaf(rr.y, S[4 * q + 1], a1);
        a2 = fmaf(rr.z, S[4 * q + 2], a2);
        a3 = fmaf(rr.w, S[4 * q + 3], a3);
        S[4 * q + 0] = fmaf(ww.x, S[4 * q + 0], kk.x * vj);
        S[4 * q + 1] = fmaf(ww.y, S[4 * q + 1], kk.y * vj);
        S[4 * q + 2] = fmaf(ww.z, S[4 * q + 2], kk.z * vj);
        S[4 * q + 3] = fmaf(ww.w, S[4 * q + 3], kk.w * vj);
      }
      store(out + (row0 + t0 + s) * DV + j,
            (a0 + a1) + (a2 + a3) + sruk[s] * vj);
    }
    __syncthreads();  // buffer c & 1 and sruk are free again
  }
  if (state_out != nullptr) {
#pragma unroll
    for (int i = 0; i < DK; ++i) state_out[base_s + (long long)i * DV] = S[i];
  }
}

template <int DK, typename TR, typename TW>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, int cu, const float* state_in, float* state_out,
           void* out, int bh, int H, int T, int DV, cudaStream_t stream) {
  // steps a chunk: as many as two buffers fit in 48 KB, up to 32
  const int per_step = (2 * DK + DV) * (int)sizeof(TR) + DK * (int)sizeof(TW);
  int L = (kSmemBytes - DK * (int)sizeof(float)) / (2 * per_step + 4);
  if (L > kMaxSteps) L = kMaxSteps;
  if (L < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * L * per_step + (size_t)(DK + L) * 4;
  wkv6_kernel<DK, TR, TW><<<bh, DV, smem, stream>>>(
      (const TR*)r, (const TR*)k, (const TR*)v, (const TW*)w, u, cu, state_in,
      state_out, (TR*)out, H, T, DV, L);
  return (int)cudaGetLastError();
}

template <int DK>
int launch_types(int crkv, int cw, const void* r, const void* k,
                 const void* v, const void* w, const void* u, int cu,
                 const float* state_in, float* state_out, void* out, int bh,
                 int H, int T, int DV, cudaStream_t s) {
  if (crkv == kBF16 && cw == kF32)
    return launch<DK, bf16, float>(r, k, v, w, u, cu, state_in, state_out,
                                   out, bh, H, T, DV, s);
  if (crkv == kBF16)
    return launch<DK, bf16, bf16>(r, k, v, w, u, cu, state_in, state_out,
                                  out, bh, H, T, DV, s);
  if (cw == kF32)
    return launch<DK, float, float>(r, k, v, w, u, cu, state_in, state_out,
                                    out, bh, H, T, DV, s);
  return launch<DK, float, bf16>(r, k, v, w, u, cu, state_in, state_out, out,
                                 bh, H, T, DV, s);
}

}  // namespace

// Type codes: 0 float32, 1 bf16; crkv for r, k, v (and the output), cw for
// w, cu for u.  state_in and state_out may be null.  bh = B·H blocks of dv
// threads.
extern "C" int repro_rwkv6_scan(int dk, int crkv, int cw, int cu,
                                const void* r, const void* k, const void* v,
                                const void* w, const void* u,
                                const float* state_in, float* state_out,
                                void* out, int bh, int h, int t, int dv,
                                void* stream) {
  if (bh <= 0) return (int)cudaSuccess;
  const int codes[3] = {crkv, cw, cu};
  for (int c : codes)
    if (c != kF32 && c != kBF16) return (int)cudaErrorInvalidValue;
  if (h <= 0 || bh % h != 0 || t < 0 || dv < 8 || dv > kMaxDv || dv % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dk) {
    case 16: return launch_types<16>(crkv, cw, r, k, v, w, u, cu, state_in, state_out, out, bh, h, t, dv, s);
    case 32: return launch_types<32>(crkv, cw, r, k, v, w, u, cu, state_in, state_out, out, bh, h, t, dv, s);
    case 64: return launch_types<64>(crkv, cw, r, k, v, w, u, cu, state_in, state_out, out, bh, h, t, dv, s);
    case 128: return launch_types<128>(crkv, cw, r, k, v, w, u, cu, state_in, state_out, out, bh, h, t, dv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
