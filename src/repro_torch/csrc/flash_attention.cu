// flash_attention — causal / sliding-window GQA attention with an online
// softmax, q [B,Hq,T,D] and k/v [B,Hkv,S,D] -> o [B,Hq,T,D].
//
// Replaces the Pallas TPU kernel
// `repro/kernels/flash_attention.py:flash_attention` (`pl.pallas_call` at
// line 112).  Same contract: scale d^-0.5 unless given; q row i sits at
// position i + S - T of the kv timeline; causal keeps k_pos <= q_pos, a
// window keeps k_pos > q_pos - window; running max, denominator and
// accumulator in float32; masked logits are -1e30 and contribute nothing;
// the output is acc / max(l, 1e-30) in q's type, so a row with no live key
// is 0.  KV tiles that no row of a query tile can see are never loaded.
//
// The TPU kernel walks the KV tiles as the sequential last grid axis and
// carries (m, l, acc) in VMEM scratch from one grid step to the next.  On
// Hopper blocks run in no order, so each block owns one (b, h, 64-row query
// tile) and loops over its live KV tiles itself, with (m, l, acc) in
// registers.  The GQA KV head is h / (Hq / Hkv), as the TPU index maps
// have it; the group's query heads re-read the same K/V tiles through L2.
// T and S need not be multiples of the tiles: ragged rows and keys are
// masked (the reference wrapper instead shrinks its blocks to divisors of
// T, down to 1 for a prime prompt length).
//
// Two kernels, by input type:
//  - bf16: tensor cores through `mma.sync.m16n8k16` (bf16 in, f32 out).
//    Four warps, 16 query rows each; the Q tile's A fragments stay in
//    registers; K and V tiles of 64 keys are staged in shared memory
//    (rows padded by 8 halves so fragment loads are free of bank
//    conflicts); V's B fragments come from `ldmatrix.trans`.  P is rounded
//    to bf16 for the P·V product, the row sums stay f32.  Bound: operations
//    (at T = S = 2048, D = 128 the causal work is about 4,000 flops per byte
//    moved, far above the card's ~295 flops per byte for bf16).
//  - f32: the same tiling on the CUDA cores in plain float32 FMAs, for
//    inputs that must not be rounded.  Four threads share a query row.
// Neither uses TMA or wgmma yet, and K/V loads are not overlapped with the
// math except across the three blocks resident on an SM: double-buffering
// them with cp.async (and ldmatrix for K) measured no faster at the served
// shape, so the loads stay plain.
//
// Interface: plain C, loaded with ctypes.  The launch goes on the caller's
// stream, does not synchronise and returns `cudaGetLastError()`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kBM = 64;  // query rows per block

struct Range {
  int begin, end;  // KV tiles [begin, end)
};

// The KV tiles that some row of the query tile [q0, q0 + rows) can see.
__device__ __forceinline__ Range kv_tiles(int q0, int rows, int t, int s,
                                          int bn, int causal, int window) {
  const long long plo = (long long)q0 + (s - t);
  const long long phi = plo + rows - 1;
  long long kend = s;
  if (causal && phi + 1 < kend) kend = phi + 1;
  long long kbeg = 0;
  if (window >= 0 && plo - window + 1 > kbeg) kbeg = plo - window + 1;
  if (kend <= kbeg) return {0, 0};
  return {(int)(kbeg / bn), (int)((kend + bn - 1) / bn)};
}

__device__ __forceinline__ bool live(int kpos, int qpos, int s, int causal,
                                     int window) {
  return kpos < s && (!causal || kpos <= qpos) &&
         (window < 0 || kpos > qpos - window);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a · b for one 16x8x16 tile: bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, transposed: the B fragments of
// two adjacent 8-column tiles of a row-major [k][n] operand.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// ---------------------------------------------------------------------------
// bf16: mma.sync
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(128)
    flash_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, int hq, int hkv, int t, int s,
               float scale_log2, int causal, int window) {
  constexpr int BN = 64;      // keys per tile
  constexpr int LD = D + 8;   // padded smem row, in halves
  constexpr int C8 = D / 8;   // 16-byte chunks per row
  static_assert(BN == kBM, "the Q tile is staged through sK");
  __shared__ __align__(16) __nv_bfloat16 sK[BN * LD];
  __shared__ __align__(16) __nv_bfloat16 sV[BN * LD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (hq / hkv);
  const __nv_bfloat16* qb = q + ((size_t)b * hq + h) * t * D;
  const __nv_bfloat16* kb = k + ((size_t)b * hkv + hk) * s * D;
  const __nv_bfloat16* vb = v + ((size_t)b * hkv + hk) * s * D;
  __nv_bfloat16* ob = o + ((size_t)b * hq + h) * t * D;

  // Stage the Q tile through sK and keep its A fragments in registers.
  for (int i = tid; i < kBM * C8; i += 128) {
    const int row = i / C8, c8 = i % C8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + row < t)
      val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + row) * D + c8 * 8);
    *reinterpret_cast<uint4*>(sK + row * LD + c8 * 8) = val;
  }
  __syncthreads();
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p = sK + r0 * LD + kk * 16 + tg * 2;
    qa[kk][0] = lds32(p);
    qa[kk][1] = lds32(p + 8 * LD);
    qa[kk][2] = lds32(p + 8);
    qa[kk][3] = lds32(p + 8 * LD + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const int qpos0 = q0 + r0 + (s - t), qpos1 = qpos0 + 8;
  const Range rg = kv_tiles(q0, min(kBM, t - q0), t, s, BN, causal, window);

  for (int kt = rg.begin; kt < rg.end; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // every warp is done with the previous tile (and Q)
    for (int i = tid; i < BN * C8; i += 128) {
      const int row = i / C8, c8 = i % C8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + row < s) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + row) * D + c8 * 8);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + row) * D + c8 * 8);
      }
      *reinterpret_cast<uint4*>(sK + row * LD + c8 * 8) = kv;
      *reinterpret_cast<uint4*>(sV + row * LD + c8 * 8) = vv;
    }
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys per warp
    float sc[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        const __nv_bfloat16* p = sK + (n * 8 + g) * LD + kk * 16 + tg * 2;
        mma_bf16(sc[n], qa[kk], lds32(p), lds32(p + 8));
      }
    }

    // mask and scale (log2 units), row max over the quad that shares a row
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + n * 8 + tg * 2 + (e & 1);
        const int qp = e < 2 ? qpos0 : qpos1;
        const float x = live(kpos, qp, s, causal, window) ? sc[n][e] * scale_log2 : kNeg;
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float mnew = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - mnew);
      m[i] = mnew;
      l[i] *= alpha[i];  // this thread's share of the row sum
    }

    // P in registers as the A fragments of P·V (the S accumulator layout
    // of two adjacent 8-key tiles is the A layout of one 16-key step)
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = sc[n][e] == kNeg ? 0.f : exp2f(sc[n][e] - m[e >> 1]);
        l[e >> 1] += p[e];
      }
      pa[n / 2][(n & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V; lane i addresses row i % 16 of the 16-key step, 8 columns
    // at (i / 16) * 8 past the tile pair's first column
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t vbf[4];
        ldmatrix_x4_trans(vbf, sV + (kk * 16 + (lane & 15)) * LD + (n + (lane >> 4)) * 8);
        mma_bf16(acc[n], pa[kk], vbf[0], vbf[1]);
        mma_bf16(acc[n + 1], pa[kk], vbf[2], vbf[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
  if (q0 + r0 < t) {
    __nv_bfloat16* p = ob + (size_t)(q0 + r0) * D + tg * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(p + n * 8) =
          __floats2bfloat162_rn(acc[n][0] / l[0], acc[n][1] / l[0]);
  }
  if (q0 + r0 + 8 < t) {
    __nv_bfloat16* p = ob + (size_t)(q0 + r0 + 8) * D + tg * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(p + n * 8) =
          __floats2bfloat162_rn(acc[n][2] / l[1], acc[n][3] / l[1]);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs
// ---------------------------------------------------------------------------
constexpr int kF32BN = 32;  // keys per tile

template <int D>
constexpr int f32_smem_floats() {
  return (kBM + 2 * kF32BN) * (D + 4) + kBM * (kF32BN + 1);
}

// 256 threads: thread (r, c) = (tid / 4, tid % 4) owns query row r, keys
// c, c + 4, ... of each tile, and the float4 columns c, c + 4, ... of the
// output row.
template <int D>
__global__ void __launch_bounds__(256)
    flash_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int hq,
              int hkv, int t, int s, float scale, int causal, int window) {
  constexpr int BN = kF32BN, LD = D + 4, C4 = D / 4, PL = BN + 1;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;            // [kBM][LD]
  float* sK = sQ + kBM * LD;   // [BN][LD]
  float* sV = sK + BN * LD;    // [BN][LD]
  float* sP = sV + BN * LD;    // [kBM][PL]

  const int tid = threadIdx.x, r = tid >> 2, c = tid & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (hq / hkv);
  const float* qb = q + ((size_t)b * hq + h) * t * D;
  const float* kb = k + ((size_t)b * hkv + hk) * s * D;
  const float* vb = v + ((size_t)b * hkv + hk) * s * D;
  float* ob = o + ((size_t)b * hq + h) * t * D;

  for (int i = tid; i < kBM * C4; i += 256) {
    const int row = i / C4, c4 = i % C4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + row < t)
      val = *reinterpret_cast<const float4*>(qb + (size_t)(q0 + row) * D + c4 * 4);
    *reinterpret_cast<float4*>(sQ + row * LD + c4 * 4) = val;
  }

  float4 acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = kNeg, l = 0.f;
  const int qpos = q0 + r + (s - t);
  const Range rg = kv_tiles(q0, min(kBM, t - q0), t, s, BN, causal, window);

  for (int kt = rg.begin; kt < rg.end; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    for (int i = tid; i < BN * C4; i += 256) {
      const int row = i / C4, c4 = i % C4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + row < s) {
        kv = *reinterpret_cast<const float4*>(kb + (size_t)(k0 + row) * D + c4 * 4);
        vv = *reinterpret_cast<const float4*>(vb + (size_t)(k0 + row) * D + c4 * 4);
      }
      *reinterpret_cast<float4*>(sK + row * LD + c4 * 4) = kv;
      *reinterpret_cast<float4*>(sV + row * LD + c4 * 4) = vv;
    }
    __syncthreads();

    float sc[BN / 4];
#pragma unroll
    for (int j = 0; j < BN / 4; ++j) sc[j] = 0.f;
#pragma unroll 4
    for (int d4 = 0; d4 < C4; ++d4) {
      const float4 qv = *reinterpret_cast<const float4*>(sQ + r * LD + d4 * 4);
#pragma unroll
      for (int j = 0; j < BN / 4; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(sK + (c + 4 * j) * LD + d4 * 4);
        sc[j] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }
    float mx = kNeg;
#pragma unroll
    for (int j = 0; j < BN / 4; ++j) {
      sc[j] = live(k0 + c + 4 * j, qpos, s, causal, window) ? sc[j] * scale : kNeg;
      mx = fmaxf(mx, sc[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mnew = fmaxf(m, mx);
    const float alpha = expf(m - mnew);
    m = mnew;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 4; ++j) {
      const float p = sc[j] == kNeg ? 0.f : expf(sc[j] - m);
      rs += p;
      sP[r * PL + c + 4 * j] = p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l = l * alpha + rs;
    __syncwarp();  // the row's P comes from the four lanes of its quad
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      acc[j].x *= alpha;
      acc[j].y *= alpha;
      acc[j].z *= alpha;
      acc[j].w *= alpha;
    }
    for (int kk = 0; kk < BN; ++kk) {
      const float p = sP[r * PL + kk];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(sV + kk * LD + (c + 4 * j) * 4);
        acc[j].x += p * vv.x;
        acc[j].y += p * vv.y;
        acc[j].z += p * vv.z;
        acc[j].w += p * vv.w;
      }
    }
  }

  if (q0 + r < t) {
    const float den = fmaxf(l, 1e-30f);
    float* p = ob + (size_t)(q0 + r) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      *reinterpret_cast<float4*>(p + (c + 4 * j) * 4) =
          make_float4(acc[j].x / den, acc[j].y / den, acc[j].z / den, acc[j].w / den);
  }
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           int b, int hq, int hkv, int t, int s, float scale, int causal,
           int window, cudaStream_t stream) {
  const dim3 grid((t + kBM - 1) / kBM, hq, b);
  if (dtype == 0) {
    flash_bf16<D><<<grid, 128, 0, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (__nv_bfloat16*)o, hq, hkv, t, s,
        scale * 1.4426950408889634f, causal, window);
  } else {
    const int bytes = f32_smem_floats<D>() * (int)sizeof(float);
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return (int)err;
    }
    flash_f32<D><<<grid, 256, bytes, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, hq,
        hkv, t, s, scale, causal, window);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 bfloat16, 1 float32.  d: 32, 64 or 128.  window < 0: none.
// All four tensors contiguous and 16-byte aligned; Hq % Hkv == 0.
extern "C" int repro_flash_attention(int dtype, int d, const void* q,
                                     const void* k, const void* v, void* o,
                                     int b, int hq, int hkv, int t, int s,
                                     float scale, int causal, int window,
                                     void* stream) {
  if (b <= 0 || t <= 0 || hq <= 0) return (int)cudaSuccess;
  if ((dtype != 0 && dtype != 1) || hkv <= 0 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 32: return launch<32>(dtype, q, k, v, o, b, hq, hkv, t, s, scale, causal, window, st);
    case 64: return launch<64>(dtype, q, k, v, o, b, hq, hkv, t, s, scale, causal, window, st);
    case 128: return launch<128>(dtype, q, k, v, o, b, hq, hkv, t, s, scale, causal, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
