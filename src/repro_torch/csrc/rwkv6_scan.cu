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
// blocks run in no order, so the loop over T runs inside a block.  With no
// state in, it computes what the Pallas kernel computes; with a state in and
// out it is the reference's `ref.rwkv6(..., state=, return_state=True)`,
// which the prefill path needs.
//
// Design.  Columns of S are independent (out_t[j] reads column j only) and
// the output is a sum over the Dk rows, so a head is spread over many warps:
//   - A block of 4 warps owns (b, h, a tile of 32 columns); the tile is the
//     fastest-varying block index, so a head's tiles run together and their
//     repeated reads of its r/k/w chunk hit L2.  At the served shape (B=4,
//     H=40, Dk=Dv=64) that is 320 blocks, 1,280 warps on 132 SMs.
//   - In a warp, 16 lanes split Dk (Dk/16 rows each) and each lane holds 4
//     columns: a (Dk/16) x 4 piece of S in registers.  A step is 3 FP32
//     instructions an element (an FMA into the output, a multiply and an FMA
//     for the update, S = fmaf(w, S, k·v) as the sequential recurrence has
//     it) on r, k, w and v read from shared memory as float32.
//   - The 16 lanes' partial outputs go to a per-warp shared buffer; every 8
//     steps the warp sums them, adds (Σ r·u·k)·v, and stores the 8 steps x 8
//     columns it owns.  No block barrier on that path.
//   - Chunks of 16 steps (8 at Dk=128, 32 at Dk=16) are loaded a chunk
//     ahead into registers, 16 bytes a load, and converted once to float32
//     into one of two shared buffers, with Σ_i r_i u_i k_i of each step: no
//     bf16 unpack per thread per step, one barrier a chunk.
// The final state is what the sequential recurrence computes element by
// element; only the output's summation order differs.
//
// Bound: at the served prefill shape (B=4, H=40, Dk=Dv=64, T≈1,900) the
// kernel must read r/k/v in bf16 and w in float32 and write bf16, ~0.24 GB
// (~0.07 ms at 3.35 TB/s), and do ~5·Dk·Dv flops a step (~6 GFLOP, ~0.09 ms
// at 67 TFLOP/s on the CUDA cores): operations.  It takes 0.43 ms there
// on an H100 80GB HBM3 at 700 W, 4.6x the bound (PERF.md §6, with the
// variants measured beside it; the previous design, one block per (b, h),
// took 0.66).  The step loop, at 3 warps a scheduler on the SMs that hold
// 3 of the 320 blocks, runs its FP32 work well below the card's rate, and
// the partial sums and the staging add to it.  Fewer instructions an element need the
// chunked form (GLA style), which overflows float32 in
// exp(-cumsum(log w)) at real decays and needs hi + lo products for the
// 3e-4 state check (ROADMAP Queue 2).
//
// Interface: plain C, loaded with ctypes.  The launch goes on the caller's
// stream, does not synchronise and returns `cudaGetLastError()`.  r, k, v,
// w must be 16-byte aligned and Dv a multiple of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kF32 = 0, kBF16 = 1;  // type codes of the inputs
constexpr int kMaxDv = 256;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kLanesK = 16;                 // lanes that split Dk
constexpr int kColsLane = 4;                // columns a lane
constexpr int kColsWarp = 2 * kColsLane;    // 2 column groups a warp
constexpr int kCols = kWarps * kColsWarp;   // columns a block
constexpr int kFlush = 8;                   // steps between output flushes
constexpr int kPart = 32 * kColsLane;       // partial outputs a warp a step
constexpr int kUnroll = 4;

template <int DK>
__host__ __device__ constexpr int chunk_steps() {
  return DK == 16 ? 32 : DK == 128 ? 8 : 16;
}

// float32 slots of one chunk buffer: r, k, w [L][DK], v [L][kCols], Σ ruk [L]
template <int DK>
__host__ __device__ constexpr int buf_floats() {
  return chunk_steps<DK>() * (3 * DK + kCols + 1);
}

// two chunk buffers, u [DK], partials [kWarps][kFlush][kPart]
template <int DK>
__host__ __device__ constexpr int smem_bytes() {
  return 4 * (2 * buf_floats<DK>() + DK + kWarps * kFlush * kPart);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of float32 or bf16 as float32
__device__ __forceinline__ void unpack(const uint4& g, float (&f)[4]) {
  f[0] = __uint_as_float(g.x);
  f[1] = __uint_as_float(g.y);
  f[2] = __uint_as_float(g.z);
  f[3] = __uint_as_float(g.w);
}
__device__ __forceinline__ void unpack(const uint4& g, float (&f)[8]) {
  const unsigned x[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(x[i] << 16);  // the lower address
    f[2 * i + 1] = __uint_as_float(x[i] & 0xffff0000u);
  }
}

// One stream's chunk in registers: up to ROWS rows of ROW_BYTES, granule q
// (16 bytes) of the chunk held by thread q % kThreads.
template <typename T, int ROWS, int ROW_BYTES>
struct Stage {
  static constexpr int kE = 16 / (int)sizeof(T);  // elements a granule
  static constexpr int kPerRow = ROW_BYTES / 16;
  static constexpr int kGranules = ROWS * kPerRow;
  static constexpr int kPer = (kGranules + kThreads - 1) / kThreads;
  uint4 g[kPer];

  // rows [0, rows) from src (row stride `stride` elements), the first
  // `valid` elements of each; the rest zeros
  __device__ __forceinline__ void load(const T* __restrict__ src,
                                       long long stride, int rows, int valid,
                                       int tid) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int q = tid + j * kThreads;
      const int s = q / kPerRow, e = (q % kPerRow) * kE;
      g[j] = make_uint4(0u, 0u, 0u, 0u);
      if (q < kGranules && s < rows && e < valid)
        g[j] = __ldg(reinterpret_cast<const uint4*>(src + s * stride + e));
    }
  }

  // as float32 into dst [ROWS][ROW_BYTES / sizeof(T)]
  __device__ __forceinline__ void put(float* dst, int tid) const {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int q = tid + j * kThreads;
      if (q < kGranules) {
        float f[kE];
        unpack(g[j], f);
        float4* d = reinterpret_cast<float4*>(dst + q * kE);
#pragma unroll
        for (int i = 0; i < kE / 4; ++i)
          d[i] = make_float4(f[4 * i], f[4 * i + 1], f[4 * i + 2],
                             f[4 * i + 3]);
      }
    }
  }
};

// Σ_i r_i u_i k_i of every step of the chunk into ruk [ROWS]: each thread
// sums its granules, the kPerRow consecutive lanes of a row add up theirs
template <typename S>
__device__ __forceinline__ void sum_ruk(const S& sr, const S& sk,
                                        const float* su, float* ruk,
                                        int tid) {
#pragma unroll
  for (int j = 0; j < S::kPer; ++j) {
    const int q = tid + j * kThreads;
    float fr[S::kE], fk[S::kE];
    unpack(sr.g[j], fr);
    unpack(sk.g[j], fk);
    const int i0 = (q % S::kPerRow) * S::kE;
    float acc = 0.f;
#pragma unroll
    for (int e = 0; e < S::kE; ++e) acc = fmaf(fr[e] * su[i0 + e], fk[e], acc);
#pragma unroll
    for (int o = S::kPerRow / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (q < S::kGranules && q % S::kPerRow == 0) ruk[q / S::kPerRow] = acc;
  }
}

// N consecutive float32 from shared memory
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&x)[N]) {
  if constexpr (N == 1) {
    x[0] = *p;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x;
    x[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      x[4 * i] = t.x;
      x[4 * i + 1] = t.y;
      x[4 * i + 2] = t.z;
      x[4 * i + 3] = t.w;
    }
  }
}

template <int DK, typename TR, typename TW>
__global__ void __launch_bounds__(kThreads)
    wkv6_kernel(const TR* __restrict__ r, const TR* __restrict__ k,
                const TR* __restrict__ v, const TW* __restrict__ w,
                const void* __restrict__ u, int cu,
                const float* __restrict__ state_in,
                float* __restrict__ state_out, TR* __restrict__ out, int H,
                int T, int DV, int ntile) {
  constexpr int L = chunk_steps<DK>();
  constexpr int R = DK / kLanesK;  // rows a lane
  constexpr int kBuf = buf_floats<DK>();
  extern __shared__ __align__(16) float smem[];
  float* su = smem + 2 * kBuf;  // u [DK]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* part = su + DK + warp * kFlush * kPart;  // this warp's partials

  const int tile = blockIdx.x % ntile;
  const int bh = blockIdx.x / ntile;
  const int h = bh % H;
  const int col0 = tile * kCols;
  const int cols = min(kCols, DV - col0);  // a multiple of 8
  const int wc = warp * kColsWarp;         // the warp's first column
  const bool active = wc < cols;
  const int p = lane & (kLanesK - 1), cg = lane >> 4;
  const int lc = wc + cg * kColsLane;  // the lane's first column in the tile
  const long long row0 = (long long)bh * T;  // the first step's row

  Stage<TR, L, DK * (int)sizeof(TR)> sr, sk;
  Stage<TW, L, DK * (int)sizeof(TW)> sw;
  Stage<TR, L, kCols * (int)sizeof(TR)> sv;
  auto load = [&](int c) {
    const int t0 = c * L, n = min(L, T - t0);
    const long long rk = (row0 + t0) * DK;
    sr.load(r + rk, DK, n, DK, tid);
    sk.load(k + rk, DK, n, DK, tid);
    sw.load(w + rk, DK, n, DK, tid);
    sv.load(v + (row0 + t0) * DV + col0, DV, n, cols, tid);
  };
  auto put = [&](int c) {
    float* b = smem + (c & 1) * kBuf;
    sr.put(b, tid);
    sk.put(b + L * DK, tid);
    sw.put(b + 2 * L * DK, tid);
    sv.put(b + 3 * L * DK, tid);
    sum_ruk(sr, sk, su, b + 3 * L * DK + L * kCols, tid);
  };

  const int chunks = (T + L - 1) / L;
  if (chunks > 0) load(0);
  for (int i = tid; i < DK; i += kThreads) {
    su[i] = cu == kBF16
                ? __bfloat162float(static_cast<const bf16*>(u)[h * DK + i])
                : static_cast<const float*>(u)[h * DK + i];
  }
  float S[R][kColsLane];
  const long long srow = (long long)bh * DK + p * R;
#pragma unroll
  for (int x = 0; x < R; ++x)
#pragma unroll
    for (int c = 0; c < kColsLane; ++c)
      S[x][c] = state_in != nullptr && active
                    ? state_in[(srow + x) * DV + col0 + lc + c]
                    : 0.f;
  __syncthreads();  // su
  if (chunks > 0) put(0);
  __syncthreads();

  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) load(c + 1);  // in flight while chunk c runs
    const float* rf = smem + (c & 1) * kBuf;
    const float* kf = rf + L * DK;
    const float* wf = rf + 2 * L * DK;
    const float* vf = rf + 3 * L * DK;
    const float* ruk = vf + L * kCols;
    const int t0 = c * L, n = min(L, T - t0);
    if (active) {
      for (int s0 = 0; s0 < n; s0 += kFlush) {
        const int m = min(kFlush, n - s0);
#pragma unroll kUnroll
        for (int i = 0; i < m; ++i) {
          const int s = s0 + i;
          float vc[kColsLane], rr[R], kk[R], ww[R];
          lds(vf + s * kCols + lc, vc);
          lds(rf + s * DK + p * R, rr);
          lds(kf + s * DK + p * R, kk);
          lds(wf + s * DK + p * R, ww);
          float a[kColsLane] = {};
#pragma unroll
          for (int x = 0; x < R; ++x) {
#pragma unroll
            for (int cc = 0; cc < kColsLane; ++cc) {
              a[cc] = fmaf(rr[x], S[x][cc], a[cc]);
              S[x][cc] = fmaf(ww[x], S[x][cc], kk[x] * vc[cc]);
            }
          }
          // partials [column block][16 lanes]; column cc of group cg goes
          // to block cg*4 + (cc ^ cg), so the two groups' stores of one cc
          // fall on different banks
          float* ps = part + i * kPart + cg * kColsLane * kLanesK + p;
#pragma unroll
          for (int cc = 0; cc < kColsLane; ++cc)
            ps[(cc ^ cg) * kLanesK] = a[cc];
        }
        __syncwarp();
        // lane -> (column o of the warp's 8, step i of 4 a pass); the 16
        // partials of a column are read in an order rotated by o / 2 and
        // the step, so the 8 lanes of a quarter-warp hit 8 bank groups
        const int o = lane & 7, og = o >> 2;
        const int blk = og * kColsLane + ((o & 3) ^ og);
        for (int i = lane >> 3; i < m; i += 4) {
          const float4* q =
              reinterpret_cast<const float4*>(part + i * kPart + blk * kLanesK);
          float y = 0.f;
#pragma unroll
          for (int it = 0; it < 4; ++it) {
            const float4 t4 = q[(it + (o >> 1) + 2 * i) & 3];
            y += (t4.x + t4.y) + (t4.z + t4.w);
          }
          const int s = s0 + i;
          y = fmaf(ruk[s], vf[s * kCols + wc + o], y);
          store(out + (row0 + t0 + s) * DV + col0 + wc + o, y);
        }
        __syncwarp();
      }
    }
    if (c + 1 < chunks) put(c + 1);  // into the other buffer
    __syncthreads();
  }
  if (state_out != nullptr && active) {
#pragma unroll
    for (int x = 0; x < R; ++x)
#pragma unroll
      for (int c = 0; c < kColsLane; ++c)
        state_out[(srow + x) * DV + col0 + lc + c] = S[x][c];
  }
}

template <int DK, typename TR, typename TW>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, int cu, const float* state_in, float* state_out,
           void* out, int bh, int H, int T, int DV, cudaStream_t stream) {
  static_assert(smem_bytes<DK>() <= 48 * 1024, "shared memory over 48 KB");
  const int ntile = (DV + kCols - 1) / kCols;
  const long long blocks = (long long)bh * ntile;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  wkv6_kernel<DK, TR, TW><<<(unsigned)blocks, kThreads, smem_bytes<DK>(),
                            stream>>>(
      (const TR*)r, (const TR*)k, (const TR*)v, (const TW*)w, u, cu, state_in,
      state_out, (TR*)out, H, T, DV, ntile);
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
// w, cu for u.  state_in and state_out may be null.  bh = B·H heads, each
// ceil(dv / 32) blocks of 128 threads.
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
