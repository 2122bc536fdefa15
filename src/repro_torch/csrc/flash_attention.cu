// flash_attention — causal / sliding-window GQA attention with an online
// softmax, q [B,Hq,T,D] and k/v [B,Hkv,S,D] -> o [B,Hq,T,D].
//
// Replaces the Pallas TPU kernel
// `repro/kernels/flash_attention.py:flash_attention` (`pl.pallas_call` at
// line 112).  Same contract: scale d^-0.5 unless given; q row i sits at
// position i + S - T of the kv timeline; causal keeps k_pos <= q_pos, a
// window keeps k_pos > q_pos - window; running max, denominator and
// accumulator in float32; masked logits contribute nothing; the output is
// acc / max(l, 1e-30) in q's type, so a row with no live key is 0.  KV
// tiles that no row of a query tile can see are never loaded.
//
// The TPU kernel walks the KV tiles as the sequential last grid axis and
// carries (m, l, acc) in VMEM scratch from one grid step to the next.  On
// Hopper blocks run in no order, so a block owns a (b, h, query tile) and
// loops over its live KV tiles itself, with (m, l, acc) in registers.  The
// GQA KV head is h / (Hq / Hkv), as the TPU index maps have it.  T and S
// need not be multiples of the tiles: ragged rows and keys are masked (the
// reference wrapper instead shrinks its blocks to divisors of T, down to 1
// for a prime prompt length).
//
// Two kernels, by input type:
//  - bf16 (`flash_bf16_wgmma`), for every head dim.  Bound: operations (at
//    T = S = 1,895, D = 128 the causal work is ~1,600 flops per byte moved,
//    far above the card's ~295 flops per byte for bf16), so the design is
//    about keeping the tensor cores fed:
//      * `wgmma` — the only way to the card's full tensor-core rate: a
//        block holds 128 query rows in two consumer warpgroups of 64;
//        each computes S = Q K^T for a 128-key tile with Q and K read from
//        shared memory (`m64n128k16`), the online softmax in registers,
//        and O += P V with P from registers as the A operand and V read
//        from shared memory through the transpose bit.  The two
//        warpgroups take turns at issuing S (named barriers), so one's
//        softmax overlaps the other's products.  A third warpgroup is the
//        producer; `setmaxnreg` moves registers from it to the consumers
//        (240 a thread; at the 168 a 384-thread block starts with, the
//        consumers spilled).  Issuing the next tile's S before this tile's
//        P V within a warpgroup measured no faster at the served shapes.
//      * TMA — one producer thread keeps the loads in flight: Q, then K and
//        V tiles into a two-stage ring in shared memory (128-byte swizzle,
//        64 columns per box; D = 128 is two boxes, D = 32 is zero-filled
//        to 64 and D = 96 to 128: zero columns add nothing to Q K^T, and
//        P V's padded output columns are never stored), each stage with its own full and empty `mbarrier`s for K
//        and V, so a K tile is reloaded as soon as S is computed.  The
//        tensor maps carry the tensors' strides: the prefill's q/k/v —
//        [B,T,H,D] memory viewed as [B,H,T,D] — are read where they lie,
//        and o is written through its strides.  Reads past T, S or D are
//        zero-filled by the TMA unit; masked keys of the last tile still
//        get the `kpos < s` predicate, since a zero key is a logit of 0.
//      * Persistent blocks, one per SM, walk the (query tile, head,
//        batch) items heaviest first (the last query tiles under a causal
//        mask see the most keys); the producer loads the next item's Q
//        and K/V while the consumers finish the last one.
//      * The causal / window / ragged-key predicate is evaluated only on
//        tiles that straddle an edge for a warp's 16 rows; a full tile
//        takes the raw row max and one FFMA into `ex2` per element.
//      * P V carries P as two bf16 parts, hi = bf16(p) and lo = bf16(p -
//        hi): two products into one float32 accumulator, so P is good to
//        ~16 bits where one bf16 carries 8, close to the reference's
//        float32 P V.  It costs a third more tensor work; with P rounded
//        to bf16 once the served model's prefill logits drifted past the
//        5e-2 they are held to against plain attention (PERF.md §6).
//        The row sums stay float32.
//  - f32 (`flash_f32`): CUDA-core FMAs over 64-row query tiles and 32-key
//    tiles, for inputs that must not be rounded.  Four threads share a
//    query row.  It takes contiguous tensors only.
//
// Interface: plain C, loaded with ctypes.  The launch goes on the caller's
// stream, does not synchronise and returns `cudaGetLastError()`.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;

struct Range {
  int begin, end;  // KV tiles [begin, end)
};

// (batch, head, row) strides of one tensor, in elements
struct Strides {
  long long b, h, t;
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA, warp-specialised, persistent
// ---------------------------------------------------------------------------
constexpr int kBM = 128;        // query rows per item: 2 consumer warpgroups
constexpr int kBN = 128;        // keys per tile
constexpr int kStages = 2;      // K/V ring depth
constexpr int kThreads = 384;   // 2 consumer warpgroups + a producer one

// Shared memory for a padded head dim DP (64 or 128): Q, then the stages of
// K and V, each as DP / 64 chunks of [rows][64] bf16 rows of 128 bytes in
// the 128-byte swizzle TMA writes and wgmma reads; then the barriers.  The
// base is rounded up to 1024 bytes, the swizzle's period.
template <int DP>
struct Smem {
  static constexpr int kQBytes = kBM * DP * 2;
  static constexpr int kTileBytes = kBN * DP * 2;  // one K or V tile
  static constexpr int kBar = kQBytes + kStages * 2 * kTileBytes;
  static constexpr int kBytes = kBar + 128 + 1024;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait until the barrier's phase of this parity has completed.  Every wait
// of the kernel lasts at most a tile's load or compute, so a wait that
// spins 2^24 times is a fault: trap, rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (int spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (spins == (1 << 24)) __trap();
  }
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor, 128-byte swizzle: start address, the
// leading (LBO) and stride (SBO) byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until every committed group of this warpgroup is done
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// 2^x on the special-function unit (flush-to-zero, ~2 ulp); 2^-huge is 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns the registers
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d (+)= A·B, m64n128k16: A [64 x 16] and B [128 x 16], both K-major in
// shared memory (128-byte swizzle); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      " %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A·B, m64n128k16: A [64 x 16] bf16 from registers (per warp, the
// mma.sync m16n8k16 A fragment), B [16 x 128] MN-major in shared memory
// (128-byte swizzle, the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      " %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A·B, m64n64k16: A [64 x 16] bf16 from registers (per warp, the
// mma.sync m16n8k16 A fragment), B [16 x 64] MN-major in shared memory
// (128-byte swizzle, the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <bool MASK>
__device__ __forceinline__ void softmax_rows(float (&sacc)[kBN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0,
                                             int qpos0, int s, int causal,
                                             int window, float scale_log2,
                                             int tg) {
  // a tile with every key live and a positive scale takes the row max of
  // the raw logits and one FFMA into ex2 per element
  const bool fast = !MASK && scale_log2 > 0.f;
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sacc[n * 4 + e];
      if (!fast) {
        x *= scale_log2;
        if (MASK) {
          const int kpos = k0 + n * 8 + tg * 2 + (e & 1);
          if (!live(kpos, e < 2 ? qpos0 : qpos0 + 8, s, causal, window))
            x = kNeg;
        }
        sacc[n * 4 + e] = x;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (fast) mx[i] *= scale_log2;
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float mnew = fmaxf(m[i], mx[i]);
    alpha[i] = ex2(m[i] - mnew);
    m[i] = mnew;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = sacc[n * 4 + e];
      float p;
      if (fast)
        p = ex2(fmaf(x, scale_log2, -m[e >> 1]));
      else
        p = (MASK && x == kNeg) ? 0.f : ex2(x - m[e >> 1]);
      sacc[n * 4 + e] = p;
      l[e >> 1] += p;
    }
  }
}

// P as the A fragments of P·V, in two bf16 parts: hi = bf16(p) and lo =
// bf16(p - hi), so hi + lo carries p to ~16 bits where one bf16 would carry
// 8; and the output rows rescaled by alpha.  The wgmma accumulator of a
// warp is the mma.sync C layout over 8-key groups, so two adjacent groups
// make one 16-key A fragment.
template <int DP>
__device__ __forceinline__ void pack_p(const float (&sacc)[kBN / 2],
                                       uint32_t (&p_hi)[kBN / 16][4],
                                       uint32_t (&p_lo)[kBN / 16][4],
                                       float (&oacc)[DP / 2],
                                       const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < kBN / 2; i += 2) {
    // sacc[i], sacc[i + 1]: group n = i / 4, row g (i % 4 == 0) or g + 8
    const int kk = i / 8, r = (i / 4) % 2 * 2 + (i % 4) / 2;
    const __nv_bfloat162 h = __floats2bfloat162_rn(sacc[i], sacc[i + 1]);
    p_hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
    p_lo[kk][r] = pack_bf16(sacc[i] - __low2float(h),
                            sacc[i + 1] - __high2float(h));
  }
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    oacc[n * 4 + 0] *= alpha[0];
    oacc[n * 4 + 1] *= alpha[0];
    oacc[n * 4 + 2] *= alpha[1];
    oacc[n * 4 + 3] *= alpha[1];
  }
}

// S = Q K^T for one warpgroup's 64 rows and one K tile, asynchronously:
// Q rows and K rows are [rows][64] chunks, 16 columns (32 bytes) a step;
// LBO is unused in this swizzle, SBO is the 1,024 bytes of 8 rows.
template <int DP>
__device__ __forceinline__ void issue_s(float (&sacc)[kBN / 2], uint32_t sQw,
                                        uint32_t sK) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t da =
        wgmma_desc(sQw + (kk / 4) * kBM * 128 + off, 16, 1024);
    const uint64_t db =
        wgmma_desc(sK + (kk / 4) * kBN * 128 + off, 16, 1024);
    wgmma_ss_n128(sacc, da, db, kk > 0 ? 1 : 0);
  }
  wgmma_commit();
}

// O += P V for one warpgroup, asynchronously, P as its two bf16 parts.  V
// is [keys][64] per chunk: 16 keys a step (two groups of 8 rows, SBO 1,024
// bytes), the chunks one chunk apart (LBO).
template <int DP>
__device__ __forceinline__ void issue_pv(float (&oacc)[DP / 2],
                                         const uint32_t (&p_hi)[kBN / 16][4],
                                         const uint32_t (&p_lo)[kBN / 16][4],
                                         uint32_t sV) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint64_t db = wgmma_desc(sV + kk * 16 * 128, kBN * 128, 1024);
    if constexpr (DP == 128) {
      wgmma_rs_n128(oacc, p_hi[kk], db);
      wgmma_rs_n128(oacc, p_lo[kk], db);
    } else {
      wgmma_rs_n64(oacc, p_hi[kk], db);
      wgmma_rs_n64(oacc, p_lo[kk], db);
    }
  }
  wgmma_commit();
}

// The softmax of one tile for a warp whose first position is plo: the
// predicate is evaluated only where the tile straddles an edge of the
// warp's 16 rows.
__device__ __forceinline__ void softmax_tile(float (&sacc)[kBN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0,
                                             int plo, int g, int s,
                                             int causal, int window,
                                             float scale_log2, int tg) {
  const bool full = k0 + kBN <= s && (!causal || k0 + kBN - 1 <= plo) &&
                    (window < 0 || k0 > plo + 15 - window);
  if (full)
    softmax_rows<false>(sacc, m, l, alpha, k0, plo + g, s, causal, window,
                        scale_log2, tg);
  else
    softmax_rows<true>(sacc, m, l, alpha, k0, plo + g, s, causal, window,
                       scale_log2, tg);
}

// Named barriers 1 and 2 make the two consumer warpgroups take turns at
// issuing S, so one's softmax runs while the other's products do: a
// warpgroup waits on its own barrier (256 threads: itself and the other's
// arrival) and arrives on the other's.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// The item-th work item, heaviest first: (query tile, head, batch).
__device__ __forceinline__ void decode_item(int item, int hq, int b, int nqt,
                                            int& q0, int& h, int& bb) {
  const int per = hq * b;
  q0 = (nqt - 1 - item / per) * kBM;
  h = item % per % hq;
  bb = item % per / hq;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bf16_wgmma(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     __nv_bfloat16* __restrict__ o, Strides os, int b,
                     int hq, int hkv, int t, int s, float scale_log2,
                     int causal, int window) {
  constexpr int DP = D <= 64 ? 64 : 128;  // TMA zero-fills the padding
  constexpr int NCH = DP / 64;         // 64-column chunks of a row
  using L = Smem<DP>;
  extern __shared__ __align__(1024) uint8_t ws_smem[];
  const uint32_t base = (smem_addr(ws_smem) + 1023u) & ~1023u;
  const uint32_t sQ = base, sKV = base + L::kQBytes, bar = base + L::kBar;
  // barriers: Q full and empty, then per stage K full, V full, K empty,
  // V empty
  const uint32_t q_full = bar, q_empty = bar + 8;
#define K_FULL(st) (bar + 16 + 32 * (st))
#define V_FULL(st) (bar + 24 + 32 * (st))
#define K_EMPTY(st) (bar + 32 + 32 * (st))
#define V_EMPTY(st) (bar + 40 + 32 * (st))
#define SK(n) (sKV + ((n) % kStages) * 2 * L::kTileBytes)  // ring slot n
#define PH(n) (((n) / kStages) & 1)

  const int tid = threadIdx.x, wg = tid >> 7;
  const int nqt = (t + kBM - 1) / kBM, items = nqt * hq * b;
  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2);  // one arrival per consumer warpgroup
    for (int st = 0; st < kStages; ++st) {
      mbar_init(K_FULL(st), 1);
      mbar_init(V_FULL(st), 1);
      mbar_init(K_EMPTY(st), 2);
      mbar_init(V_EMPTY(st), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // One if / else, so that the two roles never reconverge and the register
  // reallocation holds: the producer warpgroup gives registers up (one of
  // its threads issues every load), the consumers take them.
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid != 256) return;
    int n = 0;  // K/V tiles loaded so far, over all items
    for (int item = blockIdx.x, j = 0; item < items;
         item += gridDim.x, ++j) {
      int q0, h, bb;
      decode_item(item, hq, b, nqt, q0, h, bb);
      const Range rg = kv_tiles(q0, min(kBM, t - q0), t, s, kBN, causal,
                                window);
      if (j > 0) mbar_wait(q_empty, (j - 1) & 1);
      mbar_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < NCH; ++c)
        tma_load(sQ + c * kBM * 128, &tq, q_full, c * 64, q0, h, bb);
      for (int kt = rg.begin; kt < rg.end; ++kt, ++n) {
        const int st = n % kStages, hk = h / (hq / hkv);
        if (n >= kStages) mbar_wait(K_EMPTY(st), PH(n) ^ 1);
        mbar_expect_tx(K_FULL(st), L::kTileBytes);
        for (int c = 0; c < NCH; ++c)
          tma_load(SK(n) + c * kBN * 128, &tk, K_FULL(st), c * 64, kt * kBN,
                   hk, bb);
        if (n >= kStages) mbar_wait(V_EMPTY(st), PH(n) ^ 1);
        mbar_expect_tx(V_FULL(st), L::kTileBytes);
        for (int c = 0; c < NCH; ++c)
          tma_load(SK(n) + L::kTileBytes + c * kBN * 128, &tv, V_FULL(st),
                   c * 64, kt * kBN, hk, bb);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    // consumers: warpgroup wg (warps 4 wg .. 4 wg + 3) owns rows [64 wg,
    // 64 wg + 64) of each item's query tile
    const int ctid = tid & 127, warp = ctid >> 5, lane = ctid & 31;
    const int g = lane >> 2, tg = lane & 3;
    const uint32_t sQw = sQ + wg * 64 * 128;  // this warpgroup's Q rows
    int n = 0;  // K/V tiles consumed so far, over all items
    for (int item = blockIdx.x, j = 0; item < items; item += gridDim.x, ++j) {
      int q0, h, bb;
      decode_item(item, hq, b, nqt, q0, h, bb);
      const Range rg = kv_tiles(q0, min(kBM, t - q0), t, s, kBN, causal,
                                window);
      // the tiles some row of this warpgroup sees; it only waits for and
      // releases the item's others
      const int wq0 = q0 + wg * 64;
      const int plo = wq0 + warp * 16 + (s - t);  // the warp's first position
      const Range wr = wq0 < t ? kv_tiles(wq0, min(64, t - wq0), t, s, kBN,
                                          causal, window)
                               : Range{rg.begin, rg.begin};
      const int wb = max(wr.begin, rg.begin);
      const int we = max(min(wr.end, rg.end), wb);
      float oacc[DP / 2], sacc[kBN / 2], alpha[2];
      uint32_t p_hi[kBN / 16][4], p_lo[kBN / 16][4];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
      float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

      if (j == 0 && wg == 1) named_arrive(1);  // warpgroup 0 goes first
      mbar_wait(q_full, j & 1);
      if (wb == we && ctid == 0) mbar_arrive(q_empty);
      for (int kt = rg.begin; kt < rg.end; ++kt, ++n) {
        const int st = n % kStages;
        if (kt < wb || kt >= we) {  // a tile no row here sees: pass it on
          named_sync(1 + wg);  // keep the two warpgroups' turns in step
          named_arrive(2 - wg);
          mbar_wait(K_FULL(st), PH(n));
          mbar_wait(V_FULL(st), PH(n));
          if (ctid == 0) {
            mbar_arrive(K_EMPTY(st));
            mbar_arrive(V_EMPTY(st));
          }
          continue;
        }
        mbar_wait(K_FULL(st), PH(n));
        fence_regs(oacc);
        named_sync(1 + wg);  // the other warpgroup's S is issued
        issue_s<DP>(sacc, sQw, SK(n));
        named_arrive(2 - wg);  // its turn
        wgmma_wait();
        fence_regs(sacc);
        if (ctid == 0) {
          mbar_arrive(K_EMPTY(st));
          if (kt == we - 1) mbar_arrive(q_empty);  // Q's last read
        }
        softmax_tile(sacc, m, l, alpha, kt * kBN, plo, g, s, causal, window,
                     scale_log2, tg);
        pack_p<DP>(sacc, p_hi, p_lo, oacc, alpha);
        mbar_wait(V_FULL(st), PH(n));
        issue_pv<DP>(oacc, p_hi, p_lo, SK(n) + L::kTileBytes);
        wgmma_wait();
        fence_regs(oacc);
        if (ctid == 0) mbar_arrive(V_EMPTY(st));
      }

#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        l[i] = 1.f / fmaxf(l[i], 1e-30f);
      }
      const int r0 = wq0 + warp * 16 + g;
      __nv_bfloat16* ob = o + bb * os.b + h * os.h + tg * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + 8 * half;
        if (r < t) {
          __nv_bfloat16* p = ob + (long long)r * os.t;
#pragma unroll
          for (int c = 0; c < D / 8; ++c)
            *reinterpret_cast<__nv_bfloat162*>(p + c * 8) =
                __floats2bfloat162_rn(oacc[c * 4 + 2 * half] * l[half],
                                      oacc[c * 4 + 2 * half + 1] * l[half]);
        }
      }
    }
  }
#undef K_FULL
#undef V_FULL
#undef K_EMPTY
#undef V_EMPTY
#undef SK
#undef PH
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs
// ---------------------------------------------------------------------------
constexpr int kF32BM = 64;  // query rows per block
constexpr int kF32BN = 32;  // keys per tile

template <int D>
constexpr int f32_smem_floats() {
  return (kF32BM + 2 * kF32BN) * (D + 4) + kF32BM * (kF32BN + 1);
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
  float* sQ = smem;            // [kF32BM][LD]
  float* sK = sQ + kF32BM * LD;   // [BN][LD]
  float* sV = sK + BN * LD;    // [BN][LD]
  float* sP = sV + BN * LD;    // [kF32BM][PL]

  const int tid = threadIdx.x, r = tid >> 2, c = tid & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kF32BM;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (hq / hkv);
  const float* qb = q + ((size_t)b * hq + h) * t * D;
  const float* kb = k + ((size_t)b * hkv + hk) * s * D;
  const float* vb = v + ((size_t)b * hkv + hk) * s * D;
  float* ob = o + ((size_t)b * hq + h) * t * D;

  for (int i = tid; i < kF32BM * C4; i += 256) {
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
  const Range rg = kv_tiles(q0, min(kF32BM, t - q0), t, s, BN, causal, window);

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

// cuTensorMapEncodeTiled lives in libcuda, which the library does not link:
// it is resolved once through the runtime's entry-point query
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [B][H][rows][d] bf16 tensor with element strides st = (batch, head,
// row) as a 4-D map (d, rows, H, B) read in boxes of 64 columns by
// `box_rows` rows, 128-byte swizzle; reads past d or rows are zero-filled.
int tensor_map(CUtensorMap* map, const void* ptr, int d, int rows, int heads,
               int batch, const long long* st, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const long long ext[3] = {rows, heads, batch};
  const long long el[3] = {st[2], st[1], st[0]};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)  // a dimension of one: any aligned stride
    strides[i] = (cuuint64_t)(ext[i] > 1 ? el[i] * 2 : 16);
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int b,
                int hq, int hkv, int t, int s, const long long* st,
                float scale, int causal, int window, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = tensor_map(&mq, q, D, t, hq, b, st, kBM);
  if (!err) err = tensor_map(&mk, k, D, s, hkv, b, st + 3, kBN);
  if (!err) err = tensor_map(&mv, v, D, s, hkv, b, st + 6, kBN);
  if (err) return err;
  constexpr int bytes = Smem<(D <= 64 ? 64 : 128)>::kBytes;
  static int sms = 0;  // the attribute and the SM count, once per process
  if (sms == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bf16_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    int dev = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const long long items = (long long)((t + kBM - 1) / kBM) * hq * b;
  const int grid = (int)(items < sms ? items : sms);
  flash_bf16_wgmma<D><<<grid, kThreads, bytes, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, Strides{st[9], st[10], st[11]}, b, hq,
      hkv, t, s, scale * 1.4426950408889634f, causal, window);
  return (int)cudaGetLastError();
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           int b, int hq, int hkv, int t, int s, const long long* st,
           float scale, int causal, int window, cudaStream_t stream) {
  if (dtype == 0)
    return launch_bf16<D>(q, k, v, o, b, hq, hkv, t, s, st, scale, causal,
                          window, stream);
  const int bytes = f32_smem_floats<D>() * (int)sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((t + kF32BM - 1) / kF32BM, hq, b);
  flash_f32<D><<<grid, 256, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, hq, hkv,
      t, s, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 bfloat16, 1 float32.  d: 32, 64, 96 or 128.  window < 0: none.
// strides: 12 element strides, (batch, head, row) of q, k, v and o; the
// head dimension is contiguous and every row 16-byte aligned.  The f32
// kernel takes contiguous tensors only.  Hq % Hkv == 0.
extern "C" int repro_flash_attention(int dtype, int d, const void* q,
                                     const void* k, const void* v, void* o,
                                     int b, int hq, int hkv, int t, int s,
                                     const long long* strides, float scale,
                                     int causal, int window, void* stream) {
  if (b <= 0 || t <= 0 || hq <= 0) return (int)cudaSuccess;
  if ((dtype != 0 && dtype != 1) || hkv <= 0 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 32: return launch<32>(dtype, q, k, v, o, b, hq, hkv, t, s, strides, scale, causal, window, st);
    case 64: return launch<64>(dtype, q, k, v, o, b, hq, hkv, t, s, strides, scale, causal, window, st);
    case 96: return launch<96>(dtype, q, k, v, o, b, hq, hkv, t, s, strides, scale, causal, window, st);
    case 128: return launch<128>(dtype, q, k, v, o, b, hq, hkv, t, s, strides, scale, causal, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
