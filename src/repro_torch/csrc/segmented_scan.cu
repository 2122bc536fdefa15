// segmented_scan — inclusive segmented add/max/min scan with reset flags,
// and its segment_reduce entry (each segment's total, scattered to its id).
//
// Replaces the Pallas TPU kernel `repro/kernels/segmented_scan.py:
// segmented_scan` (`pl.pallas_call` at line 83).  The TPU form walks
// 512-row blocks in grid order and carries the running value in VMEM from
// one grid step to the next.  Hopper runs blocks in parallel and in no
// order, so the carry crosses blocks by a single-pass scan with decoupled
// look-back: one launch a call.
//
// Design.  A block takes its 2,048-row tile from an atomic ticket, not from
// blockIdx, so tiles start in launch order and a tile waits in look-back
// only on tiles whose blocks already run (no deadlock).  Each of 256
// threads loads its 8 consecutive rows once (values, ids and mask; 16-byte
// loads where aligned) and keeps them in registers.  Then:
//   1. each thread folds its rows, a warp shuffle scan and one barrier
//      give every thread its exclusive prefix inside the tile and warp 0
//      the tile's aggregate (the value after its last reset);
//   2. warp 0 publishes the aggregate — a tile that holds a reset (and
//      tile 0) publishes its inclusive prefix at once — then looks back
//      over the tiles before it, 128 status words at a time, for the
//      nearest published prefix, folds the aggregates after it, and
//      publishes its inclusive prefix;
//   3. each thread rescans its rows from its carry and writes them: the
//      whole scan, or for segment_reduce each segment's last row only.
// The combine is the classic segmented one, (v1,f1)·(v2,f2) = (f2 ? v2 :
// v1∘v2, f1|f2); rows before the first reset form one open segment seeded
// with the op identity, as in the reference.  Values stay in their native
// type (int64 or float64): integer sums are exact, unlike the TPU
// wrapper's float32 cast.
//
// segment_reduce does its wrapper's tensor work here: a row is a reset
// when its id differs from the previous row's (row 0 always is); an
// invalid row takes identity_for(op) (0, or the dtype's finite min/max);
// and since ids are nondecreasing over all rows, every output slot has
// exactly one writer, so the output needs no fill launch: a segment's last
// row writes its total, a reset row fills the empty ids strictly between
// the previous row's id and its own with scan_identity (0, ±inf, the
// integer bounds), and all blocks together fill the ids before the first
// row's and after the last row's.  Ids outside [0, num_segments) write
// nothing.
//
// Determinism of float add (float add is not associative).  The textbook
// look-back combines whatever its predecessors have published when it
// looks, so a segment spanning three or more tiles would get different
// last bits from run to run.  Here the carry into tile t is always the
// LEFT fold, in tile order, of the aggregates since the nearest tile k <= t-1
// that holds a reset: C_t = ((A_k ∘ A_k+1) ∘ ...) ∘ A_t-1, and the
// inclusive prefix tile t publishes is C_t ∘ A_t, the same fold one step
// further.  A look-back that stops at the nearest published inclusive
// prefix P_j (a reset tile publishes P_k = A_k) and folds A_j+1 .. A_t-1
// onto it left to right therefore gets C_t bit for bit, wherever it
// stopped.  Inside a tile the association is fixed by the thread layout.
// So two calls on the same inputs give the same bits for every op.  The
// price is a serial fold: a tile far from the nearest published prefix
// (a long run of rows without a reset, such as a packed batch's invalid
// tail) folds every aggregate in between, one after another (lane 0, from
// shared memory).  Integer add, max and min would not need the order, but
// take the same path.
//
// Scratch, without a memset launch or a per-call allocation: one 64-bit
// ticket word, epoch (40 bits) << 24 | tickets taken (24 bits), and per
// tile a 64-bit status word (epoch << 2 | state), C aggregate words and C
// prefix words.  A block's one atomic add on the ticket word gives it both
// its tile and the launch's epoch; a status word counts only when it
// carries that epoch, so words left by earlier calls are ignored.  The
// block that takes the launch's last ticket sets the word to the next
// epoch and no ticket, so the state lives on the card (a launch captured
// in a CUDA graph replays correctly) and no block waits at its end.  The
// epoch wraps after 2^40 calls.  The wrapper caches the scratch per device
// and stream and grows it when needed.
//
// Bound: bytes — values, ids and mask read once, the scan or the
// num_segments slots written once.
//
// Interface: plain C, loaded with ctypes.  The launch goes on the caller's
// stream, does not synchronise, and its error is returned.

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                                // rows a thread
constexpr long long kTile = (long long)kThreads * kItems;
constexpr int kMaxC = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLook = 4;                   // status words a lane reads a step
constexpr int kWindow = 32 * kLook;        // tiles a look-back step reads
constexpr unsigned kSpinNs = 32;           // first back-off of a waiting lane
constexpr unsigned kSpinMaxNs = 256;
constexpr int kTicketBits = 24;
constexpr unsigned long long kTicketMask = (1ull << kTicketBits) - 1;

enum { kAdd = 0, kMax = 1, kMin = 2 };
enum : unsigned { kInvalid = 0, kAggregate = 1, kPrefix = 2 };

// Scratch layout: the ticket word (padded to 16 bytes), status[tiles],
// agg[tiles][kMaxC] and pre[tiles][kMaxC], all 64-bit words.
constexpr long long kFixedBytes = 16;
constexpr long long kTileBytes = 8 + 2 * kMaxC * 8;

struct Scratch {
  unsigned long long* ticket;
  unsigned long long* status;
  unsigned long long* agg;
  unsigned long long* pre;
};

__device__ inline Scratch scratch_view(unsigned char* p, long long bytes) {
  const long long tiles = (bytes - kFixedBytes) / kTileBytes;
  Scratch s;
  s.ticket = reinterpret_cast<unsigned long long*>(p);
  s.status = reinterpret_cast<unsigned long long*>(p + kFixedBytes);
  s.agg = s.status + tiles;
  s.pre = s.agg + tiles * kMaxC;
  return s;
}

template <typename T> struct Num;
template <> struct Num<long long> {
  __device__ static long long lo() { return LLONG_MIN; }
  __device__ static long long hi() { return LLONG_MAX; }
  __device__ static long long finite_lo() { return LLONG_MIN; }
  __device__ static long long finite_hi() { return LLONG_MAX; }
  __device__ static unsigned long long bits(long long x) {
    return (unsigned long long)x;
  }
  __device__ static long long from(unsigned long long u) {
    return (long long)u;
  }
};
template <> struct Num<double> {
  __device__ static double lo() { return -__longlong_as_double(0x7ff0000000000000LL); }
  __device__ static double hi() { return __longlong_as_double(0x7ff0000000000000LL); }
  __device__ static double finite_lo() { return -DBL_MAX; }
  __device__ static double finite_hi() { return DBL_MAX; }
  __device__ static unsigned long long bits(double x) {
    return (unsigned long long)__double_as_longlong(x);
  }
  __device__ static double from(unsigned long long u) {
    return __longlong_as_double((long long)u);
  }
};

// the exact identity: seeds the open segment, fills empty segments
template <int OP, typename T>
__device__ __forceinline__ T scan_identity() {
  if (OP == kAdd) return T(0);
  return OP == kMax ? Num<T>::lo() : Num<T>::hi();
}

// what an invalid row contributes (`identity_for`: finite for floats)
template <int OP, typename T>
__device__ __forceinline__ T mask_identity() {
  if (OP == kAdd) return T(0);
  return OP == kMax ? Num<T>::finite_lo() : Num<T>::finite_hi();
}

template <int OP, typename T>
__device__ __forceinline__ T combine(T a, T b) {
  if (OP == kAdd) return a + b;
  if (OP == kMax) return a > b ? a : b;
  return a < b ? a : b;
}

// (a, af) · (b, bf) into (a, af)
template <int OP, typename T, int C>
__device__ __forceinline__ void seg_combine(T (&a)[C], bool& af,
                                            const T (&b)[C], bool bf) {
#pragma unroll
  for (int c = 0; c < C; ++c) a[c] = bf ? b[c] : combine<OP>(a[c], b[c]);
  af = af || bf;
}

// Status words are read relaxed, several in flight; the reader fences
// once before it reads the words behind them.
__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// A waiting lane sleeps between reads, longer each time (up to 256 ns),
// so that spinning warps do not crowd the cache lines that the tiles
// they wait for are publishing to.
__device__ __forceinline__ void back_off(unsigned& ns) {
  __nanosleep(ns);
  ns = ns < kSpinMaxNs ? 2 * ns : kSpinMaxNs;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ bool aligned(const void* p, unsigned a) {
  return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

// The nearest tile before t that has published its inclusive prefix, or
// -1 (the open segment before tile 0).  Called by all of warp 0, which
// reads 128 status words a step (four a lane, relaxed loads in flight
// together), newest first; a word counts once it carries this launch's
// epoch.  Only the tiles from t-1 down to that prefix must have published:
// the walk waits for no older tile, so a tile does not wait for the
// slowest of its window's loads.  Tile 0 and every tile that holds a reset
// publish their prefix at once, so the walk ends at the latest at the
// nearest reset.
__device__ long long nearest_prefix(const unsigned long long* status,
                                    long long t, unsigned long long e) {
  const int lane = threadIdx.x & 31;
  for (long long lo = t - kWindow;; lo -= kWindow) {
    unsigned long long st[kLook];
#pragma unroll
    for (int i = 0; i < kLook; ++i) {
      const long long j = lo + 32 * i + lane;
      st[i] = j >= 0 ? ld_relaxed(status + j) : 0;
    }
    for (unsigned ns = kSpinNs;;) {
      long long prefix = -1, waiting = -1;  // newest of each, this lane
#pragma unroll
      for (int i = 0; i < kLook; ++i) {
        const long long j = lo + 32 * i + lane;
        if (j < 0) continue;
        if ((st[i] >> 2) != e || (st[i] & 3u) == kInvalid) {
          waiting = j;
        } else if ((st[i] & 3u) == kPrefix) {
          prefix = j;
        }
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        const long long p = __shfl_xor_sync(kFull, prefix, d);
        const long long w = __shfl_xor_sync(kFull, waiting, d);
        prefix = p > prefix ? p : prefix;
        waiting = w > waiting ? w : waiting;
      }
      if (waiting < prefix || (waiting < 0 && prefix < 0)) {
        if (prefix >= 0 || lo <= 0) return prefix;
        break;  // all published, none a prefix: the window before
      }
      back_off(ns);
#pragma unroll
      for (int i = 0; i < kLook; ++i) {
        const long long j = lo + 32 * i + lane;
        if (j >= 0 && ((st[i] >> 2) != e || (st[i] & 3u) == kInvalid)) {
          st[i] = ld_relaxed(status + j);
        }
      }
    }
  }
}

// The carry into tile t > 0: the left fold of the aggregates since the
// nearest published inclusive prefix (see the note at the top).  Called by
// all of warp 0; every lane returns the carry.  After the walk a fence
// makes the words behind the status words it read visible; the aggregates
// are staged 128 at a time in shared memory and lane 0 folds them in tile
// order, while the next 128 are on their way.
template <int OP, typename T, int C>
__device__ void look_back(const Scratch& S, long long t,
                          unsigned long long e, T (&carry)[C]) {
  __shared__ T s_fold[2][kWindow][C];
  const int lane = threadIdx.x & 31;
  const long long stop = nearest_prefix(S.status, t, e);
  __threadfence();
  __syncwarp();
#pragma unroll
  for (int c = 0; c < C; ++c) {
    carry[c] = stop >= 0 ? Num<T>::from(__ldcg(S.pre + stop * kMaxC + c))
                         : scan_identity<OP, T>();
  }
  // window k holds tiles stop + 1 + k * kWindow + i, i < kWindow, below t
  T next[kLook][C];
  auto fetch = [&](long long lo) {
#pragma unroll
    for (int i = 0; i < kLook; ++i) {
      const long long j = lo + 32 * i + lane;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        next[i][c] = j < t ? Num<T>::from(__ldcg(S.agg + j * kMaxC + c)) : T(0);
      }
    }
  };
  auto stage = [&](int b) {
#pragma unroll
    for (int i = 0; i < kLook; ++i) {
#pragma unroll
      for (int c = 0; c < C; ++c) s_fold[b][32 * i + lane][c] = next[i][c];
    }
  };
  if (stop + 1 < t) {
    fetch(stop + 1);
    stage(0);
  }
  __syncwarp();
  int b = 0;
  for (long long lo = stop + 1; lo < t; lo += kWindow, b ^= 1) {
    const int m = t - lo < kWindow ? (int)(t - lo) : kWindow;
    const bool more = lo + kWindow < t;
    if (more) fetch(lo + kWindow);  // in flight during the fold
    if (lane == 0) {
      for (int i = 0; i < m; ++i) {
#pragma unroll
        for (int c = 0; c < C; ++c) carry[c] = combine<OP>(carry[c], s_fold[b][i][c]);
      }
    }
    if (more) stage(b ^ 1);
    __syncwarp();
  }
#pragma unroll
  for (int c = 0; c < C; ++c) carry[c] = __shfl_sync(kFull, carry[c], 0);
}

template <int OP, typename T, int C>
__device__ __forceinline__ void store_identity(T* out, long long s) {
#pragma unroll
  for (int c = 0; c < C; ++c) out[s * C + c] = scan_identity<OP, T>();
}

// One tile: steps 1-3 of the note at the top.
template <int OP, typename T, int C>
__device__ __forceinline__ void scan_tile(
    const T* __restrict__ values, const unsigned char* __restrict__ flags,
    const long long* __restrict__ sid, const unsigned char* __restrict__ valid,
    long long n, long long nseg, T* __restrict__ out, const Scratch& S,
    long long t, unsigned long long e) {
  __shared__ T s_wv[kWarps][C];
  __shared__ bool s_wf[kWarps];
  __shared__ T s_carry[C];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long first = t * kTile + (long long)threadIdx.x * kItems;
  const bool full = first + kItems <= n;

  // --- the thread's rows, read once
  T v[kItems][C];
  if (full && aligned(values, 16)) {
    const ulonglong2* p = reinterpret_cast<const ulonglong2*>(values + first * C);
    unsigned long long w[kItems * C];
#pragma unroll
    for (int q = 0; q < kItems * C / 2; ++q) {
      const ulonglong2 x = p[q];
      w[2 * q] = x.x;
      w[2 * q + 1] = x.y;
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
#pragma unroll
      for (int c = 0; c < C; ++c) v[i][c] = Num<T>::from(w[i * C + c]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        v[i][c] = first + i < n ? values[(first + i) * C + c]
                                : scan_identity<OP, T>();
      }
    }
  }
  bool f[kItems];
  long long id[kItems];
  long long prev = 0;  // the id of the row before the thread's first
  if (sid == nullptr) {  // segmented_scan: the flags
    if (full && aligned(flags, 8)) {
      const unsigned long long fw =
          *reinterpret_cast<const unsigned long long*>(flags + first);
#pragma unroll
      for (int i = 0; i < kItems; ++i) f[i] = ((fw >> (8 * i)) & 0xffu) != 0;
    } else {
#pragma unroll
      for (int i = 0; i < kItems; ++i) f[i] = first + i < n && flags[first + i];
    }
  } else {  // segment_reduce: resets from the ids, invalid rows masked
    if (full && aligned(sid, 16)) {
      const longlong2* p = reinterpret_cast<const longlong2*>(sid + first);
#pragma unroll
      for (int q = 0; q < kItems / 2; ++q) {
        const longlong2 x = p[q];
        id[2 * q] = x.x;
        id[2 * q + 1] = x.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kItems; ++i) id[i] = first + i < n ? sid[first + i] : 0;
    }
    if (first > 0 && first <= n) prev = sid[first - 1];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long before = i == 0 ? prev : id[i - 1];
      f[i] = first + i < n && (first + i == 0 || id[i] != before);
    }
    if (valid != nullptr) {
      bool ok[kItems];
      if (full && aligned(valid, 8)) {
        const unsigned long long vw =
            *reinterpret_cast<const unsigned long long*>(valid + first);
#pragma unroll
        for (int i = 0; i < kItems; ++i) ok[i] = ((vw >> (8 * i)) & 0xffu) != 0;
      } else {
#pragma unroll
        for (int i = 0; i < kItems; ++i) ok[i] = first + i >= n || valid[first + i];
      }
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        if (!ok[i]) {
#pragma unroll
          for (int c = 0; c < C; ++c) v[i][c] = mask_identity<OP, T>();
        }
      }
    }
  }

  // --- 1. thread fold, warp scan, tile aggregate
  T x[C];
  bool xf = f[0];
#pragma unroll
  for (int c = 0; c < C; ++c) x[c] = v[0][c];
#pragma unroll
  for (int i = 1; i < kItems; ++i) seg_combine<OP>(x, xf, v[i], f[i]);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    T y[C];
#pragma unroll
    for (int c = 0; c < C; ++c) y[c] = __shfl_up_sync(kFull, x[c], d);
    const bool yf = __shfl_up_sync(kFull, (int)xf, d);
    if (lane >= d) {
      if (!xf) {
#pragma unroll
        for (int c = 0; c < C; ++c) x[c] = combine<OP>(y[c], x[c]);
      }
      xf = xf || yf;
    }
  }
  T ex[C];  // the lane before's inclusive value
#pragma unroll
  for (int c = 0; c < C; ++c) ex[c] = __shfl_up_sync(kFull, x[c], 1);
  const bool exf = __shfl_up_sync(kFull, (int)xf, 1);
  if (lane == 31) {
#pragma unroll
    for (int c = 0; c < C; ++c) s_wv[warp][c] = x[c];
    s_wf[warp] = xf;
  }
  __syncthreads();
  // the thread's exclusive prefix inside the tile (none for thread 0)
  T p[C];
  bool pf = false;
  const bool has = warp > 0 || lane > 0;
  if (warp > 0) {
    pf = s_wf[0];
#pragma unroll
    for (int c = 0; c < C; ++c) p[c] = s_wv[0][c];
    for (int j = 1; j < warp; ++j) {
      T w[C];
#pragma unroll
      for (int c = 0; c < C; ++c) w[c] = s_wv[j][c];
      seg_combine<OP>(p, pf, w, s_wf[j]);
    }
    if (lane > 0) seg_combine<OP>(p, pf, ex, exf);
  } else if (lane > 0) {
    pf = exf;
#pragma unroll
    for (int c = 0; c < C; ++c) p[c] = ex[c];
  }

  // --- 2. publish, look back, publish
  if (warp == 0) {
    T a[C];
    bool af = s_wf[0];
#pragma unroll
    for (int c = 0; c < C; ++c) a[c] = s_wv[0][c];
    for (int j = 1; j < kWarps; ++j) {
      T w[C];
#pragma unroll
      for (int c = 0; c < C; ++c) w[c] = s_wv[j][c];
      seg_combine<OP>(a, af, w, s_wf[j]);
    }
    T carry[C];
#pragma unroll
    for (int c = 0; c < C; ++c) carry[c] = scan_identity<OP, T>();
    const bool early = t == 0 || af;  // the inclusive prefix needs no carry
    if (lane == 0) {
      if (early) {
        T q[C];
        bool qf = false;
#pragma unroll
        for (int c = 0; c < C; ++c) q[c] = carry[c];
        seg_combine<OP>(q, qf, a, af);
#pragma unroll
        for (int c = 0; c < C; ++c) S.pre[t * kMaxC + c] = Num<T>::bits(q[c]);
        st_release(S.status + t, (e << 2) | kPrefix);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) S.agg[t * kMaxC + c] = Num<T>::bits(a[c]);
        st_release(S.status + t, (e << 2) | kAggregate);
      }
    }
    if (t > 0) look_back<OP, T, C>(S, t, e, carry);
    if (lane == 0) {
      if (!early) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          S.pre[t * kMaxC + c] = Num<T>::bits(combine<OP>(carry[c], a[c]));
        }
        st_release(S.status + t, (e << 2) | kPrefix);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) s_carry[c] = carry[c];
    }
  }
  __syncthreads();

  // --- 3. rescan from the carry and write
  T run[C];
  if (has && pf) {
#pragma unroll
    for (int c = 0; c < C; ++c) run[c] = p[c];
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      run[c] = has ? combine<OP>(s_carry[c], p[c]) : s_carry[c];
    }
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      run[c] = f[i] ? v[i][c] : combine<OP>(run[c], v[i][c]);
      v[i][c] = run[c];
    }
  }
  if (sid == nullptr) {
    if (full && aligned(out, 16)) {
      ulonglong2* q = reinterpret_cast<ulonglong2*>(out + first * C);
#pragma unroll
      for (int k = 0; k < kItems * C / 2; ++k) {
        const int a = 2 * k, b = 2 * k + 1;
        q[k] = make_ulonglong2(Num<T>::bits(v[a / C][a % C]),
                               Num<T>::bits(v[b / C][b % C]));
      }
    } else {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        if (first + i < n) {
#pragma unroll
          for (int c = 0; c < C; ++c) out[(first + i) * C + c] = v[i][c];
        }
      }
    }
    return;
  }
  const long long next = first + kItems < n ? sid[first + kItems] : 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long row = first + i;
    if (row >= n) break;
    const bool last = row + 1 >= n || (i + 1 < kItems ? f[i + 1] : next != id[i]);
    if (last && id[i] >= 0 && id[i] < nseg) {
#pragma unroll
      for (int c = 0; c < C; ++c) out[id[i] * C + c] = v[i][c];
    }
    // an interior gap: the empty ids strictly between the previous row's
    if (f[i] && row > 0) {
      const long long before = i == 0 ? prev : id[i - 1];
      if (before < id[i]) {
        const long long hi = id[i] < nseg ? id[i] : nseg;
        for (long long s = before < 0 ? 0 : before + 1; s < hi; ++s) {
          store_identity<OP, T, C>(out, s);
        }
      }
    }
  }
}

template <int OP, typename T, int C>
__global__ void __launch_bounds__(kThreads)
segscan_lookback(const T* __restrict__ values,
                 const unsigned char* __restrict__ flags,
                 const long long* __restrict__ sid,
                 const unsigned char* __restrict__ valid, long long n,
                 long long nseg, T* __restrict__ out,
                 unsigned char* __restrict__ scratch, long long scratch_bytes) {
  __shared__ unsigned long long s_ticket;
  const Scratch S = scratch_view(scratch, scratch_bytes);
  if (threadIdx.x == 0) {
    const unsigned long long w = atomicAdd(S.ticket, 1ull);
    // the launch's last ticket: the next launch's epoch, no ticket taken
    if ((w & kTicketMask) == gridDim.x - 1) {
      atomicExch(S.ticket, ((w >> kTicketBits) + 1) << kTicketBits);
    }
    s_ticket = w;
  }
  __syncthreads();
  const long long t = (long long)(s_ticket & kTicketMask);
  const unsigned long long e = s_ticket >> kTicketBits;
  const long long ntiles = (n + kTile - 1) / kTile;
  if (t < ntiles) scan_tile<OP, T, C>(values, flags, sid, valid, n, nseg, out, S, t, e);
  if (sid != nullptr) {
    // the empty ids before the first row's and after the last row's, by
    // every block
    const long long first_id = sid[0], last_id = sid[n - 1];
    const long long stride = (long long)gridDim.x * kThreads;
    const long long i0 = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long lead = first_id < nseg ? first_id : nseg;
    for (long long s = i0; s < lead; s += stride) store_identity<OP, T, C>(out, s);
    const long long trail = last_id < 0 ? 0 : last_id < nseg ? last_id + 1 : nseg;
    for (long long s = trail + i0; s < nseg; s += stride) {
      store_identity<OP, T, C>(out, s);
    }
  }
}

template <int OP, typename T, int C>
int launch(const void* values, const void* flags, const void* sid,
           const void* valid, long long n, long long nseg, void* out,
           void* scratch, long long bytes, cudaStream_t s) {
  const long long ntiles = (n + kTile - 1) / kTile;
  long long grid = ntiles;
  if (sid != nullptr) {  // blocks past the tiles help fill the empty ids
    const long long fill = (nseg + kTile - 1) / kTile;
    const long long extra = fill < 4096 ? fill : 4096;
    if (extra > grid) grid = extra;
  }
  segscan_lookback<OP, T, C><<<(unsigned)grid, kThreads, 0, s>>>(
      static_cast<const T*>(values), static_cast<const unsigned char*>(flags),
      static_cast<const long long*>(sid),
      static_cast<const unsigned char*>(valid), n, nseg, static_cast<T*>(out),
      static_cast<unsigned char*>(scratch), bytes);
  return (int)cudaGetLastError();
}

template <int OP, typename T>
int launch_c(int c, const void* values, const void* flags, const void* sid,
             const void* valid, long long n, long long nseg, void* out,
             void* scratch, long long bytes, cudaStream_t s) {
  switch (c) {
    case 1: return launch<OP, T, 1>(values, flags, sid, valid, n, nseg, out, scratch, bytes, s);
    case 2: return launch<OP, T, 2>(values, flags, sid, valid, n, nseg, out, scratch, bytes, s);
    case 3: return launch<OP, T, 3>(values, flags, sid, valid, n, nseg, out, scratch, bytes, s);
    case 4: return launch<OP, T, 4>(values, flags, sid, valid, n, nseg, out, scratch, bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_op(int op, int c, const void* values, const void* flags,
              const void* sid, const void* valid, long long n, long long nseg,
              void* out, void* scratch, long long bytes, cudaStream_t s) {
  switch (op) {
    case kAdd: return launch_c<kAdd, T>(c, values, flags, sid, valid, n, nseg, out, scratch, bytes, s);
    case kMax: return launch_c<kMax, T>(c, values, flags, sid, valid, n, nseg, out, scratch, bytes, s);
    case kMin: return launch_c<kMin, T>(c, values, flags, sid, valid, n, nseg, out, scratch, bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// [rows a tile, fixed scratch bytes, scratch bytes a tile]: the wrapper
// sizes the scratch from these once.
extern "C" void repro_segmented_scan_layout(long long* out) {
  out[0] = kTile;
  out[1] = kFixedBytes;
  out[2] = kTileBytes;
}

// dtype: 0 int64, 1 float64; op: 0 add, 1 max, 2 min; values [n, c]
// row-major, 1 <= c <= 4, n >= 1.  Either flags [n] bytes and out [n, c]
// (segmented_scan), or seg_ids [n] (int64, nondecreasing), valid [n] bytes
// or null, and out [num_segments, c] (segment_reduce).  scratch: `bytes`
// bytes, zeroed once before its first use, at least the layout's size for
// n rows; one call at a time may use it.
extern "C" int repro_segmented_scan(int dtype, int op, int c,
                                    const void* values, const void* flags,
                                    const void* seg_ids, const void* valid,
                                    long long n, long long num_segments,
                                    void* out, void* scratch, long long bytes,
                                    void* stream) {
  if (n < 1 || (flags == nullptr) == (seg_ids == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((bytes - kFixedBytes) / kTileBytes < (n + kTile - 1) / kTile ||
      (n + kTile - 1) / kTile > (long long)kTicketMask) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_op<long long>(op, c, values, flags, seg_ids, valid, n, num_segments, out, scratch, bytes, s);
    case 1: return launch_op<double>(op, c, values, flags, seg_ids, valid, n, num_segments, out, scratch, bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
