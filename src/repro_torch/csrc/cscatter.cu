// cscatter: commutative scatter-update through a privatized delta per row.
//
// Replaces the TPU kernel `cscatter` / `_kernel` of repro/kernels/cscatter.py
// (a Pallas kernel). For a table T[S, R, D] and a stream of COps
// (ids[S, N], vals[S, N, D]) it computes, per shard s and row r,
//
//     T[s, r] = apply(T[s, r], fold(combine, identity, vals[s, n] : ids[s, n] == r))
//
// in place: every contribution to a row is folded into a private delta first
// and `apply` sees memory exactly once (what keeps sat_add and bf16 rounding
// correct). Rows no id touches are never read or written (bit-exact), and ids
// < 0 or >= R are ignored (the padding convention). Kinds: add, sat_add, max,
// min, or (or for integer tables only). Accumulators are f32 for f32/bf16
// tables and the table's own dtype (wrapping adds) for int32/uint32 tables.
//
// Design: two launches on the caller's stream, no host synchronisation.
//   1. Bucket pass (bucket_kernel, one CTA of 1024 threads per shard). A
//      counting sort of the shard's in-range ids by row block (id / br): a
//      histogram in shared memory, an exclusive scan, and a scatter of
//      positions through per-block cursors. It writes perm[S, N] (the
//      positions n, grouped by block) and rowid[S, N] (their ids, so the fold
//      need not look them up). While it scans, it packs consecutive blocks
//      into work units of at most 32 ids (a warp's lanes); a block of more
//      ids is a unit of its own, a "big" one. It writes the units' starts in
//      perm, ustart[S, L + 1], the big units' indices, big[S, L], and both
//      counts, counts[S, 2] (L = min(blocks, N) bounds the units). The
//      counters live in shared memory, so no memset launch is needed; when
//      perm and rowid fit there too (the main path's do), the scatter writes
//      them there and they leave in one coalesced copy, since one SM's
//      scattered stores to device memory are slow (the whole call, staged
//      against direct: 0.0226 against 0.0364 ms a ring flush, 0.0120 against
//      0.0130 ms a tick; chip_smoke.py `unstaged_ms`, NVIDIA H100 80GB HBM3,
//      700 W). Larger N writes them straight out. A table with more blocks
//      than one histogram holds (hist_cap, far above the main path's) is
//      counted in rounds of hist_cap blocks.
//   2. Fold pass (fold_kernel; grid: CTAs of 4 warps per shard, a few per
//      SM in all, times the column tiles of dc <= 32 columns, times the
//      shards). A CTA first takes its share of the shard's big units (hot
//      rows, the long poles) with all its threads: in its [br, dc]
//      accumulator tile in shared memory it sets the touched rows to the
//      merge identity (a touched bit per row), folds every contribution with
//      shared-memory atomics (atomicAdd, atomicMax, atomicMin, atomicOr; a
//      CAS loop for f32 max/min), and applies each touched row once, in
//      place in the table, by the thread that clears its bit. Then each warp
//      takes small units, one at a time, in registers: lane e holds entry e,
//      the lanes of one row find each other with __match_any_sync, and the
//      lowest folds the others' values (shuffled over, in lane order) and
//      applies the row once; its table row is loaded together with the
//      values. The fold reads only its unit's slice of perm and rowid and the
//      vals they point to.
// A row lies in exactly one block, and a block in exactly one unit, so it is
// merged by exactly one warp or CTA per column tile: "apply once" needs no
// atomics on the table. A unit is a contiguous slice of any length, so there
// is no list capacity to overflow and no rescan. Scratch (S * (2N + 2L + 3)
// int32) is one buffer the wrapper allocates; the wrapper also computes br,
// dc, the rounds, the staging and the grid (kernels/cscatter.py `plan`).
//
// Determinism. Every result is the same bits on every call with the same
// inputs and plan, float sums included, though the bucket pass's atomic
// cursors leave the entries of a block in perm in an order that changes from
// run to run. Integer kinds and max/min fold in any order to the same value.
// For f32 and bf16 tables under add and sat_add the fold does not depend on
// that order: a warp's unit is first sorted by position n across its lanes
// (a 32-lane bitonic sort, 15 shuffle rounds), so the leader adds a row's
// contributions in ascending n; a big unit adds them exactly, as integers:
// the first pass over its entries finds each (row, column) cell's largest
// magnitude M (an atomicMax on the bits, which is order-free), the second
// rounds every value to a multiple of the cell's quantum q = 2^(e(M) + 1 +
// ceil(log2(k + 1)) - 62) (k the unit's entries, so k terms fit an int64)
// and adds the integers with 64-bit shared-memory atomics, which is exact in
// any order; the cell's delta is the int64 sum times q, rounded once to
// f32. Each term is off by at most q / 2, about M 2^-(62 - log2 k): at the
// apps' largest units (2^14 ids) that is M 2^-48, far below f32's own
// rounding of an ordered sum. A cell that holds an inf or a NaN adds in
// float (inf and NaN absorb any order) and writes a canonical NaN. The
// bits are not the plain version's; both stay within the tests' TOL.
//
// What bounds it on an H100. The function must move the ids and vals once
// plus each touched row read and written once: for a serving tick (8 x 1024
// updates of 4 int32 columns into [8, 2^22, 4]) about 0.41 MB, 0.12 us at
// 3.35 TB/s; for a ring flush (8 x 8192) about 3.3 MB, 0.98 us. Bytes bound
// it, and both are far below two launches' latency, which is the real floor.
// The first design of this kernel read all N ids in every one of its
// S * ceil(R / br) CTAs: 683 times a call at the main path, about 22 MB from
// L2 for a tick and 180 MB for a flush. This one reads the ids twice (the
// histogram and the scatter of the bucket pass: 64 KB for a tick, 512 KB for
// a flush) and perm and rowid once more in the fold. What remains is
// latency: the bucket pass is a chain of block-wide steps on S SMs, and a
// unit's fold a chain of dependent loads (its start, its perm and rowid
// slice, the vals and table rows), after the bucket pass has finished.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBucketThreads = 1024;
constexpr int kFoldWarps = 4, kFoldThreads = 32 * kFoldWarps;
constexpr int kWarpBucket = 32;  // larger buckets are folded by the whole CTA
constexpr int kMaxCols = 32;     // column tile width
constexpr int kColChunk = 8;     // columns a warp folds in registers at once
constexpr int kSmemMax = 227 * 1024;    // dynamic + static shared memory of a block
constexpr int kBucketStatic = 1024;      // bound on bucket_kernel's static shared memory

enum Kind { kAdd = 0, kSatAdd = 1, kMax = 2, kMin = 3, kOr = 4 };
enum DType { kF32 = 0, kBF16 = 1, kI32 = 2, kU32 = 3 };

template <typename T> struct AccOf { using type = T; };
template <> struct AccOf<__nv_bfloat16> { using type = float; };

// float sums, whose bits depend on the order of the adds: folded in a fixed
// order (warp units) or exactly (big units); see the header
template <typename A, int KIND>
constexpr bool kOrdered = std::is_same<A, float>::value && (KIND == kAdd || KIND == kSatAdd);

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ int to_acc(int x) { return x; }
__device__ __forceinline__ unsigned to_acc(unsigned x) { return x; }

// NaN-propagating max/min, as jnp.maximum / jnp.minimum.
__device__ __forceinline__ float max_prop(float a, float b) { return (a != a || a > b) ? a : b; }
__device__ __forceinline__ float min_prop(float a, float b) { return (a != a || a < b) ? a : b; }

template <typename A, int KIND> __device__ __forceinline__ A identity() {
  if constexpr (KIND == kMax) {
    if constexpr (std::is_same<A, float>::value) return -FLT_MAX;
    else if constexpr (std::is_same<A, int>::value) return INT_MIN;
    else return 0u;
  } else if constexpr (KIND == kMin) {
    if constexpr (std::is_same<A, float>::value) return FLT_MAX;
    else if constexpr (std::is_same<A, int>::value) return INT_MAX;
    else return UINT_MAX;
  } else {
    return (A)0;
  }
}

__device__ __forceinline__ void cas_fold(float* addr, float v, bool is_max) {
  int* a = reinterpret_cast<int*>(addr);
  int old = *a, assumed;
  do {
    assumed = old;
    float cur = __int_as_float(assumed);
    float nv = is_max ? max_prop(cur, v) : min_prop(cur, v);
    if (__float_as_int(nv) == assumed) return;
    old = atomicCAS(a, assumed, __float_as_int(nv));
  } while (old != assumed);
}

template <int KIND, typename A> __device__ __forceinline__ void fold(A* a, A v) {
  if constexpr (KIND == kAdd || KIND == kSatAdd) atomicAdd(a, v);
  else if constexpr (std::is_same<A, float>::value) cas_fold(a, v, KIND == kMax);
  else if constexpr (KIND == kMax) atomicMax(a, v);
  else if constexpr (KIND == kMin) atomicMin(a, v);
  else atomicOr(a, v);
}

// the same fold on registers (a warp's shuffled values)
template <int KIND, typename A> __device__ __forceinline__ A combine(A a, A b) {
  if constexpr (KIND == kAdd || KIND == kSatAdd) {
    if constexpr (std::is_same<A, float>::value) return a + b;
    else return (A)((unsigned)a + (unsigned)b);  // wrapping
  } else if constexpr (std::is_same<A, float>::value) {
    return KIND == kMax ? max_prop(a, b) : min_prop(a, b);
  } else if constexpr (KIND == kMax) {
    return max(a, b);
  } else if constexpr (KIND == kMin) {
    return min(a, b);
  } else {
    return a | b;
  }
}

template <int KIND> __device__ __forceinline__ float apply_f32(float mem, float u, float lo, float hi) {
  if (KIND == kAdd) return mem + u;
  if (KIND == kSatAdd) return min_prop(max_prop(mem + u, lo), hi);
  if (KIND == kMax) return max_prop(mem, u);
  return min_prop(mem, u);
}

template <int KIND> __device__ __forceinline__ float apply(float mem, float u, float lo, float hi) {
  return apply_f32<KIND>(mem, u, lo, hi);
}

// bf16 table: u is cast to bf16 first for add/max/min; sat_add adds in f32.
template <int KIND>
__device__ __forceinline__ __nv_bfloat16 apply(__nv_bfloat16 mem, float u, float lo, float hi) {
  float m = __bfloat162float(mem);
  if (KIND == kSatAdd) return __float2bfloat16_rn(min_prop(max_prop(m + u, lo), hi));
  return __float2bfloat16_rn(apply_f32<KIND>(m, __bfloat162float(__float2bfloat16_rn(u)), lo, hi));
}

// Integer tables: wrapping add; sat_add adds in the integer dtype, then clips
// in f32 and casts back, as the TPU kernel does (jnp.clip promotes to f32).
template <int KIND> __device__ __forceinline__ int apply(int mem, int u, float lo, float hi) {
  if (KIND == kAdd) return (int)((unsigned)mem + (unsigned)u);
  if (KIND == kSatAdd) {
    int s = (int)((unsigned)mem + (unsigned)u);
    return __float2int_rz(min_prop(max_prop(__int2float_rn(s), lo), hi));
  }
  if (KIND == kMax) return max(mem, u);
  if (KIND == kMin) return min(mem, u);
  return mem | u;
}

template <int KIND> __device__ __forceinline__ unsigned apply(unsigned mem, unsigned u, float lo, float hi) {
  if (KIND == kAdd) return mem + u;
  if (KIND == kSatAdd) return __float2uint_rz(min_prop(max_prop(__uint2float_rn(mem + u), lo), hi));
  if (KIND == kMax) return max(mem, u);
  if (KIND == kMin) return min(mem, u);
  return mem | u;
}


// ---------------------------------------------------------------------------
// 1. bucket pass: counting sort of each shard's in-range ids by row block
// ---------------------------------------------------------------------------

// exclusive block-wide scan of (a, b) pairs; returns the totals in *ta, *tb
__device__ __forceinline__ void block_scan2(int& a, int& b, int* ta, int* tb, int2* warp_sums) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = blockDim.x / 32;
  int x = a, y = b;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, x, off), v = __shfl_up_sync(0xffffffffu, y, off);
    if (lane >= off) { x += u; y += v; }
  }
  if (lane == 31) warp_sums[warp] = make_int2(x, y);
  __syncthreads();
  if (warp == 0) {
    const int2 w = lane < warps ? warp_sums[lane] : make_int2(0, 0);
    int p = w.x, q = w.y;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, p, off), v = __shfl_up_sync(0xffffffffu, q, off);
      if (lane >= off) { p += u; q += v; }
    }
    if (lane < warps) warp_sums[lane] = make_int2(p - w.x, q - w.y);  // exclusive
    if (lane == 31) { *ta = p; *tb = q; }
  }
  __syncthreads();
  a = x - a + warp_sums[warp].x;
  b = y - b + warp_sums[warp].y;
}

// The scratch of one call, as slices of one int32 buffer.
struct Scratch {
  int *perm, *rowid;  // [S, N]: positions grouped by row block, and their ids
  int *ustart;        // [S, L + 1]: work units, consecutive slices of perm
  int *big;           // [S, L]: the units that are one block of > kWarpBucket ids
  int *counts;        // [S, 2]: units, big units
};

// Work units: consecutive blocks are packed into units of at most
// kWarpBucket ids (a warp's lanes); a block of more is a unit of its own.
// True if a block of c ids starts a unit, given the open unit's fill
// (kWarpBucket + 1: none open), which it updates.
__device__ __forceinline__ bool starts_unit(int c, int& fill) {
  if (c == 0) return false;
  if (c > kWarpBucket) {
    fill = kWarpBucket + 1;
    return true;
  }
  if (fill + c > kWarpBucket) {
    fill = c;
    return true;
  }
  fill += c;
  return false;
}

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// f(n, ids[n]) for this thread's share of the shard's ids, the loads of a
// batch issued before any of them is used
template <typename F>
__device__ __forceinline__ void for_ids(const int* __restrict__ sids, int N, F f) {
  constexpr int kBatch = 8;
  for (int n0 = threadIdx.x; n0 < N; n0 += kBatch * blockDim.x) {
    int id[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int n = n0 + u * blockDim.x;
      id[u] = n < N ? sids[n] : -1;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (n0 + u * blockDim.x < N) f(n0 + u * blockDim.x, id[u]);
  }
}

__global__ void __launch_bounds__(kBucketThreads)
bucket_kernel(const int* __restrict__ ids, Scratch sc, int R, int N, int br, int n_blocks,
              int hist_cap, int list_cap, int stage) {
  // [hist_cap rounded up to 4], then with `stage` perm and rowid [N]
  extern __shared__ __align__(16) int hist[];
  __shared__ int2 warp_sums[32];
  __shared__ int tot_e, tot_u, done_e, done_u, n_big;
  const size_t s = blockIdx.x;
  const int* sids = ids + s * N;
  int* sperm = sc.perm + s * N;
  int* srow = sc.rowid + s * N;
  int* sustart = sc.ustart + s * (list_cap + 1);
  int* sbig = sc.big + s * list_cap;
  const int tid = threadIdx.x;
  if (tid == 0) done_e = done_u = n_big = 0;
  // staged (one histogram round and room for 2N ints): the scatter's writes
  // stay in shared memory and leave in one coalesced copy; one SM's scattered
  // stores to device memory would otherwise take most of the pass
  int* wperm = stage ? hist + round4(min(n_blocks, hist_cap)) : sperm;
  int* wrow = stage ? wperm + N : srow;

  for (int lo = 0; lo < n_blocks; lo += hist_cap) {
    const int cn = min(hist_cap, n_blocks - lo);
    int4* hist4 = reinterpret_cast<int4*>(hist);
    for (int i = tid; i < round4(cn) / 4; i += blockDim.x) hist4[i] = make_int4(0, 0, 0, 0);
    __syncthreads();
    for_ids(sids, N, [&](int, int id) {
      const int b = id / br - lo;
      if (id >= 0 && id < R && b >= 0 && b < cn) atomicAdd(&hist[b], 1);
    });
    __syncthreads();
    // each thread owns a contiguous run of the chunk's counters, read 4 at a
    // time: its ids and its units, scanned over the block, place them after
    // the earlier runs' (counters past cn are zero)
    const int per = round4((cn + blockDim.x - 1) / blockDim.x);
    const int beg = min(tid * per, cn), end = min(beg + per, cn);
    int cnt = 0, units = 0, fill = kWarpBucket + 1;
    for (int i = beg; i < end; i += 4) {
      const int4 c4 = hist4[i / 4];
      const int c[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        cnt += c[u];
        units += starts_unit(c[u], fill);
      }
    }
    block_scan2(cnt, units, &tot_e, &tot_u, warp_sums);
    // unit starts, and each block's count becomes its cursor
    int at = done_e + cnt, slot = done_u + units;
    fill = kWarpBucket + 1;
    for (int i = beg; i < end; i += 4) {
      const int4 c4 = hist4[i / 4];
      const int c[4] = {c4.x, c4.y, c4.z, c4.w};
      int cur[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (starts_unit(c[u], fill)) {
          sustart[slot] = at;
          if (c[u] > kWarpBucket) sbig[atomicAdd(&n_big, 1)] = slot;
          ++slot;
        }
        cur[u] = at;
        at += c[u];
      }
      hist4[i / 4] = make_int4(cur[0], cur[1], cur[2], cur[3]);
    }
    __syncthreads();
    for_ids(sids, N, [&](int n, int id) {
      const int b = id / br - lo;
      if (id >= 0 && id < R && b >= 0 && b < cn) {
        const int pos = atomicAdd(&hist[b], 1);
        wperm[pos] = n;
        wrow[pos] = id;
      }
    });
    if (tid == 0) {
      done_e += tot_e;
      done_u += tot_u;
    }
    __syncthreads();
  }
  if (stage)
    for (int i = tid; i < done_e; i += blockDim.x) {
      sperm[i] = wperm[i];
      srow[i] = wrow[i];
    }
  if (tid == 0) {
    sustart[done_u] = done_e;
    sc.counts[2 * s] = done_u;
    sc.counts[2 * s + 1] = n_big;
  }
}

// ---------------------------------------------------------------------------
// 2. fold pass: each row's contributions folded privately and applied once
// ---------------------------------------------------------------------------

// A unit of k <= 32 entries (whole blocks) by one warp, in registers: lane e
// holds entry e; lanes of equal row find each other with __match_any_sync,
// the lowest one folds the others' values (shuffled over, in lane order) and
// applies the row once. Its table row is loaded together with the values.
template <typename T, int KIND>
__device__ __forceinline__ void fold_warp(T* __restrict__ stable, const T* __restrict__ svals,
                                          const int* __restrict__ uperm,
                                          const int* __restrict__ urow, int k, int D, int cols,
                                          float lo, float hi) {
  using A = typename AccOf<T>::type;
  const int lane = threadIdx.x % 32;
  const bool act = lane < k;
  int n = act ? uperm[lane] : INT_MAX;
  int r = act ? urow[lane] : -1;
  if constexpr (kOrdered<A, KIND>) {
    // float sums: lanes sorted by position n (unique; the empty lanes'
    // INT_MAX last), so the leader below adds a row's values in ascending n
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
      for (int stride = size / 2; stride > 0; stride >>= 1) {
        const int pn = __shfl_xor_sync(0xffffffffu, n, stride);
        const int pr = __shfl_xor_sync(0xffffffffu, r, stride);
        const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
        if (keep_min ? pn < n : pn > n) {
          n = pn;
          r = pr;
        }
      }
  }
  if (!act) {
    n = 0;
    r = -1 - lane;  // inactive lanes: a group of their own
  }
  const unsigned group = __match_any_sync(0xffffffffu, r);
  const bool leader = act && lane == __ffs(group) - 1;
  const T* v = svals + (size_t)n * D;
  T* row = stable + (size_t)(act ? r : 0) * D;
  for (int c0 = 0; c0 < cols; c0 += kColChunk) {
    A x[kColChunk];
    T mem[kColChunk];
#pragma unroll
    for (int u = 0; u < kColChunk; ++u) {
      const bool ok = c0 + u < cols;
      x[u] = act && ok ? to_acc(v[c0 + u]) : identity<A, KIND>();
      if (leader && ok) mem[u] = row[c0 + u];
    }
    for (int j = 0; j < k; ++j) {
      const int rj = __shfl_sync(0xffffffffu, r, j);
      const bool take = leader && rj == r && j != lane;
#pragma unroll
      for (int u = 0; u < kColChunk; ++u) {
        const A w = __shfl_sync(0xffffffffu, x[u], j);
        if (take) x[u] = combine<KIND>(x[u], w);
      }
    }
    if (leader) {
#pragma unroll
      for (int u = 0; u < kColChunk; ++u)
        if (c0 + u < cols) row[c0 + u] = apply<KIND>(mem[u], x[u], lo, hi);
    }
  }
}

// A unit that is one block of more than 32 ids (hot rows) by the whole CTA,
// in the [br, dc] accumulator tile in shared memory: touched bits, identity,
// shared-memory atomics, then each touched row applied once by the thread
// that clears its bit.
template <typename T, int KIND>
__device__ __forceinline__ void fold_cta(T* __restrict__ stable, const T* __restrict__ svals,
                                         const int* __restrict__ uperm,
                                         const int* __restrict__ urow, int k, int br, int D,
                                         int dc, int cols, typename AccOf<T>::type* acc,
                                         unsigned* mask, float lo, float hi) {
  using A = typename AccOf<T>::type;
  const int g = blockDim.x, t = threadIdx.x;
  const int base = urow[0] / br * br;
  for (int e = t; e < k; e += g) {
    const int r = urow[e] - base;
    const unsigned bit = 1u << (r & 31);
    if (!(atomicOr(&mask[r >> 5], bit) & bit))
      for (int c = 0; c < cols; ++c) acc[r * dc + c] = identity<A, KIND>();
  }
  __syncthreads();
  constexpr int kBatch = 8;  // loads in flight before their atomics
  for (int i0 = t; i0 < k * cols; i0 += kBatch * g) {
    A x[kBatch];
    int slot[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * g;
      slot[u] = -1;
      if (i < k * cols) {
        const int e = i / cols, c = i - e * cols;
        slot[u] = (urow[e] - base) * dc + c;
        x[u] = to_acc(svals[(size_t)uperm[e] * D + c]);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (slot[u] >= 0) fold<KIND>(&acc[slot[u]], x[u]);
  }
  __syncthreads();
  for (int e = t; e < k; e += g) {
    const int r = urow[e] - base;
    const unsigned bit = 1u << (r & 31);
    if (atomicAnd(&mask[r >> 5], ~bit) & bit) {
      T* row = stable + (size_t)(base + r) * D;
      for (int c = 0; c < cols; ++c) row[c] = apply<KIND>(row[c], acc[r * dc + c], lo, hi);
    }
  }
  __syncthreads();
}

// The exponent of the quantum of a cell whose largest magnitude has the bits
// m (finite, nonzero) in a unit of k entries, 2^lk > k: every |x| <= M is
// below 2^(e + 1), so x / q is below 2^(62 - lk) and k of them fit an int64.
__device__ __forceinline__ int quantum_exp(unsigned m, int lk) {
  const int e = max((int)(m >> 23), 1) - 127;
  return e + 1 + lk - 62;
}

// fold_cta for float sums (kOrdered): each cell's contributions added
// exactly as integer multiples of its quantum, in any order (the header).
// Tile: sum [br, dc] int64, then mx [br, dc] (the largest magnitude's bits).
template <typename T, int KIND>
__device__ __forceinline__ void fold_cta_exact(T* __restrict__ stable,
                                               const T* __restrict__ svals,
                                               const int* __restrict__ uperm,
                                               const int* __restrict__ urow, int k, int br,
                                               int D, int dc, int cols,
                                               unsigned long long* sum, unsigned* mx,
                                               unsigned* mask, float lo, float hi) {
  const int g = blockDim.x, t = threadIdx.x;
  const int base = urow[0] / br * br;
  for (int e = t; e < k; e += g) {
    const int r = urow[e] - base;
    const unsigned bit = 1u << (r & 31);
    if (!(atomicOr(&mask[r >> 5], bit) & bit))
      for (int c = 0; c < cols; ++c) {
        sum[r * dc + c] = 0ull;
        mx[r * dc + c] = 0u;
      }
  }
  __syncthreads();
  constexpr int kBatch = 8;  // loads in flight before their atomics
  for (int pass = 0; pass < 2; ++pass) {
    const int lk = 32 - __clz(k);
    for (int i0 = t; i0 < k * cols; i0 += kBatch * g) {
      float x[kBatch];
      int slot[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * g;
        slot[u] = -1;
        if (i < k * cols) {
          const int e = i / cols, c = i - e * cols;
          slot[u] = (urow[e] - base) * dc + c;
          x[u] = to_acc(svals[(size_t)uperm[e] * D + c]);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (slot[u] < 0) continue;
        if (pass == 0) {
          atomicMax(&mx[slot[u]], __float_as_uint(x[u]) & 0x7fffffffu);
        } else {
          const unsigned m = mx[slot[u]];
          if (m >= 0x7f800000u)  // inf or NaN in the cell: float adds
            atomicAdd(reinterpret_cast<float*>(&sum[slot[u]]), x[u]);
          else if (m != 0u)
            atomicAdd(&sum[slot[u]], (unsigned long long)__float2ll_rn(
                                         scalbnf(x[u], -quantum_exp(m, lk))));
        }
      }
    }
    __syncthreads();
  }
  const int lk = 32 - __clz(k);
  for (int e = t; e < k; e += g) {
    const int r = urow[e] - base;
    const unsigned bit = 1u << (r & 31);
    if (atomicAnd(&mask[r >> 5], ~bit) & bit) {
      T* row = stable + (size_t)(base + r) * D;
      for (int c = 0; c < cols; ++c) {
        const unsigned m = mx[r * dc + c];
        float u = 0.f;
        if (m >= 0x7f800000u) {
          u = *reinterpret_cast<const float*>(&sum[r * dc + c]);
          if (u != u) u = __int_as_float(0x7fffffff);
        } else if (m != 0u) {
          u = scalbnf(__ll2float_rn((long long)sum[r * dc + c]), quantum_exp(m, lk));
        }
        row[c] = apply<KIND>(row[c], u, lo, hi);
      }
    }
  }
  __syncthreads();
}

// Grid: (CTAs per shard, column tiles, shards). A CTA first folds its share
// of the shard's big units (the long poles) with all its threads, then its
// warps take the small units, one at a time.
template <typename T, int KIND>
__global__ void __launch_bounds__(kFoldThreads, 8)
fold_kernel(T* __restrict__ table, const T* __restrict__ vals, Scratch sc, int R, int N, int D,
            int br, int dc, int list_cap, float lo, float hi) {
  using A = typename AccOf<T>::type;
  constexpr bool kExact = kOrdered<A, KIND>;
  extern __shared__ __align__(16) unsigned char smem[];
  // [br, dc] accumulators (kExact: int64 sums, then the magnitudes' bits)
  A* acc = reinterpret_cast<A*>(smem);
  unsigned long long* sum = reinterpret_cast<unsigned long long*>(smem);
  unsigned* mx = reinterpret_cast<unsigned*>(sum + (size_t)br * dc);
  unsigned* mask = kExact ? mx + (size_t)br * dc                      // [br / 32]
                          : reinterpret_cast<unsigned*>(acc + (size_t)br * dc);
  const size_t s = blockIdx.z;
  const int col0 = blockIdx.y * dc;
  const int cols = min(dc, D - col0);
  T* stable = table + s * R * D + col0;
  const T* svals = vals + s * N * D + col0;
  const int* sperm = sc.perm + s * N;
  const int* srow = sc.rowid + s * N;
  const int* sustart = sc.ustart + s * (list_cap + 1);
  const int n_units = sc.counts[2 * s], n_big = sc.counts[2 * s + 1];

  if (blockIdx.x < n_big) {
    for (int w = threadIdx.x; w < br / 32; w += blockDim.x) mask[w] = 0u;
    __syncthreads();
    for (int j = blockIdx.x; j < n_big; j += gridDim.x) {
      const int u = sc.big[s * list_cap + j];
      const int e0 = sustart[u];
      if constexpr (kExact)
        fold_cta_exact<T, KIND>(stable, svals, sperm + e0, srow + e0, sustart[u + 1] - e0, br,
                                D, dc, cols, sum, mx, mask, lo, hi);
      else
        fold_cta<T, KIND>(stable, svals, sperm + e0, srow + e0, sustart[u + 1] - e0, br, D, dc,
                          cols, acc, mask, lo, hi);
    }
  }
  const int warps = gridDim.x * kFoldWarps;
  for (int u = blockIdx.x * kFoldWarps + threadIdx.x / 32; u < n_units; u += warps) {
    const int e0 = sustart[u], k = sustart[u + 1] - e0;
    if (k > kWarpBucket) continue;
    fold_warp<T, KIND>(stable, svals, sperm + e0, srow + e0, k, D, cols, lo, hi);
  }
}

struct Plan {
  int S, R, N, D, br, dc, n_blocks, hist_cap, list_cap, fold_ctas, stage;
};

// bytes of one accumulator cell of the fold's [br, dc] tile
template <typename T, int KIND> constexpr int cell_bytes() {
  using A = typename AccOf<T>::type;
  return kOrdered<A, KIND> ? 12 : (int)sizeof(A);
}

template <typename T, int KIND>
cudaError_t launch(void* table, const void* ids, const void* vals, int* scratch, const Plan& p,
                   float lo, float hi, cudaStream_t stream) {
  using A = typename AccOf<T>::type;
  static const cudaError_t attr_bucket = cudaFuncSetAttribute(
      bucket_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax - kBucketStatic);
  static const cudaError_t attr_fold = cudaFuncSetAttribute(
      fold_kernel<T, KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (attr_bucket != cudaSuccess) return attr_bucket;
  if (attr_fold != cudaSuccess) return attr_fold;
  const size_t sn = (size_t)p.S * p.N, sl = (size_t)p.S * p.list_cap;
  Scratch sc;
  sc.perm = scratch;
  sc.rowid = sc.perm + sn;
  sc.ustart = sc.rowid + sn;
  sc.big = sc.ustart + sl + p.S;
  sc.counts = sc.big + sl;
  const size_t bucket_bytes =
      ((size_t)round4(min(p.n_blocks, p.hist_cap)) + (p.stage ? 2 * (size_t)p.N : 0)) * sizeof(int);
  bucket_kernel<<<p.S, kBucketThreads, bucket_bytes, stream>>>(
      static_cast<const int*>(ids), sc, p.R, p.N, p.br, p.n_blocks, p.hist_cap, p.list_cap,
      p.stage);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t fold_bytes = (size_t)p.br * p.dc * cell_bytes<T, KIND>() + p.br / 8;
  const dim3 grid(p.fold_ctas, (p.D + p.dc - 1) / p.dc, p.S);
  fold_kernel<T, KIND><<<grid, kFoldThreads, fold_bytes, stream>>>(
      static_cast<T*>(table), static_cast<const T*>(vals), sc, p.R, p.N, p.D, p.br, p.dc,
      p.list_cap, lo, hi);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_kind(int kind, void* table, const void* ids, const void* vals, int* scratch,
                        const Plan& p, float lo, float hi, cudaStream_t stream) {
  switch (kind) {
    case kAdd: return launch<T, kAdd>(table, ids, vals, scratch, p, lo, hi, stream);
    case kSatAdd: return launch<T, kSatAdd>(table, ids, vals, scratch, p, lo, hi, stream);
    case kMax: return launch<T, kMax>(table, ids, vals, scratch, p, lo, hi, stream);
    case kMin: return launch<T, kMin>(table, ids, vals, scratch, p, lo, hi, stream);
    case kOr:
      if constexpr (std::is_integral<T>::value)
        return launch<T, kOr>(table, ids, vals, scratch, p, lo, hi, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// table [S, R, D], ids int32 [S, N], vals [S, N, D] (the table's dtype), all
// contiguous on the current device; updates `table` in place on `stream`.
// `scratch` holds S * (2N + 2L + 3) int32 (L = list_cap); br, dc, n_blocks,
// hist_cap, list_cap, fold_ctas (CTAs per shard) and stage come from
// kernels/cscatter.py `plan`. Returns the cudaError_t of the launches (0 on
// success).
extern "C" int cscatter_launch(void* table, const void* ids, const void* vals, void* scratch,
                               long long S, long long R, long long N, long long D, int dtype,
                               int kind, float sat_min, float sat_max, long long br, long long dc,
                               long long n_blocks, long long hist_cap, long long list_cap,
                               long long fold_ctas, int stage, void* stream) {
  if (S < 1 || S > 65535 || R < 1 || R > INT_MAX || N < 0 || N > INT_MAX || D < 1 ||
      D > INT_MAX || dc < 1 || dc > kMaxCols || dc > D || (D + dc - 1) / dc > 65535 || br < 32 ||
      br % 32 != 0 || br * n_blocks < R || br * (n_blocks - 1) >= R || hist_cap < 1 ||
      ((hist_cap + 3) / 4 * 4 + (stage ? 2 * N : 0)) * 4 > kSmemMax - kBucketStatic ||
      (stage && hist_cap < n_blocks) || list_cap < 1 ||
      list_cap < (n_blocks < N ? n_blocks : N) || fold_ctas < 1 || fold_ctas > INT_MAX ||
      N * dc > INT_MAX ||
      br * dc * ((dtype == kF32 || dtype == kBF16) && (kind == kAdd || kind == kSatAdd) ? 12 : 4) +
              br / 8 > kSmemMax)
    return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  const Plan p{(int)S, (int)R, (int)N, (int)D, (int)br, (int)dc, (int)n_blocks, (int)hist_cap,
               (int)list_cap, (int)fold_ctas, stage ? 1 : 0};
  int* sc = static_cast<int*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_kind<float>(kind, table, ids, vals, sc, p, sat_min, sat_max, st);
    case kBF16: return launch_kind<__nv_bfloat16>(kind, table, ids, vals, sc, p, sat_min, sat_max, st);
    case kI32: return launch_kind<int>(kind, table, ids, vals, sc, p, sat_min, sat_max, st);
    case kU32: return launch_kind<unsigned>(kind, table, ids, vals, sc, p, sat_min, sat_max, st);
    default: return cudaErrorInvalidValue;
  }
}
