// cscatter: commutative scatter-update with a privatized copy in shared memory.
//
// Replaces the TPU kernel `cscatter` / `_kernel` of repro/kernels/cscatter.py
// (a Pallas kernel). For a table T[S, R, D] and a stream of COps
// (ids[S, N], vals[S, N, D]) it computes, per shard s and row r,
//
//     T[s, r] = apply(T[s, r], fold(combine, identity, vals[s, n] : ids[s, n] == r))
//
// in place: every contribution to a row is folded into a private delta first
// and `apply` sees memory exactly once (what keeps sat_add correct). Rows no id
// touches are never read or written (bit-exact), and ids < 0 or >= R are
// ignored (the padding convention). Kinds: add, sat_add, max, min, or (or for
// integer tables only). Accumulators are f32 for f32/bf16 tables and the
// table's own dtype (wrapping adds) for int32/uint32 tables.
//
// Design. One CTA owns `br` rows x `dc` columns of one shard (grid: row
// blocks x column tiles x shards) and keeps the accumulator tile for them in
// shared memory — the paper's privatized copy held in L1. It
//   1. streams all N ids of its shard, setting a touched bit per in-range row
//      and appending the position to a compact list (full rescan if the list
//      overflows, as a hot row can make it);
//   2. sets the touched rows of the tile to the merge identity;
//   3. folds every listed contribution with shared-memory atomics (atomicAdd,
//      atomicMax, atomicMin, atomicOr; a CAS loop for f32 max/min);
//   4. after a barrier, applies each touched row once, in place in the table.
// A row belongs to exactly one CTA, so it is merged once; integer results are
// deterministic (f32 sums are not: the atomics run in no fixed order); there
// is no O(R * D) scratch in device memory.
//
// What bounds it on an H100. The function itself must move only the ids and
// vals once plus each touched row read and written once — for a serving tick
// (8 x 1024 updates of 4 int32 columns) about 0.4 MB, well under a
// microsecond at 3.35 TB/s, so launch latency is the real floor. This simple
// design does more: every CTA reads all N ids of its shard, S * ceil(R / br) *
// N * 4 bytes from L2 a call (about 22 MB for that tick at R = 2^22, br = 6144,
// and 8x that for an 8192-update ring flush), plus the per-CTA bitmask work.
// Bucketing the ids by row block first would cut that to one pass; it is left
// for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kAccBytes = 96 * 1024;   // accumulator tile budget per CTA
constexpr int kListCap = 2048;         // compact in-range id list per CTA
constexpr int kMaxCols = 32;           // column tile width
constexpr int kMaxRows = kAccBytes / 4;
constexpr int kSmemMax = kAccBytes + (kMaxRows / 32) * 4 + kListCap * 4 + 16;

enum Kind { kAdd = 0, kSatAdd = 1, kMax = 2, kMin = 3, kOr = 4 };
enum DType { kF32 = 0, kBF16 = 1, kI32 = 2, kU32 = 3 };

template <typename T> struct AccOf { using type = T; };
template <> struct AccOf<__nv_bfloat16> { using type = float; };

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

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads)
cscatter_kernel(T* __restrict__ table, const int* __restrict__ ids, const T* __restrict__ vals,
                int R, int N, int D, int br, int dc, float lo, float hi) {
  using A = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  A* acc = reinterpret_cast<A*>(smem);                                  // [br, dc]
  unsigned* mask = reinterpret_cast<unsigned*>(acc + (size_t)br * dc);  // [br / 32]
  int* list = reinterpret_cast<int*>(mask + br / 32);                   // [kListCap]
  int* count = list + kListCap;

  const int base = blockIdx.x * br;
  const int rows = min(br, R - base);
  const int col0 = blockIdx.y * dc;
  const int cols = min(dc, D - col0);
  const int words = (rows + 31) / 32;
  const int* sids = ids + (size_t)blockIdx.z * N;
  const T* svals = vals + (size_t)blockIdx.z * N * D + col0;
  T* stable = table + ((size_t)blockIdx.z * R + base) * D + col0;

  for (int w = threadIdx.x; w < words; w += blockDim.x) mask[w] = 0u;
  if (threadIdx.x == 0) *count = 0;
  __syncthreads();

  // 1. this block's ids: touched bits + compact list of their positions
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const int id = sids[n];
    if (id >= base && id - base < rows) {
      const int r = id - base;
      atomicOr(&mask[r >> 5], 1u << (r & 31));
      const int slot = atomicAdd(count, 1);
      if (slot < kListCap) list[slot] = n;
    }
  }
  __syncthreads();
  const int hits = *count;
  if (hits == 0) return;  // the same value in every thread: no barrier skipped

  // 2. touched rows of the private copy start at the merge identity
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    for (unsigned bits = mask[w]; bits; bits &= bits - 1) {
      const int r = (w << 5) + __ffs(bits) - 1;
      for (int c = 0; c < cols; ++c) acc[r * dc + c] = identity<A, KIND>();
    }
  }
  __syncthreads();

  // 3. fold every contribution into the private copy
  const bool listed = hits <= kListCap;
  const long long work = (long long)(listed ? hits : N) * cols;
  for (long long i = threadIdx.x; i < work; i += blockDim.x) {
    const int e = (int)(i / cols);
    const int c = (int)(i % cols);
    const int n = listed ? list[e] : e;
    const int id = sids[n];
    if (!listed && !(id >= base && id - base < rows)) continue;
    fold<KIND>(&acc[(id - base) * dc + c], to_acc(svals[(size_t)n * D + c]));
  }
  __syncthreads();

  // 4. merge each touched row into memory, once
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    for (unsigned bits = mask[w]; bits; bits &= bits - 1) {
      const int r = (w << 5) + __ffs(bits) - 1;
      T* row = stable + (size_t)r * D;
      for (int c = 0; c < cols; ++c) row[c] = apply<KIND>(row[c], acc[r * dc + c], lo, hi);
    }
  }
}

template <typename T, int KIND>
cudaError_t launch(void* table, const void* ids, const void* vals, int S, int R, int N, int D,
                   float lo, float hi, cudaStream_t stream) {
  using A = typename AccOf<T>::type;
  static const cudaError_t attr = cudaFuncSetAttribute(
      cscatter_kernel<T, KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (attr != cudaSuccess) return attr;
  const int dc = D < kMaxCols ? D : kMaxCols;
  int br = (kAccBytes / (dc * (int)sizeof(A))) / 32 * 32;
  const int r32 = (R + 31) / 32 * 32;
  if (br > r32) br = r32;
  const size_t smem = (size_t)br * dc * sizeof(A) + (br / 32) * 4 + kListCap * 4 + 16;
  const dim3 grid((R + br - 1) / br, (D + dc - 1) / dc, S);
  cscatter_kernel<T, KIND><<<grid, kThreads, smem, stream>>>(
      static_cast<T*>(table), static_cast<const int*>(ids), static_cast<const T*>(vals),
      R, N, D, br, dc, lo, hi);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_kind(int kind, void* table, const void* ids, const void* vals, int S, int R,
                        int N, int D, float lo, float hi, cudaStream_t stream) {
  switch (kind) {
    case kAdd: return launch<T, kAdd>(table, ids, vals, S, R, N, D, lo, hi, stream);
    case kSatAdd: return launch<T, kSatAdd>(table, ids, vals, S, R, N, D, lo, hi, stream);
    case kMax: return launch<T, kMax>(table, ids, vals, S, R, N, D, lo, hi, stream);
    case kMin: return launch<T, kMin>(table, ids, vals, S, R, N, D, lo, hi, stream);
    case kOr:
      if constexpr (std::is_integral<T>::value)
        return launch<T, kOr>(table, ids, vals, S, R, N, D, lo, hi, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// table [S, R, D], ids int32 [S, N], vals [S, N, D] (the table's dtype), all
// contiguous on the current device; updates `table` in place on `stream`.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int cscatter_launch(void* table, const void* ids, const void* vals, long long S,
                               long long R, long long N, long long D, int dtype, int kind,
                               float sat_min, float sat_max, void* stream) {
  if (S < 1 || S > 65535 || R < 1 || R > INT_MAX || N < 0 || N > INT_MAX || D < 1 ||
      D > 65535LL * kMaxCols || R * D > (1LL << 62))
    return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int s = (int)S, r = (int)R, n = (int)N, d = (int)D;
  switch (dtype) {
    case kF32: return launch_kind<float>(kind, table, ids, vals, s, r, n, d, sat_min, sat_max, st);
    case kBF16: return launch_kind<__nv_bfloat16>(kind, table, ids, vals, s, r, n, d, sat_min, sat_max, st);
    case kI32: return launch_kind<int>(kind, table, ids, vals, s, r, n, d, sat_min, sat_max, st);
    case kU32: return launch_kind<unsigned>(kind, table, ids, vals, s, r, n, d, sat_min, sat_max, st);
    default: return cudaErrorInvalidValue;
  }
}
