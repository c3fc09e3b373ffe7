// cmerge: the merge instruction over a W-way source buffer, in place.
//
// Replaces the TPU kernel `cmerge` / `_kernel` of repro/kernels/cmerge.py (a
// Pallas kernel). For a stacked table T[S, R, D] and, per shard s, a source
// buffer of W ways — block ids ids[s, w] (-1 = invalid), dirty bits dirty[s, w],
// source copies src[s, w] and update copies upd[s, w] of BR x D — it computes,
// for every way that is valid and dirty,
//
//     T[s, ids[s, w] * BR : (ids[s, w] + 1) * BR] = apply(mem, delta(src, upd))
//
// in place. Kinds: add  mem + (upd - src)          (wrapping for integers)
//                  sat_add  clip(f32(mem) + (f32(upd) - f32(src)), lo, hi)
//                  max / min  against upd          (NaN-propagating for floats)
//                  or  mem | upd                   (integer tables only)
// Clean and invalid ways — and block ids past the table's end — leave memory
// untouched (the dirty-merge optimization). Block ids must be unique among the
// dirty ways of a shard, as they are in a source buffer (a block occupies at
// most one way) and in the spill buffer (one slot per block).
//
// Design. One CTA per (way, shard): it reads its way's id and dirty bit,
// returns at once if there is nothing to merge, else gathers the BR x D memory
// block, merges it element by element with the way's src and upd copies in
// registers and stores it back. The TPU kernel parks clean ways on an extra
// block because its BlockSpec index maps must always name one; a CTA simply
// returns, so there is no parking block and no copy of the table.
//
// What bounds it on an H100. The function moves each way's id and dirty bit,
// and for each merged way its memory block read once and written once and
// the copies its kind reads: src and upd for add and sat_add, upd alone for
// max, min and or. For the store's evict-merge (S = 8 shards, W = 1, BR = 8,
// D = 4 int32) that is about 3 KB, nanoseconds at 3.35 TB/s, so the launch
// itself is the floor. For a spill drain (W = 8192 slots, all in use) it is
// about 34 MB (add) or 25 MB (max, min), 10 or 7.6 us.
// Each CTA's block is one contiguous run of BR * D elements, read by
// neighbouring threads, so the accesses coalesce. At BR * D = 32 a CTA is
// one warp that moves 128 B per copy, so a drain launches 65536 tiny CTAs
// and runs at about 4x its byte bound. Giving each CTA several ways would
// close that gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

enum Kind { kAdd = 0, kSatAdd = 1, kMax = 2, kMin = 3, kOr = 4 };
enum DType { kF32 = 0, kBF16 = 1, kI32 = 2, kU32 = 3 };

// NaN-propagating max/min, as jnp.maximum / jnp.minimum.
__device__ __forceinline__ float max_prop(float a, float b) { return (a != a || a > b) ? a : b; }
__device__ __forceinline__ float min_prop(float a, float b) { return (a != a || a < b) ? a : b; }

template <int KIND>
__device__ __forceinline__ float merge(float mem, float src, float upd, float lo, float hi) {
  if (KIND == kAdd) return mem + (upd - src);
  if (KIND == kSatAdd) return min_prop(max_prop(mem + (upd - src), lo), hi);
  if (KIND == kMax) return max_prop(mem, upd);
  return min_prop(mem, upd);
}

// bf16: each jnp op rounds to bf16 (upd - src, then mem + that); sat_add
// computes in f32 and rounds once.
template <int KIND>
__device__ __forceinline__ __nv_bfloat16 merge(__nv_bfloat16 mem, __nv_bfloat16 src,
                                               __nv_bfloat16 upd, float lo, float hi) {
  const float m = __bfloat162float(mem), s = __bfloat162float(src), u = __bfloat162float(upd);
  if (KIND == kAdd) return __float2bfloat16_rn(m + __bfloat162float(__float2bfloat16_rn(u - s)));
  return __float2bfloat16_rn(merge<KIND>(m, s, u, lo, hi));
}

template <int KIND>
__device__ __forceinline__ int merge(int mem, int src, int upd, float lo, float hi) {
  if (KIND == kAdd) return (int)((unsigned)mem + ((unsigned)upd - (unsigned)src));
  if (KIND == kSatAdd) {
    const float s = __int2float_rn(mem) + (__int2float_rn(upd) - __int2float_rn(src));
    return __float2int_rz(min_prop(max_prop(s, lo), hi));
  }
  if (KIND == kMax) return max(mem, upd);
  if (KIND == kMin) return min(mem, upd);
  return mem | upd;
}

template <int KIND>
__device__ __forceinline__ unsigned merge(unsigned mem, unsigned src, unsigned upd, float lo,
                                          float hi) {
  if (KIND == kAdd) return mem + (upd - src);
  if (KIND == kSatAdd) {
    const float s = __uint2float_rn(mem) + (__uint2float_rn(upd) - __uint2float_rn(src));
    return __float2uint_rz(min_prop(max_prop(s, lo), hi));
  }
  if (KIND == kMax) return max(mem, upd);
  if (KIND == kMin) return min(mem, upd);
  return mem | upd;
}

template <typename T, int KIND>
__global__ void __launch_bounds__(256)
cmerge_kernel(T* __restrict__ table, const int* __restrict__ block_ids,
              const unsigned char* __restrict__ dirty, const T* __restrict__ src,
              const T* __restrict__ upd, long long R, int W, int BR, int D, float lo, float hi) {
  const long long way = (long long)blockIdx.y * W + blockIdx.x;
  const int b = block_ids[way];
  if (b < 0 || !dirty[way] || ((long long)b + 1) * BR > R) return;  // nothing to merge
  const int n = BR * D;
  T* mem = table + ((long long)blockIdx.y * R + (long long)b * BR) * D;
  const T* s = src + way * n;
  const T* u = upd + way * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) mem[i] = merge<KIND>(mem[i], s[i], u[i], lo, hi);
}

template <typename T, int KIND>
cudaError_t launch(void* table, const void* block_ids, const void* dirty, const void* src,
                   const void* upd, int S, long long R, int W, int BR, int D, float lo, float hi,
                   cudaStream_t stream) {
  const int n = BR * D;
  const int threads = n >= 256 ? 256 : (n + 31) / 32 * 32;
  const dim3 grid(W, S);
  cmerge_kernel<T, KIND><<<grid, threads, 0, stream>>>(
      static_cast<T*>(table), static_cast<const int*>(block_ids),
      static_cast<const unsigned char*>(dirty), static_cast<const T*>(src),
      static_cast<const T*>(upd), R, W, BR, D, lo, hi);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_kind(int kind, void* table, const void* block_ids, const void* dirty,
                        const void* src, const void* upd, int S, long long R, int W, int BR, int D,
                        float lo, float hi, cudaStream_t stream) {
  switch (kind) {
    case kAdd: return launch<T, kAdd>(table, block_ids, dirty, src, upd, S, R, W, BR, D, lo, hi, stream);
    case kSatAdd: return launch<T, kSatAdd>(table, block_ids, dirty, src, upd, S, R, W, BR, D, lo, hi, stream);
    case kMax: return launch<T, kMax>(table, block_ids, dirty, src, upd, S, R, W, BR, D, lo, hi, stream);
    case kMin: return launch<T, kMin>(table, block_ids, dirty, src, upd, S, R, W, BR, D, lo, hi, stream);
    case kOr:
      if constexpr (std::is_integral<T>::value)
        return launch<T, kOr>(table, block_ids, dirty, src, upd, S, R, W, BR, D, lo, hi, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// table [S, R, D]; block_ids int32 [S, W]; dirty bool [S, W]; src, upd
// [S, W, BR, D] in the table's dtype; all contiguous on the current device,
// R a multiple of BR. Updates `table` in place on `stream`. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int cmerge_launch(void* table, const void* block_ids, const void* dirty,
                             const void* src, const void* upd, long long S, long long R,
                             long long W, long long BR, long long D, int dtype, int kind,
                             float sat_min, float sat_max, void* stream) {
  if (S < 1 || S > 65535 || W < 0 || W > INT_MAX || BR < 1 || D < 1 || BR * D > INT_MAX ||
      R < BR || R % BR != 0 || R > (1LL << 62) / D)
    return cudaErrorInvalidValue;
  if (W == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int s = (int)S, w = (int)W, br = (int)BR, d = (int)D;
  switch (dtype) {
    case kF32: return launch_kind<float>(kind, table, block_ids, dirty, src, upd, s, R, w, br, d, sat_min, sat_max, st);
    case kBF16: return launch_kind<__nv_bfloat16>(kind, table, block_ids, dirty, src, upd, s, R, w, br, d, sat_min, sat_max, st);
    case kI32: return launch_kind<int>(kind, table, block_ids, dirty, src, upd, s, R, w, br, d, sat_min, sat_max, st);
    case kU32: return launch_kind<unsigned>(kind, table, block_ids, dirty, src, upd, s, R, w, br, d, sat_min, sat_max, st);
    default: return cudaErrorInvalidValue;
  }
}
