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
// What bounds it on an H100. The function moves each way's id and dirty bit,
// and for each merged way its memory block read once and written once and
// the copies its kind reads: src and upd for add and sat_add, upd alone for
// max, min and or. For the store's evict-merge (S = 8 shards, W = 1, BR = 8,
// D = 4 int32) that is about 3 KB, nanoseconds at 3.35 TB/s, so the launch
// itself is the floor. For a spill drain (W = 8192 slots, all in use) it is
// about 34 MB (add) or 25 MB (max, min), 10 or 7.6 us: bytes. One CTA per
// (way, shard) made the drain 65536 CTAs of one warp of 4-byte accesses, each
// waiting for its id before its block: about 4x the byte bound.
//
// Design. A CTA of up to 256 threads takes several consecutive ways of one
// shard: a group of LPW lanes (the block's accesses rounded up to a power of
// two, at most 32) per way, 32 ways a CTA at BR x D = 8 x 4 int32. The grid
// is (ceil(W / ways a CTA), S), so W = 1 (one evict), W = 8 (a flush) and
// W = 8192 (a drain) all launch one grid; a small W gets a CTA of fewer
// threads. A group's lanes read their way's id and dirty bit (neighbouring
// groups, neighbouring ways: coalesced), return at once if there is nothing
// to merge, then issue every load of their share of the block — mem, upd
// and, for add and sat_add only, src — before any merge or store, and merge
// in registers. Where the block's byte length is a multiple of 16 and the
// table, src and upd are 16-byte aligned, every access is 16 bytes (8 lanes a
// 128-byte block); other shapes take the same code with one element an
// access. The TPU kernel parks clean ways on an extra block because its
// BlockSpec index maps must always name one; a group simply returns, so there
// is no parking block and no copy of the table.

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

// bf16 elements as their bits, so that an element type can sit in a union
// with the 16-byte access type.
struct Bf16Bits {
  unsigned short x;
};

template <int KIND>
__device__ __forceinline__ Bf16Bits merge(Bf16Bits mem, Bf16Bits src, Bf16Bits upd, float lo,
                                          float hi) {
  return {__bfloat16_as_ushort(merge<KIND>(__ushort_as_bfloat16(mem.x),
                                           __ushort_as_bfloat16(src.x),
                                           __ushort_as_bfloat16(upd.x), lo, hi))};
}

// One access P (uint4, or the element itself) seen as its elements E.
template <typename E, typename P>
union Pack {
  P p;
  E e[sizeof(P) / sizeof(E)];
};

constexpr int kThreads = 256, kUnroll = 4;

template <typename E, typename P, int KIND>
__global__ void __launch_bounds__(kThreads)
cmerge_kernel(E* __restrict__ table, const int* __restrict__ block_ids,
              const unsigned char* __restrict__ dirty, const E* __restrict__ src,
              const E* __restrict__ upd, long long R, int W, int BR, int D, int lpw, float lo,
              float hi) {
  constexpr int kPer = sizeof(P) / sizeof(E);
  constexpr bool kReadsSrc = KIND == kAdd || KIND == kSatAdd;
  const int w = blockIdx.x * (blockDim.x / lpw) + threadIdx.x / lpw;
  if (w >= W) return;
  const int lane = threadIdx.x % lpw;
  const long long way = (long long)blockIdx.y * W + w;
  const int b = block_ids[way];
  const bool is_dirty = dirty[way];
  if (b < 0 || !is_dirty || ((long long)b + 1) * BR > R) return;  // nothing to merge
  const int n = BR * D / kPer;  // accesses a block
  P* mem = reinterpret_cast<P*>(table + ((long long)blockIdx.y * R + (long long)b * BR) * D);
  const P* s = reinterpret_cast<const P*>(src + way * BR * D);
  const P* u = reinterpret_cast<const P*>(upd + way * BR * D);
  for (int i0 = lane; i0 < n; i0 += kUnroll * lpw) {
    Pack<E, P> pm[kUnroll], ps[kUnroll], pu[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int i = i0 + j * lpw;
      if (i < n) {
        pm[j].p = mem[i];
        pu[j].p = u[i];
        if constexpr (kReadsSrc) ps[j].p = s[i];
        else ps[j].p = pu[j].p;  // unread by max, min, or
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int i = i0 + j * lpw;
      if (i < n) {
#pragma unroll
        for (int e = 0; e < kPer; ++e)
          pm[j].e[e] = merge<KIND>(pm[j].e[e], ps[j].e[e], pu[j].e[e], lo, hi);
        mem[i] = pm[j].p;
      }
    }
  }
}

template <typename E, typename P, int KIND>
cudaError_t launch_pack(void* table, const void* block_ids, const void* dirty, const void* src,
                        const void* upd, int S, long long R, int W, int BR, int D, float lo,
                        float hi, cudaStream_t stream) {
  const int n = BR * D / (int)(sizeof(P) / sizeof(E));
  int lpw = 1;
  while (lpw < n && lpw < 32) lpw *= 2;
  const long long want = (long long)W * lpw;
  const int threads = want >= kThreads ? kThreads : (int)((want + 31) / 32 * 32);
  const int ways = threads / lpw;  // ways a CTA
  const dim3 grid((unsigned)(((long long)W + ways - 1) / ways), S);
  cmerge_kernel<E, P, KIND><<<grid, threads, 0, stream>>>(
      static_cast<E*>(table), static_cast<const int*>(block_ids),
      static_cast<const unsigned char*>(dirty), static_cast<const E*>(src),
      static_cast<const E*>(upd), R, W, BR, D, lpw, lo, hi);
  return cudaGetLastError();
}

template <typename E, int KIND>
cudaError_t launch(void* table, const void* block_ids, const void* dirty, const void* src,
                   const void* upd, int S, long long R, int W, int BR, int D, float lo, float hi,
                   cudaStream_t stream) {
  const bool wide = (long long)BR * D * sizeof(E) % 16 == 0 &&
                    (reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(src) |
                     reinterpret_cast<uintptr_t>(upd)) % 16 == 0;
  if (wide)
    return launch_pack<E, uint4, KIND>(table, block_ids, dirty, src, upd, S, R, W, BR, D, lo, hi,
                                       stream);
  return launch_pack<E, E, KIND>(table, block_ids, dirty, src, upd, S, R, W, BR, D, lo, hi,
                                 stream);
}

template <typename E>
cudaError_t launch_kind(int kind, void* table, const void* block_ids, const void* dirty,
                        const void* src, const void* upd, int S, long long R, int W, int BR, int D,
                        float lo, float hi, cudaStream_t stream) {
  switch (kind) {
    case kAdd: return launch<E, kAdd>(table, block_ids, dirty, src, upd, S, R, W, BR, D, lo, hi, stream);
    case kSatAdd: return launch<E, kSatAdd>(table, block_ids, dirty, src, upd, S, R, W, BR, D, lo, hi, stream);
    case kMax: return launch<E, kMax>(table, block_ids, dirty, src, upd, S, R, W, BR, D, lo, hi, stream);
    case kMin: return launch<E, kMin>(table, block_ids, dirty, src, upd, S, R, W, BR, D, lo, hi, stream);
    case kOr:
      if constexpr (std::is_integral<E>::value)
        return launch<E, kOr>(table, block_ids, dirty, src, upd, S, R, W, BR, D, lo, hi, stream);
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
    case kBF16: return launch_kind<Bf16Bits>(kind, table, block_ids, dirty, src, upd, s, R, w, br, d, sat_min, sat_max, st);
    case kI32: return launch_kind<int>(kind, table, block_ids, dirty, src, upd, s, R, w, br, d, sat_min, sat_max, st);
    case kU32: return launch_kind<unsigned>(kind, table, block_ids, dirty, src, upd, s, R, w, br, d, sat_min, sat_max, st);
    default: return cudaErrorInvalidValue;
  }
}
