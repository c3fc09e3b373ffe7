// decode_attention: one query token against a KV cache, over slots
// [0, position], with an f32 online softmax.
//
// Replaces the TPU kernel `decode_attention` / `_kernel` of
// repro/kernels/decode_attention.py (a Pallas kernel). For q [B, H, d] and the
// cache k, v [B, T, KV, d], the G = H / KV query heads of kv head kvh
// (heads kvh*G .. kvh*G+G-1) attend to slots 0..position of that kv head:
//
//     o[b, h] = sum_{j <= position} softmax_j(scale * q[b, h] . k[b, j, kvh]) v[b, j, kvh]
//
// scale = 1 / sqrt(d), scores, softmax and accumulator in f32, the output
// acc / max(l, 1e-30) in q's dtype, as in the TPU kernel.
//
// Design. One CTA of 256 threads per (kv head, batch row) holds the [G, d]
// query tile in shared memory: the G heads share each K and V row it reads.
// The CTA streams slots 0..position in tiles; `position` is a kernel argument,
// so nothing is read back to the host and slots past it are never read.
// Threads form groups of LPS lanes (LPS = d / 8 rounded up to a power of two):
// a group reads a slot's K row and V row as 16-byte chunks, one per lane,
// coalesced, and each thread loads its tile's (up to 4) K and V chunks before
// it uses any, to keep loads in flight. A group's lanes reduce the G dot
// products with shuffles; each warp then runs the softmax statistics of its
// heads over the tile; each thread accumulates P.V for its chunk of d over
// its slots, and the groups' partial sums are added once, at the end.
//
// What bounds it on an H100. Decode reads the cache: at qwen1.5-0.5b (B 8,
// KV 16, d 64, bf16) a layer at position 575 reads 576 slots x 2 x 16 x 64 x
// 2 B x 8 = 18.9 MB of K and V, 0.0056 ms at 3.35 TB/s; the operations (4 per
// cached element and head) are far below the tensor and f32 rates. It is
// byte-bound. B * KV = 128 CTAs leave 4 of the 132 SMs idle and give each busy
// SM one CTA of 8 warps; how close that comes to the memory rate is measured
// in chip_smoke.py. A split over slots (several CTAs per kv head and a second
// pass that merges their (m, l, acc)) would raise the loads in flight per SM;
// it is the next step if the measured time is far from the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256, kMaxTile = 128, kSpt = 4;  // kSpt: slots per thread and tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T, int GMAX>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, int H, int KV, int d, int position, int lps, long long qb,
              long long qh, long long kb, long long kt, long long kh, long long vb, long long vt,
              long long vh, long long ob, long long oh, float scale) {
  __shared__ float qs[GMAX][256];
  __shared__ float sc[GMAX][kMaxTile];
  __shared__ float red[2048];
  __shared__ float m_s[GMAX], l_s[GMAX], a_s[GMAX];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int groups = kThreads / lps;
  const int grp = tid / lps, ch = tid % lps;
  const bool ch_ok = ch * 8 < d;
  const int tile = min(kMaxTile, kSpt * groups);
  const int spt = tile / groups;
  const T* kp = k + b * kb + kvh * kh + ch * 8;
  const T* vp = v + b * vb + kvh * vh + ch * 8;

  for (int idx = tid; idx < G * d; idx += kThreads) {
    const int g = idx / d, c = idx % d;
    qs[g][c] = to_float(q[b * qb + (long long)(kvh * G + g) * qh + c]);
  }
  if (tid < GMAX) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[GMAX][8];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  __syncthreads();

  const int n = position + 1;
  for (int t0 = 0; t0 < n; t0 += tile) {
    float kx[kSpt][8], vx[kSpt][8];
#pragma unroll
    for (int i = 0; i < kSpt; ++i) {
      const int slot = t0 + grp + i * groups;
      if (i < spt && slot < n && ch_ok) {
        load8(kp + (long long)slot * kt, kx[i]);
        load8(vp + (long long)slot * vt, vx[i]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kx[i][e] = vx[i][e] = 0.f;
      }
    }
    // scores: a group's lanes each dot one chunk, then reduce by shuffles
#pragma unroll
    for (int i = 0; i < kSpt; ++i) {
      if (i >= spt) break;
      const int local = grp + i * groups;
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
        float dot = 0.f;
        if (ch_ok) {
#pragma unroll
          for (int e = 0; e < 8; ++e) dot = fmaf(qs[g][ch * 8 + e], kx[i][e], dot);
        }
        for (int off = lps / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (ch == 0) sc[g][local] = t0 + local < n ? dot * scale : kNegInf;
      }
    }
    __syncthreads();
    // softmax statistics of each head over the tile, one warp a head
    for (int g = warp; g < G; g += kThreads / 32) {
      float mx = kNegInf;
      for (int j = lane; j < tile; j += 32) mx = fmaxf(mx, sc[g][j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < tile; j += 32) {
        const float p = expf(sc[g][j] - m_new);
        sc[g][j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P . V for this thread's chunk and slots
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) break;
      const float alpha = a_s[g];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int i = 0; i < kSpt; ++i) {
        if (i >= spt) break;
        const float p = sc[g][grp + i * groups];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, vx[i][e], acc[g][e]);
      }
    }
    __syncthreads();  // sc is rewritten by the next tile
  }

  // add the groups' partial sums, head by head
  for (int g = 0; g < G && g < GMAX; ++g) {
    if (ch_ok) {
#pragma unroll
      for (int e = 0; e < 8; ++e) red[grp * d + ch * 8 + e] = acc[g][e];
    }
    __syncthreads();
    const float lc = fmaxf(l_s[g], 1e-30f);
    for (int c = tid; c < d; c += kThreads) {
      float s = 0.f;
      for (int gr = 0; gr < groups; ++gr) s += red[gr * d + c];
      store(o + b * ob + (long long)(kvh * G + g) * oh + c, s / lc);
    }
    __syncthreads();
  }
}

template <typename T, int GMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                   int d, int position, int lps, const long long* st, float scale,
                   cudaStream_t stream) {
  const dim3 grid(KV, B);
  decode_kernel<T, GMAX><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, KV, d, position, lps, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_g(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                     int d, int position, int lps, const long long* st, float scale,
                     cudaStream_t stream) {
  const int G = H / KV;
  if (G <= 1) return launch<T, 1>(q, k, v, o, B, H, KV, d, position, lps, st, scale, stream);
  if (G <= 2) return launch<T, 2>(q, k, v, o, B, H, KV, d, position, lps, st, scale, stream);
  if (G <= 4) return launch<T, 4>(q, k, v, o, B, H, KV, d, position, lps, st, scale, stream);
  if (G <= 8) return launch<T, 8>(q, k, v, o, B, H, KV, d, position, lps, st, scale, stream);
  return launch<T, 16>(q, k, v, o, B, H, KV, d, position, lps, st, scale, stream);
}

}  // namespace

// q [B, H, d], k and v [B, T, KV, d], o [B, H, d], each with unit stride in d
// and the element strides `strides` = (q: b, h; k: b, t, kv; v: b, t, kv; o:
// b, h), all multiples of 8, and 16-byte aligned data; G = H / KV <= 16 and
// 0 <= position < T. dtype 0 = f32, 1 = bf16. Launches on `stream`; returns
// the cudaError_t of the launch.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v, void* o,
                                       long long B, long long H, long long KV, long long T,
                                       long long d, long long position,
                                       const long long* strides, int dtype, float scale,
                                       void* stream) {
  if (B < 1 || B > 65535 || KV < 1 || KV > 65535 || H % KV != 0 || H / KV > 16 || T < 1 ||
      position < 0 || position >= T || position >= (1LL << 30) || d < 8 || d > 256 ||
      d % 8 != 0)
    return cudaErrorInvalidValue;
  int lps = 1;
  while (lps * 8 < d) lps *= 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int b = (int)B, h = (int)H, kv = (int)KV, dd = (int)d, pos = (int)position;
  switch (dtype) {
    case 0: return launch_g<float>(q, k, v, o, b, h, kv, dd, pos, lps, strides, scale, st);
    case 1: return launch_g<__nv_bfloat16>(q, k, v, o, b, h, kv, dd, pos, lps, strides, scale, st);
    default: return cudaErrorInvalidValue;
  }
}
