// decode_attention: one query token against a KV cache, over slots
// [0, position], with an f32 online softmax, split over slots.
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
// What bounds it on an H100. Decode reads the cache once: at internlm2-1.8b
// (B 8, KV 8, d 128, bf16) a layer at position 4095 reads 4096 slots x 2 x 8 x
// 128 x 2 B x 8 = 134 MB of K and V, 0.040 ms at 3.35 TB/s; at qwen1.5-0.5b
// (B 8, KV 16, d 64) position 575 it is 18.9 MB, 0.0056 ms. The operations (4
// per cached element and head) are far below the f32 and tensor rates. It is
// byte-bound, and the design's work is to keep enough loads in flight on
// every SM. One CTA per (kv head, batch row) gave only 64 CTAs at internlm2
// (128 at qwen) on 132 SMs, each loading a tile, then waiting at block-wide
// barriers while a few warps ran the softmax: about 420 GB/s.
//
// Design: two launches.
// 1. The split pass: a grid of (splits, KV, B) CTAs of 128 threads. The
//    wrapper derives `splits` from T, B, KV, d and the SM count, never from
//    `position`, so every decode step has the same launch shape: about four
//    CTAs per SM, and at least 12 slots for each lane group of a CTA. That is
//    8 splits (512 CTAs) at internlm2 and 3 (384 CTAs) at qwen. Split s
//    covers slots [s * chunk, (s + 1) * chunk) with chunk = ceil(T / splits),
//    cut at position; a split that starts past position reads nothing and
//    writes an empty partial (m = -1e30, l = 0, acc = 0).
//    Inside a CTA, threads form groups of LPS lanes (LPS = d / 8 rounded up
//    to a power of two); a group takes a slot's K and V rows as 16-byte
//    pieces, one (bf16) or two (f32) a lane, coalesced, and its lanes add
//    the G dot products with shuffles: the G heads share every row read.
//    Each group keeps its own online-softmax state (m, l, acc) in registers
//    and walks its slots in tiles of U slots (bf16: 4, or 2 for G > 2; f32
//    half as many). The loads go through a ring of three tiles in shared
//    memory filled by cp.async: two tiles ahead of the one being reduced are
//    in flight, and they cost no registers. Each thread reads back only the
//    pieces it copied, so the loop has no block-wide barrier. The groups'
//    states are merged once, at the end of the chunk, and the CTA writes its
//    f32 partial (m, l, acc[G, d]) to scratch. `position` is a kernel
//    argument: nothing is read back to the host, and slots past it are never
//    read. At about 54 KB of shared memory a CTA, an SM holds four.
// 2. The combine pass: one CTA per (head, batch row) merges the splits'
//    partials in f32, m* = max m_i, l = sum l_i exp(m_i - m*), acc = sum
//    acc_i exp(m_i - m*), in split order (deterministic), and writes
//    acc / max(l, 1e-30) in q's dtype. It costs about 2 us a call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;     // split pass: 4 warps a CTA
constexpr int kStages = 3;        // tiles in the split pass's cp.async ring
constexpr int kMaxSplits = 1024;
constexpr int kMaxDevices = 64;
constexpr float kNegInf = -1e30f;

// A lane's 8 consecutive elements of a row: one 16-byte access for bf16, two
// for f32.
template <typename T>
struct Chunk {
  static constexpr int kVec = 8 * sizeof(T) / 16;
  uint4 r[kVec];
};

template <typename T, int GMAX>
struct Cfg {
  // U: slots a group takes per tile (2 U kVec 16-byte pieces a lane)
  static constexpr int kSlots = (GMAX <= 2 ? 4 : 2) / Chunk<T>::kVec;
  static constexpr bool kQInRegs = GMAX <= 4;           // else q lives in shared memory
  static constexpr int kMinBlocks = GMAX <= 8 ? 4 : 2;  // CTAs an SM should hold
};

template <typename T>
__device__ __forceinline__ void load_chunk(Chunk<T>& c, const T* p) {
#pragma unroll
  for (int i = 0; i < Chunk<T>::kVec; ++i) c.r[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
}

template <typename T>
__device__ __forceinline__ void zero_chunk(Chunk<T>& c) {
#pragma unroll
  for (int i = 0; i < Chunk<T>::kVec; ++i) c.r[i] = make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ void to_f32(const Chunk<float>& c, float (&x)[8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    x[4 * i] = __uint_as_float(c.r[i].x);
    x[4 * i + 1] = __uint_as_float(c.r[i].y);
    x[4 * i + 2] = __uint_as_float(c.r[i].z);
    x[4 * i + 3] = __uint_as_float(c.r[i].w);
  }
}

__device__ __forceinline__ void to_f32(const Chunk<__nv_bfloat16>& c, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&c.r[0]);
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

// 16 bytes from global to shared memory without registers (cp.async, L2
// only); `bytes` = 0 fills the 16 bytes with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// The split pass. Partials are f32, indexed by ((split * B + b) * H + h):
// m_out and l_out one value a head, acc_out d values a head. Each thread
// copies its own 16-byte pieces of K and V into its own slots of a ring of
// kStages tiles in shared memory, laid out so that neighbouring threads use
// neighbouring 16 bytes, and reads back only what it copied: no barrier.
template <typename T, int GMAX>
__global__ void __launch_bounds__(kThreads, Cfg<T, GMAX>::kMinBlocks)
split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             float* __restrict__ m_out, float* __restrict__ l_out, float* __restrict__ acc_out,
             int H, int KV, int d, int position, int chunk, int lps, long long qb, long long qh,
             long long kb, long long kt, long long kh, long long vb, long long vt, long long vh,
             float scale) {
  constexpr int U = Cfg<T, GMAX>::kSlots;
  constexpr int kVec = Chunk<T>::kVec;
  constexpr bool kQReg = Cfg<T, GMAX>::kQInRegs;
  extern __shared__ uint4 ring[];  // [kStages][U][K, V][kVec][kThreads]
  __shared__ float qs[kQReg ? 1 : GMAX][kQReg ? 1 : 256];
  __shared__ float ms[kThreads * GMAX], ls[kThreads * GMAX];
  __shared__ float red[kThreads * 8];  // groups * d <= kThreads * 8

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int B = gridDim.z, G = H / KV;
  const int tid = threadIdx.x;
  const int groups = kThreads / lps, grp = tid / lps, ch = tid % lps;
  const bool ch_ok = ch * 8 < d;
  const int start = split * chunk;
  const int end = min(start + chunk, position + 1);
  const long long part = ((long long)split * B + b) * H + (long long)kvh * G;

  if (start >= end) {  // the whole split lies past position: an empty partial
    for (int i = tid; i < G * d; i += kThreads) acc_out[part * d + i] = 0.f;
    if (tid < G) {
      m_out[part + tid] = kNegInf;
      l_out[part + tid] = 0.f;
    }
    return;
  }

  const T* kp = k + b * kb + (long long)kvh * kh + ch * 8;
  const T* vp = v + b * vb + (long long)kvh * vh + ch * 8;
  const int tile = U * groups;
  const int tiles = (end - start + tile - 1) / tile;
  auto slot_of = [&](int j, int u) { return start + (j * U + u) * groups + grp; };
  auto piece = [&](int stage, int u, int kv, int i) -> uint4* {
    return ring + (((stage * U + u) * 2 + kv) * kVec + i) * kThreads + tid;
  };
  // tile j into its stage of the ring, then one commit group (empty past the end)
  auto issue = [&](int j) {
    if (j < tiles) {
      const int stage = j % kStages;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int slot = slot_of(j, u);
        const bool ok = slot < end && ch_ok;
        const uint4* ks = reinterpret_cast<const uint4*>(ok ? kp + (long long)slot * kt : k);
        const uint4* vs = reinterpret_cast<const uint4*>(ok ? vp + (long long)slot * vt : v);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          cp_async16(piece(stage, u, 0, i), ks + (ok ? i : 0), ok ? 16 : 0);
          cp_async16(piece(stage, u, 1, i), vs + (ok ? i : 0), ok ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) issue(j);  // in flight while q is read

  float qr[kQReg ? GMAX : 1][8];
  const T* qp = q + b * qb + (long long)kvh * G * qh;
  if constexpr (kQReg) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      Chunk<T> c;
      if (g < G && ch_ok) load_chunk(c, qp + g * qh + ch * 8);
      else zero_chunk(c);
      to_f32(c, qr[g]);
    }
  } else {
    for (int idx = tid; idx < G * d; idx += kThreads) {
      const int g = idx / d, c = idx % d;
      qs[g][c] = to_float(qp[g * qh + c]);
    }
    __syncthreads();
  }

  float m[GMAX], l[GMAX], acc[GMAX][8];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  for (int j = 0; j < tiles; ++j) {
    issue(j + kStages - 1);
    cp_async_wait<kStages - 1>();  // this thread's pieces of tile j have landed
    const int stage = j % kStages;
    float s[U][GMAX];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ok[u] = slot_of(j, u) < end;
      Chunk<T> kc;
#pragma unroll
      for (int i = 0; i < kVec; ++i) kc.r[i] = *piece(stage, u, 0, i);
      float kx[8];
      to_f32(kc, kx);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float qv;
          if constexpr (kQReg) qv = qr[g][e];
          else qv = ch_ok ? qs[g][ch * 8 + e] : 0.f;
          dot = fmaf(qv, kx[e], dot);
        }
        s[u][g] = dot;
      }
    }
    // a group's lanes add their U x G partial dot products, all at once
    for (int off = lps / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          if (g < G) s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) break;
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u][g] = ok[u] ? s[u][g] * scale : kNegInf;
        mx = fmaxf(mx, s[u][g]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float alpha = __expf(m[g] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = ok[u] ? __expf(s[u][g] - m_new) : 0.f;
        s[u][g] = p;
        sum += p;
      }
      l[g] = l[g] * alpha + sum;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      Chunk<T> vc;
#pragma unroll
      for (int i = 0; i < kVec; ++i) vc.r[i] = *piece(stage, u, 1, i);
      float vx[8];
      to_f32(vc, vx);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(s[u][g], vx[e], acc[g][e]);
      }
    }
  }
  cp_async_wait<0>();

  // merge the groups' states, head by head, into the CTA's partial
  if (ch == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      ms[grp * GMAX + g] = m[g];
      ls[grp * GMAX + g] = l[g];
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
    float mx = kNegInf;
    for (int i = 0; i < groups; ++i) mx = fmaxf(mx, ms[i * GMAX + g]);
    const float w = expf(m[g] - mx);
    if (ch_ok) {
#pragma unroll
      for (int e = 0; e < 8; ++e) red[grp * d + ch * 8 + e] = acc[g][e] * w;
    }
    __syncthreads();
    for (int c = tid; c < d; c += kThreads) {
      float a = 0.f;
      for (int i = 0; i < groups; ++i) a += red[i * d + c];
      acc_out[(part + g) * d + c] = a;
    }
    if (tid == 0) {
      float sum = 0.f;
      for (int i = 0; i < groups; ++i) sum += ls[i * GMAX + g] * expf(ms[i * GMAX + g] - mx);
      m_out[part + g] = mx;
      l_out[part + g] = sum;
    }
    __syncthreads();  // red is rewritten for the next head
  }
}

// The combine pass: one CTA per (head, batch row), a thread per element of
// d. Each thread issues its loads of the first kPre splits' acc together with
// the (m, l) of every split, so a call of up to kPre splits reads its
// partials in one round trip.
constexpr int kPre = 8;

template <typename T>
__global__ void __launch_bounds__(256)
combine_kernel(const float* __restrict__ m, const float* __restrict__ l,
               const float* __restrict__ acc, T* __restrict__ o, int H, int d, int splits,
               long long ob, long long oh) {
  __shared__ float ms[kMaxSplits], ls[kMaxSplits];
  const int h = blockIdx.x, b = blockIdx.y, B = gridDim.y, c = threadIdx.x;
  const long long head = (long long)b * H + h, stride = (long long)B * H;
  float pre[kPre];
#pragma unroll
  for (int i = 0; i < kPre; ++i)
    pre[i] = i < splits && c < d ? acc[(i * stride + head) * d + c] : 0.f;
  for (int i = c; i < splits; i += blockDim.x) {
    ms[i] = m[i * stride + head];
    ls[i] = l[i * stride + head];
  }
  __syncthreads();
  float mx = kNegInf;
  for (int i = 0; i < splits; ++i) mx = fmaxf(mx, ms[i]);
  float sum = 0.f, a = 0.f;
#pragma unroll
  for (int i = 0; i < kPre; ++i) {
    if (i >= splits) break;
    const float w = expf(ms[i] - mx);
    sum += ls[i] * w;
    a += pre[i] * w;
  }
  for (int i = kPre; i < splits; ++i) {
    const float w = expf(ms[i] - mx);
    sum += ls[i] * w;
    a += (c < d ? acc[(i * stride + head) * d + c] : 0.f) * w;
  }
  if (c < d) store(o + b * ob + (long long)h * oh + c, a / fmaxf(sum, 1e-30f));
}

template <typename T, int GMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* m, float* l,
                   float* acc, int B, int H, int KV, int d, int position, int chunk, int splits,
                   int lps, const long long* st, float scale, cudaStream_t stream) {
  constexpr int ring = kStages * Cfg<T, GMAX>::kSlots * 2 * 16 * Chunk<T>::kVec * kThreads;
  static bool ring_allowed[kMaxDevices] = {};  // the ring's opt-in, once a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ring_allowed[dev]) {
    err = cudaFuncSetAttribute(split_kernel<T, GMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ring);
    if (err != cudaSuccess) return err;
    ring_allowed[dev] = true;
  }
  split_kernel<T, GMAX><<<dim3(splits, KV, B), kThreads, ring, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), m, l, acc, H,
      KV, d, position, chunk, lps, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_kernel<T><<<dim3(H, B), (d + 31) / 32 * 32, 0, stream>>>(  // d <= 256
      m, l, acc, static_cast<T*>(o), H, d, splits, st[8], st[9]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_g(const void* q, const void* k, const void* v, void* o, float* m, float* l,
                     float* acc, int B, int H, int KV, int d, int position, int chunk, int splits,
                     int lps, const long long* st, float scale, cudaStream_t stream) {
  const int G = H / KV;
#define DECODE_LAUNCH(GM)                                                                      \
  return launch<T, GM>(q, k, v, o, m, l, acc, B, H, KV, d, position, chunk, splits, lps, st, \
                       scale, stream)
  if (G <= 1) DECODE_LAUNCH(1);
  if (G <= 2) DECODE_LAUNCH(2);
  if (G <= 4) DECODE_LAUNCH(4);
  if (G <= 8) DECODE_LAUNCH(8);
  DECODE_LAUNCH(16);
#undef DECODE_LAUNCH
}

}  // namespace

// q [B, H, d], k and v [B, T, KV, d], o [B, H, d], each with unit stride in d
// and the element strides `strides` = (q: b, h; k: b, t, kv; v: b, t, kv; o:
// b, h), all multiples of 8, and 16-byte aligned data; G = H / KV <= 16,
// 0 <= position < T < 2^30 and 1 <= splits <= 1024. `scratch` is f32 of
// splits * B * H * (d + 2) values: the partials m [splits, B, H], then l
// [splits, B, H], then acc [splits, B, H, d]. dtype 0 = f32, 1 = bf16.
// Launches the split pass and then the combine pass on `stream`; returns the
// cudaError_t of the first launch that failed, else 0.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v, void* o,
                                       void* scratch, long long B, long long H,
                                       long long KV, long long T, long long d,
                                       long long position, long long splits,
                                       const long long* strides, int dtype, float scale,
                                       void* stream) {
  if (B < 1 || B > 65535 || KV < 1 || KV > 65535 || H % KV != 0 || H / KV > 16 || H > (1 << 30) ||
      T < 1 || T >= (1LL << 30) || position < 0 || position >= T || d < 8 || d > 256 ||
      d % 8 != 0 || splits < 1 || splits > kMaxSplits)
    return cudaErrorInvalidValue;
  int lps = 1;
  while (lps * 8 < d) lps *= 2;
  const int chunk = (int)((T + splits - 1) / splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(scratch);
  float* lf = mf + splits * B * H;
  float* af = lf + splits * B * H;
  const int b = (int)B, h = (int)H, kv = (int)KV, dd = (int)d, pos = (int)position,
            sp = (int)splits;
  switch (dtype) {
    case 0:
      return launch_g<float>(q, k, v, o, mf, lf, af, b, h, kv, dd, pos, chunk, sp, lps, strides,
                             scale, st);
    case 1:
      return launch_g<__nv_bfloat16>(q, k, v, o, mf, lf, af, b, h, kv, dd, pos, chunk, sp, lps,
                                     strides, scale, st);
    default: return cudaErrorInvalidValue;
  }
}
