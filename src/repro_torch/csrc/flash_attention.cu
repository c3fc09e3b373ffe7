// flash_attention: forward GQA attention, causal or bidirectional, with an
// f32 online softmax.
//
// Replaces the TPU kernel `flash_attention` / `_kernel` of
// repro/kernels/flash_attention.py (a Pallas kernel). For q [B, H, S, d] and
// k, v [B, KV, T, d], KV dividing H, head h reads kv head h / (H / KV), and
//
//     o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, kvh, j]) v[b, kvh, j]
//
// with scale = 1 / sqrt(d) and, when causal, only keys j <= i (both counted
// from 0). As in the TPU kernel, q, k and v are widened to f32 before both
// products, masked scores are -1e30, the softmax runs online over kv tiles
// (running max m, sum l, accumulator acc), and the output is acc / max(l,
// 1e-30) in q's dtype.
//
// Design. One CTA of 256 threads per (tile of 64 query rows, head, batch).
// The query tile stays in shared memory (transposed, f32) while the CTA loops
// over kv tiles of 64 keys, each staged in shared memory (k transposed, v
// row-major, f32). Thread (ty, tx) of the 16 x 16 grid owns query rows
// ty*4..ty*4+3: it computes a 4 x 4 block of scores, keeps m and l of its 4
// rows in registers (the 16 threads of a row agree through warp shuffles),
// writes its probabilities to a shared 64 x 64 tile and accumulates 4 rows x
// 4 columns of every 64 output columns. The causal kv loop stops after the
// query tile's last row: the TPU kernel's skip of fully masked blocks. The
// tiles are read through strides, so the model's [B, S, H, d] views need no
// copy, and ragged S and T are masked here: there is no tiling requirement.
// d may be any multiple of 8 up to 256 (templated on 64, 128, 256 columns of
// shared memory).
//
// What bounds it on an H100. At qwen1.5-0.5b prefill (B 8, H 16, S = T = 512,
// d 64, causal, bf16) a layer's attention is about 4.3e9 operations (two
// products of 2 flops over the 131328 visible (query, key) pairs of each of
// the 128 heads, times d), 0.0043 ms at the 989 TFLOP/s of bf16 tensor cores,
// and moves 33.5 MB of q, k, v and o (8.4 MB each), 0.010 ms at 3.35 TB/s:
// on paper the bytes bound it. This first kernel does its products on the
// f32 cores, as the TPU kernel's f32 arithmetic does, at most 67 TFLOP/s:
// 0.064 ms for those operations, six times the byte bound. It issues two
// shared-memory loads for 16 FMAs in the score loop and 8 for 64 in the P.V
// loop, so the FMA rate, not shared memory, is its limit. bf16 products on
// the tensor cores (mma.sync, then wgmma fed by TMA) are the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64, kBK = 64, kThreads = 256, kPad = 4;
constexpr int kLd = kBQ + kPad;  // pitch of the transposed tiles and of P
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

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

template <int DMAX>
constexpr int smem_floats() {
  return 2 * DMAX * kLd + kBK * (DMAX + kPad) + kBQ * kLd;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int H, int KV, int S, int Tn, int d, long long qb, long long qh,
             long long qs, long long kb, long long kh, long long kt, long long vb, long long vh,
             long long vt, long long ob, long long oh, long long os, float scale, int causal) {
  constexpr int kLdv = DMAX + kPad;
  constexpr int kChunks = DMAX / 8;
  constexpr int kCols = DMAX / 64;  // 4-column groups a thread owns
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [DMAX][kLd]  q tile, transposed
  float* Kt = Qt + DMAX * kLd;                  // [DMAX][kLd]  k tile, transposed
  float* Vs = Kt + DMAX * kLd;                  // [kBK][kLdv]  v tile
  float* Ps = Vs + kBK * kLdv;                  // [kBQ][kLd]   probabilities

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * kBQ;
  const T* qp = q + b * qb + h * qh;
  const T* kp = k + b * kb + kvh * kh;
  const T* vp = v + b * vb + kvh * vh;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  // the query tile, transposed; rows past S and columns past d are zero
  for (int idx = tid; idx < kBQ * kChunks; idx += kThreads) {
    const int r = idx % kBQ, c = idx / kBQ;
    float x[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (q0 + r < S && c * 8 < d) load8(qp + (long long)(q0 + r) * qs + c * 8, x);
#pragma unroll
    for (int e = 0; e < 8; ++e) Qt[(c * 8 + e) * kLd + r] = x[e];
  }

  float m[4], l[4], acc[4][4 * kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kCols; ++c) acc[i][c] = 0.f;
  }

  // causal: no key past the tile's last query row
  const int kv_end = causal ? min(Tn, q0 + kBQ) : Tn;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBK * kChunks; idx += kThreads) {
      const int r = idx % kBK, c = idx / kBK;
      float xk[8] = {0, 0, 0, 0, 0, 0, 0, 0}, xv[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (k0 + r < Tn && c * 8 < d) {
        load8(kp + (long long)(k0 + r) * kt + c * 8, xk);
        load8(vp + (long long)(k0 + r) * vt + c * 8, xv);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) Kt[(c * 8 + e) * kLd + r] = xk[e];
      store4(Vs + r * kLdv + c * 8, xv[0], xv[1], xv[2], xv[3]);
      store4(Vs + r * kLdv + c * 8 + 4, xv[4], xv[5], xv[6], xv[7]);
    }
    __syncthreads();

    // scores of rows ty*4+i and keys tx*4+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < d; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + kk * kLd + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(Kt + kk * kLd + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // online softmax: the 16 threads of a row sit in one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx * 4 + j;
        float x = s[i][j] * scale;
        if (kj >= Tn || (causal && kj > qi)) x = kNegInf;
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kCols; ++c) acc[i][c] *= alpha;
      store4(Ps + (ty * 4 + i) * kLd + tx * 4, s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

    // acc += P . V over the tile's keys (masked ones have p = 0 exactly)
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 pr = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * kLd + kk);
        p[i][0] = pr.x; p[i][1] = pr.y; p[i][2] = pr.z; p[i][3] = pr.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(Vs + (kk + e) * kLdv + c * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][c * 4 + 0] = fmaf(p[i][e], vv.x, acc[i][c * 4 + 0]);
            acc[i][c * 4 + 1] = fmaf(p[i][e], vv.y, acc[i][c * 4 + 1]);
            acc[i][c * 4 + 2] = fmaf(p[i][e], vv.z, acc[i][c * 4 + 2]);
            acc[i][c * 4 + 3] = fmaf(p[i][e], vv.w, acc[i][c * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* op = o + b * ob + h * oh + (long long)row * os;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = c * 64 + tx * 4;
      if (col < d)
        store4(op + col, acc[i][c * 4] / lc, acc[i][c * 4 + 1] / lc, acc[i][c * 4 + 2] / lc,
               acc[i][c * 4 + 3] / lc);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                   int S, int Tn, int d, const long long* st, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * smem_floats<DMAX>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, DMAX><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, KV, S, Tn, d, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                     int S, int Tn, int d, const long long* st, float scale, int causal,
                     cudaStream_t stream) {
  if (d <= 64) return launch<T, 64>(q, k, v, o, B, H, KV, S, Tn, d, st, scale, causal, stream);
  if (d <= 128) return launch<T, 128>(q, k, v, o, B, H, KV, S, Tn, d, st, scale, causal, stream);
  return launch<T, 256>(q, k, v, o, B, H, KV, S, Tn, d, st, scale, causal, stream);
}

}  // namespace

// q [B, H, S, d], k and v [B, KV, T, d], o [B, H, S, d], each with unit stride
// in d and the element strides `strides` = (q: b, h, s; k: b, h, t; v: b, h,
// t; o: b, h, s), all multiples of 8, and 16-byte aligned data. dtype 0 = f32,
// 1 = bf16. Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      long long B, long long H, long long KV, long long S,
                                      long long T, long long d, const long long* strides,
                                      int dtype, int causal, float scale, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || KV < 1 || H % KV != 0 || S < 1 || T < 1 ||
      S > (1LL << 30) || T > (1LL << 30) || d < 8 || d > 256 || d % 8 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int b = (int)B, h = (int)H, kv = (int)KV, s = (int)S, t = (int)T, dd = (int)d;
  switch (dtype) {
    case 0: return launch_d<float>(q, k, v, o, b, h, kv, s, t, dd, strides, scale, causal, st);
    case 1: return launch_d<__nv_bfloat16>(q, k, v, o, b, h, kv, s, t, dd, strides, scale, causal, st);
    default: return cudaErrorInvalidValue;
  }
}
