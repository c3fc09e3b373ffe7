// selective_scan: the Mamba-style selective SSM recurrence, forward and
// backward, one thread a channel walking time in order.
//
// No Pallas original. It replaces the chunked scan of the JAX package's
// repro/models/ssm.py: `_ssm_params` (the discretisation), `_scan_chunk` (a
// `jax.lax.associative_scan` over each 256-step chunk, chained across chunks
// by `apply_seq`'s `lax.scan`) and the `einsum("btds,bts->btd")` that reads
// the state out. That module calls its chunked scan the TPU adaptation of the
// CUDA selective-scan kernel; on this card the counterpart is the kernel.
// For dt, u [B, T, D] (dt after softplus, f32; u f32 or bf16, widened to f32
// in registers), b, c [B, T, S] f32, a [D, S] f32 (-exp(a_log)) and h0
// [B, D, S] f32:
//
//     h_t[d, s] = exp(dt_t[d] a[d, s]) h_{t-1}[d, s] + (dt_t[d] u_t[d]) b_t[s]
//     y_t[d]    = sum_s h_t[d, s] c_t[s]
//
// with the JAX products in the JAX grouping (`da = exp(dt * a)`, `dbx = (dt *
// u) * b`, `da * h + dbx`), `expf` and not `__expf`. It returns y [B, T, D]
// f32 and h_T [B, D, S]; the [B, T, D, S] states are never written.
//
// What bounds it on an H100. The forward must read dt, u and write y (at
// hymba-1.5b's prefill, [8, 2048, 3200]: 210 + 105 + 210 MB, 0.16 ms at
// 3.35 TB/s) and take B T D S exponentials (839M: 0.20 ms at the SFU's 16 a
// clock an SM, 132 SMs, 1.98 GHz), so the exponentials bound it. The
// backward reads dt, u, dy and writes d dt, d u (at one training rank's
// [2, 2048, 3200], 0.10 ms) and needs the B T D S exponentials again (0.05
// ms); this design takes them three times (the recomputes below). Both are
// far from either bound as designed here: the recurrence is sequential in t,
// and one thread a (b, d) gives B D threads (6400 at the training shape, two
// warps an SM in the backward), so they are bound by the latency of each
// thread's walk over T. Their times: PERF.md, from chip_smoke.py.
//
// Design (a simple first kernel).
// 1. Forward (scan_fwd_kernel): CTAs of 128 channels of one batch row; each
//    thread keeps its S states in registers and walks t in order; the CTA
//    stages b_t and c_t for 64 steps at a time in shared memory (they are
//    the same for all its channels). It also writes h at every kSeg = 256
//    steps, [B, ceil(T / 256) + 1, D, S] (the last entry is h_T), the
//    checkpoints of the backward; a caller that needs no gradient passes no
//    checkpoint buffer.
// 2. Backward (scan_bwd_kernel): CTAs of 64 channels (two warps) of one
//    batch row walk the segments in reverse. The recurrence is never
//    inverted (dividing by exp(dt a) fails where it underflows to 0): for a
//    segment, the CTA recomputes h forward from its checkpoint and keeps h
//    at every 16th step in shared memory; then, for each 16-step
//    sub-segment in reverse, it recomputes the sub-segment's 16 states into
//    shared memory and walks them backwards with
//        g_t  = dy_t c_t + exp(dt_{t+1} a) g_{t+1}      (dL/dh_t)
//        d dt = sum_s g h_{t-1} a exp(dt a) + u sum_s g b
//        d u  = dt sum_s g b
//        d b_t[s] = sum_d g dt u,  d c_t[s] = sum_d dy h_t
//        d a[d, s] = sum_{b, t} g h_{t-1} dt exp(dt a)
//    and dh0 = the last carry. Shared memory: 2 x 16 x S x 64 states plus
//    b and c of a segment (160 KB at S = 16), one CTA an SM.
//    The sums over d are deterministic: each step, a warp adds its 32
//    channels' 2S values (d b, d c) by a transposing shuffle reduction (a
//    fixed tree) and writes one partial per warp, [D / 32, B, T, 2S]; the
//    sum over (b, t) of d a is each thread's own, written per batch row,
//    [B, D, S]. A second launch (scan_bwd_reduce_kernel) adds the warps'
//    partials and the rows' in index order. No float atomics: two calls give
//    the same bits.
// Next steps (not done): split s across lanes with a shuffle sum for y, so
// that the training shape fills the card; chunked parallel forms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSeg = 256;          // checkpoint spacing (steps)
constexpr int kSub = 16;           // backward sub-segment (steps)
constexpr int kNSub = kSeg / kSub;
constexpr int kFwdThreads = 128;
constexpr int kFwdTile = 64;       // steps of b, c staged at a time
constexpr int kBwdThreads = 64;    // two warps
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Lane L ends with the warp's sum of v[L % N] (N a power of two <= 32): a
// transposing butterfly, each round (K = N/2, N/4, ..., 1, unrolled by the
// template, so that v stays in registers) halving the values a lane holds,
// then a plain butterfly over the lane bits above N. The tree is fixed, and
// a pair's two sums are the same bits (float addition commutes), so it is
// deterministic.
template <int K, int N>
__device__ __forceinline__ void transpose_rounds(float (&v)[N], int lane) {
  if constexpr (K >= 1) {
    const bool upper = (lane & K) != 0;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float send = upper ? v[i] : v[i + K];
      const float keep = upper ? v[i + K] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, K);
    }
    transpose_rounds<K / 2, N>(v, lane);
  }
}

template <int N>
__device__ __forceinline__ float warp_transpose_sum(float (&v)[N], int lane) {
  transpose_rounds<N / 2, N>(v, lane);
  float r = v[0];
#pragma unroll
  for (int k = N; k < 32; k *= 2) r += __shfl_xor_sync(0xffffffffu, r, k);
  return r;
}

template <int S, typename UT>
__global__ void __launch_bounds__(kFwdThreads)
scan_fwd_kernel(const float* __restrict__ dt, const UT* __restrict__ u,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ a, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_last,
                float* __restrict__ ckpt, int T, int D) {
  __shared__ float sb[kFwdTile * S];
  __shared__ float sc[kFwdTile * S];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kFwdThreads + threadIdx.x;
  const bool live = d < D;
  const int n_ck = (T + kSeg - 1) / kSeg + 1;
  float av[S], h[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    av[s] = live ? a[(size_t)d * S + s] : 0.f;
    h[s] = live ? h0[((size_t)b * D + d) * S + s] : 0.f;
  }
  const size_t row = (size_t)b * T;
  for (int t0 = 0; t0 < T; t0 += kFwdTile) {
    const int n = min(kFwdTile, T - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < n * S; i += kFwdThreads) {
      sb[i] = bm[(row + t0) * S + i];
      sc[i] = cm[(row + t0) * S + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int k = 0; k < n; ++k) {
      const int t = t0 + k;
      if (ckpt != nullptr && t % kSeg == 0) {
        float* out = ckpt + (((size_t)b * n_ck + t / kSeg) * D + d) * S;
#pragma unroll
        for (int s = 0; s < S; ++s) out[s] = h[s];
      }
      const size_t i = (row + t) * D + d;
      const float dtv = dt[i];
      const float x = dtv * widen(u[i]);
      float yv = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float da = expf(dtv * av[s]);
        h[s] = da * h[s] + x * sb[k * S + s];
        yv += h[s] * sc[k * S + s];
      }
      y[i] = yv;
    }
  }
  if (!live) return;
#pragma unroll
  for (int s = 0; s < S; ++s) h_last[((size_t)b * D + d) * S + s] = h[s];
  if (ckpt != nullptr) {
    float* out = ckpt + (((size_t)b * n_ck + n_ck - 1) * D + d) * S;
#pragma unroll
    for (int s = 0; s < S; ++s) out[s] = h[s];
  }
}

// One forward step of the recurrence on a thread's states, the forward's
// arithmetic to the bit.
template <int S, typename UT>
__device__ __forceinline__ void step(float (&h)[S], const float (&av)[S],
                                     const float* __restrict__ dt,
                                     const UT* __restrict__ u, size_t i,
                                     const float* sbt, bool live) {
  const float dtv = live ? dt[i] : 0.f;
  const float x = dtv * (live ? widen(u[i]) : 0.f);
#pragma unroll
  for (int s = 0; s < S; ++s) h[s] = expf(dtv * av[s]) * h[s] + x * sbt[s];
}

template <int S, typename UT>
__global__ void __launch_bounds__(kBwdThreads)
scan_bwd_kernel(const float* __restrict__ dt, const UT* __restrict__ u,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ a, const float* __restrict__ ckpt,
                const float* __restrict__ dy, const float* __restrict__ dh_last,
                float* __restrict__ ddt, UT* __restrict__ du,
                float* __restrict__ part_bc, float* __restrict__ part_a,
                float* __restrict__ dh0, int Bn, int T, int D) {
  extern __shared__ float smem[];
  float* sub_h = smem;                                  // [kNSub][S][64]
  float* hist = sub_h + kNSub * S * kBwdThreads;        // [kSub][S][64]
  float* sb = hist + kSub * S * kBwdThreads;            // [kSeg][S]
  float* sc = sb + kSeg * S;                            // [kSeg][S]
  const int tid = threadIdx.x, lane = tid & 31;
  const int b = blockIdx.y;
  const int d = blockIdx.x * kBwdThreads + tid;
  const bool live = d < D;
  const int w = blockIdx.x * (kBwdThreads / 32) + (tid >> 5);
  const int n_ck = (T + kSeg - 1) / kSeg + 1;
  float av[S], carry[S], gacc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    av[s] = live ? a[(size_t)d * S + s] : 0.f;
    carry[s] = (live && dh_last != nullptr) ? dh_last[((size_t)b * D + d) * S + s] : 0.f;
    gacc[s] = 0.f;
  }
  const size_t row = (size_t)b * T;
  for (int seg = n_ck - 2; seg >= 0; --seg) {
    const int t0 = seg * kSeg;
    const int len = min(kSeg, T - t0);
    __syncthreads();
    for (int i = tid; i < len * S; i += kBwdThreads) {
      sb[i] = bm[(row + t0) * S + i];
      sc[i] = cm[(row + t0) * S + i];
    }
    float h[S];
#pragma unroll
    for (int s = 0; s < S; ++s)
      h[s] = live ? ckpt[(((size_t)b * n_ck + seg) * D + d) * S + s] : 0.f;
    __syncthreads();
    // pass 1: the segment forward from its checkpoint, h kept every kSub steps
    for (int j = 0; j < len; ++j) {
      if (j % kSub == 0) {
#pragma unroll
        for (int s = 0; s < S; ++s) sub_h[((j / kSub) * S + s) * kBwdThreads + tid] = h[s];
      }
      step<S, UT>(h, av, dt, u, (row + t0 + j) * D + d, sb + j * S, live);
    }
    // pass 2: each sub-segment, last first: its states, then the reverse walk
    const int nsub = (len + kSub - 1) / kSub;
    for (int q = nsub - 1; q >= 0; --q) {
      const int j0 = q * kSub;
      const int n = min(kSub, len - j0);
#pragma unroll
      for (int s = 0; s < S; ++s) h[s] = sub_h[(q * S + s) * kBwdThreads + tid];
      for (int j = 0; j < n; ++j) {
#pragma unroll
        for (int s = 0; s < S; ++s) hist[(j * S + s) * kBwdThreads + tid] = h[s];
        if (j + 1 < n) step<S, UT>(h, av, dt, u, (row + t0 + j0 + j) * D + d, sb + (j0 + j) * S, live);
      }
      for (int j = n - 1; j >= 0; --j) {
        const int t = t0 + j0 + j;
        const size_t i = (row + t) * D + d;
        const float dtv = live ? dt[i] : 0.f;
        const float uv = live ? widen(u[i]) : 0.f;
        const float dyv = live ? dy[i] : 0.f;
        const float x = dtv * uv;
        const float* sbt = sb + (j0 + j) * S;
        const float* sct = sc + (j0 + j) * S;
        float v[2 * S];
        float gb = 0.f, gh = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float hp = hist[(j * S + s) * kBwdThreads + tid];   // h_{t-1}
          const float da = expf(dtv * av[s]);
          const float hc = da * hp + x * sbt[s];                   // h_t
          const float g = dyv * sct[s] + carry[s];
          v[s] = g * x;
          v[S + s] = dyv * hc;
          gb += g * sbt[s];
          const float gha = g * hp * da;
          gh += gha * av[s];
          gacc[s] += gha * dtv;
          carry[s] = da * g;
        }
        if (live) {
          ddt[i] = gh + uv * gb;
          put(du + i, dtv * gb);
        }
        const float r = warp_transpose_sum<2 * S>(v, lane);
        if (lane < 2 * S) part_bc[(((size_t)w * Bn + b) * T + t) * (2 * S) + lane] = r;
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    dh0[((size_t)b * D + d) * S + s] = carry[s];
    part_a[((size_t)b * D + d) * S + s] = gacc[s];
  }
}

// d b, d c: the warps' partials [nw, B, T, 2S] added in warp order; d a: the
// rows' [B, D, S] added in row order.
__global__ void __launch_bounds__(kReduceThreads)
scan_bwd_reduce_kernel(const float* __restrict__ part_bc, int nw, long long n_bc,
                       int S, float* __restrict__ db, float* __restrict__ dc,
                       const float* __restrict__ part_a, int Bn, long long n_a,
                       float* __restrict__ da) {
  const long long n = n_bc + n_a;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    if (idx < n_bc) {
      for (int w = 0; w < nw; ++w) acc += part_bc[(size_t)w * n_bc + idx];
      const long long bt = idx / (2 * S);
      const int j = (int)(idx % (2 * S));
      if (j < S)
        db[bt * S + j] = acc;
      else
        dc[bt * S + j - S] = acc;
    } else {
      const long long k = idx - n_bc;
      for (int r = 0; r < Bn; ++r) acc += part_a[(size_t)r * n_a + k];
      da[k] = acc;
    }
  }
}

template <int S, typename UT>
int launch_fwd(const void* dt, const void* u, const void* b, const void* c, const void* a,
               const void* h0, void* y, void* h_last, void* ckpt, int B, int T, int D,
               cudaStream_t stream) {
  const dim3 grid((D + kFwdThreads - 1) / kFwdThreads, B);
  scan_fwd_kernel<S, UT><<<grid, kFwdThreads, 0, stream>>>(
      (const float*)dt, (const UT*)u, (const float*)b, (const float*)c, (const float*)a,
      (const float*)h0, (float*)y, (float*)h_last, (float*)ckpt, T, D);
  return (int)cudaGetLastError();
}

template <int S>
constexpr size_t bwd_smem() {
  return sizeof(float) * ((size_t)(kNSub + kSub) * S * kBwdThreads + 2 * (size_t)kSeg * S);
}

template <int S, typename UT>
int launch_bwd(const void* dt, const void* u, const void* b, const void* c, const void* a,
               const void* ckpt, const void* dy, const void* dh_last, void* ddt, void* du,
               void* db, void* dc, void* da, void* dh0, void* part_bc, void* part_a, int B,
               int T, int D, cudaStream_t stream) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        scan_bwd_kernel<S, UT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bwd_smem<S>());
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int nblk = (D + kBwdThreads - 1) / kBwdThreads;
  scan_bwd_kernel<S, UT><<<dim3(nblk, B), kBwdThreads, bwd_smem<S>(), stream>>>(
      (const float*)dt, (const UT*)u, (const float*)b, (const float*)c, (const float*)a,
      (const float*)ckpt, (const float*)dy, (const float*)dh_last, (float*)ddt, (UT*)du,
      (float*)part_bc, (float*)part_a, (float*)dh0, B, T, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n_bc = (long long)B * T * 2 * S, n_a = (long long)D * S;
  const long long blocks = (n_bc + n_a + kReduceThreads - 1) / kReduceThreads;
  scan_bwd_reduce_kernel<<<(int)(blocks < 4096 ? blocks : 4096), kReduceThreads, 0, stream>>>(
      (const float*)part_bc, nblk * (kBwdThreads / 32), n_bc, S, (float*)db, (float*)dc,
      (const float*)part_a, B, n_a, (float*)da);
  return (int)cudaGetLastError();
}

bool shape_ok(long long B, long long T, long long D) {
  return B >= 1 && B <= 65535 && T >= 1 && D >= 1 && B * T * D < (1LL << 40) &&
         T < (1LL << 30) && D < (1LL << 30);
}

}  // namespace

// The forward: y [B, T, D] f32, h_last [B, D, S] f32 and, when ckpt is not
// null, the checkpoints [B, ceil(T / 256) + 1, D, S] f32. u_bf16 selects u's
// type (0: f32, 1: bf16). One launch. Returns a cudaError_t.
extern "C" int selective_scan_fwd_launch(const void* dt, const void* u, int u_bf16,
                                         const void* b, const void* c, const void* a,
                                         const void* h0, void* y, void* h_last, void* ckpt,
                                         long long B, long long T, long long D, int S,
                                         void* stream) {
  if (!shape_ok(B, T, D)) return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define FWD(SS, UT) launch_fwd<SS, UT>(dt, u, b, c, a, h0, y, h_last, ckpt, (int)B, (int)T, (int)D, st)
  switch (S * 2 + (u_bf16 ? 1 : 0)) {
    case 8: return FWD(4, float);
    case 9: return FWD(4, __nv_bfloat16);
    case 16: return FWD(8, float);
    case 17: return FWD(8, __nv_bfloat16);
    case 32: return FWD(16, float);
    case 33: return FWD(16, __nv_bfloat16);
    default: return cudaErrorInvalidValue;
  }
#undef FWD
}

// The backward: d dt [B, T, D] f32, d u [B, T, D] in u's type, d b, d c
// [B, T, S], d a [D, S] and d h0 [B, D, S], all f32, from dy [B, T, D] f32,
// dh_last [B, D, S] f32 (null: zero) and the forward's checkpoints. Scratch:
// part_bc [2 ceil(D / 64), B, T, 2S] and part_a [B, D, S] f32. Two launches.
extern "C" int selective_scan_bwd_launch(const void* dt, const void* u, int u_bf16,
                                         const void* b, const void* c, const void* a,
                                         const void* ckpt, const void* dy,
                                         const void* dh_last, void* ddt, void* du, void* db,
                                         void* dc, void* da, void* dh0, void* part_bc,
                                         void* part_a, long long B, long long T, long long D,
                                         int S, void* stream) {
  if (!shape_ok(B, T, D)) return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define BWD(SS, UT)                                                                     \
  launch_bwd<SS, UT>(dt, u, b, c, a, ckpt, dy, dh_last, ddt, du, db, dc, da, dh0, part_bc, \
                     part_a, (int)B, (int)T, (int)D, st)
  switch (S * 2 + (u_bf16 ? 1 : 0)) {
    case 8: return BWD(4, float);
    case 9: return BWD(4, __nv_bfloat16);
    case 16: return BWD(8, float);
    case 17: return BWD(8, __nv_bfloat16);
    case 32: return BWD(16, float);
    case 33: return BWD(16, __nv_bfloat16);
    default: return cudaErrorInvalidValue;
  }
#undef BWD
}

extern "C" int selective_scan_bwd_partials(long long D) {
  return (int)((D + kBwdThreads - 1) / kBwdThreads) * (kBwdThreads / 32);
}
