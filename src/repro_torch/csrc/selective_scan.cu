// selective_scan: the Mamba-style selective SSM recurrence, forward and
// backward, parallel over chunks of time and with each channel's states
// spread over several lanes.
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
// backward reads dt, u, dy, b, c, a, h0 and dh and writes the six
// gradients (at one training rank's [2, 2048, 3200], u bf16: 212 MB, 0.063
// ms), and needs the B T D S exponentials again (0.05 ms); the bytes bound
// it. Neither bound counts the checkpoints below: they are this design's
// choice, not the function's need. This design takes 2 B T D S
// exponentials in the forward and 3 in the backward. Each is expf's eight
// instructions (five f32 operations, a shift, the SFU's ex2 and a
// multiply), so a forward step of a lane's four states is about 64 issue
// slots a warp, and the SFU's 16 a clock an SM is not the limit: the
// kernels are bound by instruction issue, not by latency or bytes (the
// bound stays the one above).
//
// What it replaces. The first version of these kernels ran one thread a
// (b, d) that walked all of T in order, reading dt and u from device memory
// at every step: 6400 threads at B = 2, every step waiting a memory round
// trip (on an H100, 1.44 ms forward and 3.64 backward at the training
// shape; PERF.md). Here:
//
// * Time is cut into chunks of kChunk = 64 steps. The recurrence is linear,
//   so a chunk's states are its local states from zero plus the product of
//   its decays times its start state. L = 64 is the longest chunk whose
//   backward CTA (the whole chunk's dt, u, dy, b, c, its sub-chunk starts
//   and its reduction buffer: 52 KB at S = 16) leaves four CTAs an SM; it
//   gives 32 chunks at T = 2048, so B = 2 already fills the card; and of
//   L = 32, 64 and 128 it was the fastest in both directions on an H100
//   (scripts/scan_sweep.py times them).
// * A channel's S states are spread over P = S / 4 lanes, four states a
//   lane (4 lanes at S = 16, 2 at S = 8, 1 at S = 4); a CTA holds 32
//   channels, 32 P threads. y's sum over s is one FMA chain in s order,
//   handed from lane group to lane group by shuffles (the first version's
//   order: the same bits where the states agree). At B = 2, T = 2048, D =
//   3200, S = 16: 409,600 threads.
// * No step waits on device memory: a CTA loads its whole chunk of dt, u
//   (and dy), b and c into shared memory at its start, every load issued
//   before the first is used, and walks from there; the other CTAs of the
//   SM (four or more) cover that load. Outputs go back through the same
//   shared rows (a step's slot is dead once the step is done), written out
//   coalesced after the walk.
//
// Forward, three launches:
// 1. scan_fwd_chunk_kernel<.., false>, a CTA a (32 channels, chunk, b), for
//    every chunk but the last (nc = ceil(T / 64)): the chunk's local end
//    state from zero and its decay product prod_t exp(dt_t a) per state,
//    taken as exp(a sum_t dt_t) (one exponential a chunk, no multiply a
//    step; its error, |a sum dt| exp(a sum dt) times sum dt's relative
//    error, is at most about e^-1 of that), to scratch [2, B, nc, D, S].
// 2. scan_fwd_carry_kernel, a thread a (b, d, s): the walk over the chunks,
//    start_{k+1} = decay_k start_k + local_k from h0. It writes each chunk's
//    true start state to the checkpoints [B, nc + 1, D, S] (the backward's,
//    64 steps apart).
// 3. scan_fwd_chunk_kernel<.., true>: each chunk again from its true start
//    state, y_t = sum_s h_t c_t. The last chunk's walk ends in h_T, the
//    state its last y was read from: it writes h_T and the checkpoints'
//    last slot.
// It never divides by a decay: exp(dt a) underflows to 0 at large dt |a|,
// and a product of decays does too, which the carry then takes as it is.
//
// Backward, four launches. The adjoint g_t = dL/dh_t,
//     g_t  = dy_t c_t + exp(dt_{t+1} a) g_{t+1}        (g_{T-1} gets dh_T)
// does not depend on h, so it chains over chunks as the forward does:
// 1. scan_bwd_local_kernel: per (chunk, b, channel) the chunk's local carry
//    out from a zero carry in, sum_t (prod_{k <= t} exp(dt_k a)) dy_t c_t
//    (a forward walk), and its decay product, to scratch.
// 2. scan_bwd_carry_kernel, a thread a (b, d, s): the reverse walk over the
//    chunks, carry_{k} = local_{k+1} + decay_{k+1} carry_{k+1} from dh_T
//    (zero when h_T is unused), gives the carry into each chunk from the
//    right, and d h0.
// 3. scan_bwd_chunk_kernel: per chunk, h forward from the forward's
//    checkpoint (the state every kSub = 8 steps kept in shared memory); then
//    each 8-step sub-chunk, last first: its states and decays recomputed
//    into registers and walked in reverse with the true carry,
//        d dt = sum_s g h_{t-1} a exp(dt a) + u sum_s g b
//        d u  = dt sum_s g b
//        d b_t[s] = sum_d g dt u,  d c_t[s] = sum_d dy h_t
//        d a[d, s] = sum_{b, t} g h_{t-1} dt exp(dt a)
//    The sums over d are deterministic: a warp adds its channels' 2S values
//    by a transposing shuffle reduction (a fixed tree), the CTA adds its
//    warps in order and writes one partial a CTA, [ceil(D / 32), B, T, 2S];
//    d a's sum over t is each lane's own, written per (b, chunk), [B, nc, D,
//    S].
// 4. scan_bwd_reduce_kernel adds the CTAs' partials and the (b, chunk)
//    rows' in index order. No float atomics: two calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;         // steps a chunk: the checkpoint spacing
constexpr int kSub = 8;            // backward sub-chunk (steps in registers)
constexpr int kNSub = kChunk / kSub;
constexpr int kPer = 4;            // states a lane
constexpr int kChan = 32;          // channels a CTA
constexpr int kCarryThreads = 256;
constexpr int kReduceThreads = 256;

// P lanes a channel, R channels a warp, 32 P threads (P warps) a CTA. Lane
// l of warp w serves channel w R + l % R and states [4 (l / R), +4).
template <int S>
struct Geo {
  static_assert(S % kPer == 0 && S / kPer >= 1 && S / kPer <= 4, "S in 4, 8, 16");
  static constexpr int P = S / kPer;
  static constexpr int R = 32 / P;
  static constexpr int kThreads = 32 * P;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ void load4(float (&v)[kPer], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[kPer]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Lane L ends with the sum of v[L % N] over the lanes that differ from it in
// the bits below R (N, R powers of two, N <= R <= 32): a transposing
// butterfly, each round (K = N/2, N/4, ..., 1, unrolled by the template, so
// that v stays in registers) halving the values a lane holds, then a plain
// butterfly over the lane bits from N up to R. The tree is fixed, and a
// pair's two sums are the same bits (float addition commutes), so it is
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

template <int N, int R>
__device__ __forceinline__ float warp_transpose_sum(float (&v)[N], int lane) {
  static_assert(N <= R && R <= 32, "the values must fit the reduced lanes");
  transpose_rounds<N / 2, N>(v, lane);
  float r = v[0];
#pragma unroll
  for (int k = N; k < R; k *= 2) r += __shfl_xor_sync(0xffffffffu, r, k);
  return r;
}

// y_t = sum_s h[s] c[s] as one FMA chain over s = 0, 1, ..., S - 1, carried
// from each lane group of a channel to the next by a shuffle: the order of
// the kernel this one replaced, so that y has its bits wherever the states
// do. Every lane of the channel ends with the sum.
template <int R>
__device__ __forceinline__ float chain_dot(const float (&h)[kPer], const float (&c)[kPer],
                                           int lane) {
  float y = 0.f;
#pragma unroll
  for (int q = 0; q < 32 / R; ++q) {
    float acc = y;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc = fmaf(h[i], c[i], acc);
    y = R == 32 ? acc : __shfl_sync(0xffffffffu, acc, q * R + lane % R);
  }
  return y;
}

// The sum of x over the P lanes of a channel (the lane bits from R up).
template <int R>
__device__ __forceinline__ float channel_sum(float x) {
#pragma unroll
  for (int o = R; o < 32; o *= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A chunk's rows [len, 32] of a [B, T, D] tensor into dst [kChunk][kChan]
// (f32), zero past len steps or past D channels.
template <int NT, typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ src,
                                           size_t base, int len, int d0, int D) {
#pragma unroll 8
  for (int i = threadIdx.x; i < kChunk * kChan; i += NT) {
    const int j = i / kChan, c = i % kChan;
    dst[i] = (j < len && d0 + c < D) ? widen(src[base + (size_t)j * D + c]) : 0.f;
  }
}

// A chunk's rows of a [B, T, S] tensor into dst [kChunk][S], zero past len.
template <int NT, int S>
__device__ __forceinline__ void stage_states(float* dst, const float* __restrict__ src,
                                             size_t base, int len) {
#pragma unroll 4
  for (int i = threadIdx.x; i < kChunk * S; i += NT)
    dst[i] = i < len * S ? src[base + i] : 0.f;
}

// Forward, launches 1 (kOut false) and 3 (kOut true). Grid (ceil(D / 32),
// chunks, B). kOut false, chunks 0 .. nc - 2 (a CTA past them returns): the
// chunk from zero; writes its end state to out0 = local [B, nc, D, S] and
// its decay product to out1 = decay. kOut true: the chunk from start [B,
// nc + 1, D, S] slot k; writes y to out0 and, from the last chunk, its end
// state to out1 = the same checkpoints' slot nc (so start and out1 are not
// restrict) and to out2 = h_last.
template <int S, typename UT, bool kOut>
__global__ void __launch_bounds__(Geo<S>::kThreads)
scan_fwd_chunk_kernel(const float* __restrict__ dt, const UT* __restrict__ u,
                      const float* __restrict__ bm, const float* __restrict__ cm,
                      const float* __restrict__ a, const float* start,
                      float* __restrict__ out0, float* out1, float* __restrict__ out2,
                      int T, int D) {
  using G = Geo<S>;
  const int nc = (T + kChunk - 1) / kChunk;
  if (!kOut && (int)blockIdx.y >= nc - 1) return;
  __shared__ float s_dt[kChunk * kChan];   // dt; y once a step is done
  __shared__ float s_u[kChunk * kChan];
  __shared__ __align__(16) float s_b[kChunk * S];
  __shared__ __align__(16) float s_c[kOut ? kChunk * S : 4];
  const int tid = threadIdx.x, lane = tid & 31;
  const int p = lane / G::R, ch = (tid >> 5) * G::R + lane % G::R;
  const int d0 = blockIdx.x * kChan, k = blockIdx.y, b = blockIdx.z;
  const int t0 = k * kChunk, len = min(kChunk, T - t0);
  const int d = d0 + ch;
  const bool live = d < D;
  const size_t row = (size_t)b * T + t0;
  stage_rows<G::kThreads>(s_dt, dt, row * D + d0, len, d0, D);
  stage_rows<G::kThreads>(s_u, u, row * D + d0, len, d0, D);
  stage_states<G::kThreads, S>(s_b, bm, row * S, len);
  if constexpr (kOut) stage_states<G::kThreads, S>(s_c, cm, row * S, len);
  float av[kPer], h[kPer];
  float sdt = 0.f;                                // kOut false: sum_t dt_t
  const size_t me = (size_t)d * S + p * kPer;     // (d, first state) in [D, S]
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    av[i] = live ? a[me + i] : 0.f;
    h[i] = (kOut && live) ? start[((size_t)b * (nc + 1) + k) * D * S + me + i] : 0.f;
  }
  __syncthreads();
#pragma unroll 4
  for (int j = 0; j < len; ++j) {
    const float dtv = s_dt[j * kChan + ch];
    const float x = dtv * s_u[j * kChan + ch];
    float bv[kPer];
    load4(bv, s_b + j * S + p * kPer);
    if constexpr (kOut) {
      float cv[kPer];
      load4(cv, s_c + j * S + p * kPer);
#pragma unroll
      for (int i = 0; i < kPer; ++i) h[i] = expf(dtv * av[i]) * h[i] + x * bv[i];
      const float yv = chain_dot<G::R>(h, cv, lane);
      // The channel's other lanes read s_dt[j][ch] before the shuffle above,
      // which needs their values: the slot is dead, and takes y.
      if (p == 0) s_dt[j * kChan + ch] = yv;
    } else {
      sdt += dtv;
#pragma unroll
      for (int i = 0; i < kPer; ++i) h[i] = expf(dtv * av[i]) * h[i] + x * bv[i];
    }
  }
  if constexpr (kOut) {
    if (k == nc - 1 && live) {
      store4(out1 + ((size_t)b * (nc + 1) + nc) * D * S + me, h);
      store4(out2 + (size_t)b * D * S + me, h);
    }
    __syncthreads();
    for (int i = tid; i < len * kChan; i += G::kThreads) {
      const int j = i / kChan, c = i % kChan;
      if (d0 + c < D) out0[(row + j) * D + d0 + c] = s_dt[i];
    }
  } else if (live) {
    float pr[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) pr[i] = expf(sdt * av[i]);
    const size_t o = ((size_t)b * nc + k) * D * S + me;
    store4(out0 + o, h);
    store4(out1 + o, pr);
  }
}

// Forward, launch 2: a thread a (b, d, s) walks the chunks from h0 to the
// last chunk's start.
__global__ void __launch_bounds__(kCarryThreads)
scan_fwd_carry_kernel(const float* __restrict__ h0, const float* __restrict__ local,
                      const float* __restrict__ decay, float* __restrict__ start, int nc,
                      long long n, long long total) {
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long b = idx / n, e = idx % n;
    float h = h0[idx];
    start[b * (nc + 1) * n + e] = h;
#pragma unroll 8
    for (int k = 0; k + 1 < nc; ++k) {
      const long long o = (b * nc + k) * n + e;
      h = decay[o] * h + local[o];
      start[(b * (nc + 1) + k + 1) * n + e] = h;
    }
  }
}

// Backward, launch 1: the chunk's local carry out from zero and its decay
// product, to local, decay [B, nc, D, S]. Grid (ceil(D / 32), nc, B).
template <int S>
__global__ void __launch_bounds__(Geo<S>::kThreads)
scan_bwd_local_kernel(const float* __restrict__ dt, const float* __restrict__ cm,
                      const float* __restrict__ a, const float* __restrict__ dy,
                      float* __restrict__ local, float* __restrict__ decay, int T, int D) {
  using G = Geo<S>;
  __shared__ float s_dt[kChunk * kChan];
  __shared__ float s_dy[kChunk * kChan];
  __shared__ __align__(16) float s_c[kChunk * S];
  const int tid = threadIdx.x, lane = tid & 31;
  const int p = lane / G::R, ch = (tid >> 5) * G::R + lane % G::R;
  const int d0 = blockIdx.x * kChan, k = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int t0 = k * kChunk, len = min(kChunk, T - t0);
  const int d = d0 + ch;
  const bool live = d < D;
  const size_t row = (size_t)b * T + t0;
  stage_rows<G::kThreads>(s_dt, dt, row * D + d0, len, d0, D);
  stage_rows<G::kThreads>(s_dy, dy, row * D + d0, len, d0, D);
  stage_states<G::kThreads, S>(s_c, cm, row * S, len);
  float av[kPer], r[kPer], lc[kPer];
  const size_t me = (size_t)d * S + p * kPer;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    av[i] = live ? a[me + i] : 0.f;
    r[i] = 1.f;
    lc[i] = 0.f;
  }
  __syncthreads();
#pragma unroll 4
  for (int j = 0; j < len; ++j) {
    const float dtv = s_dt[j * kChan + ch];
    const float dyv = s_dy[j * kChan + ch];
    float cv[kPer];
    load4(cv, s_c + j * S + p * kPer);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      r[i] *= expf(dtv * av[i]);
      lc[i] += r[i] * (dyv * cv[i]);
    }
  }
  if (live) {
    const size_t o = ((size_t)b * nc + k) * D * S + me;
    store4(local + o, lc);
    store4(decay + o, r);
  }
}

// Backward, launch 2: a thread a (b, d, s) walks the chunks in reverse from
// dh_last (null: zero); carry[b, k] is the carry into chunk k from its right.
__global__ void __launch_bounds__(kCarryThreads)
scan_bwd_carry_kernel(const float* __restrict__ dh_last, const float* __restrict__ local,
                      const float* __restrict__ decay, float* __restrict__ carry,
                      float* __restrict__ dh0, int nc, long long n, long long total) {
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long b = idx / n, e = idx % n;
    float g = dh_last != nullptr ? dh_last[idx] : 0.f;
#pragma unroll 8
    for (int k = nc - 1; k >= 0; --k) {
      const long long o = (b * nc + k) * n + e;
      carry[o] = g;
      g = decay[o] * g + local[o];
    }
    dh0[idx] = g;
  }
}

template <int S>
constexpr size_t bwd_smem() {
  return sizeof(float) * (3 * (size_t)kChunk * kChan + 2 * (size_t)kChunk * S +
                          (size_t)kNSub * Geo<S>::kThreads * kPer +
                          (size_t)Geo<S>::P * kSub * 2 * S);
}

// Backward, launch 3. Grid (ceil(D / 32), nc, B). Writes d dt, d u, the
// CTA's partials of d b, d c to part_bc [gridDim.x, B, T, 2S] and the
// lane's of d a to part_a [B, nc, D, S].
template <int S, typename UT>
__global__ void __launch_bounds__(Geo<S>::kThreads, 4)
scan_bwd_chunk_kernel(const float* __restrict__ dt, const UT* __restrict__ u,
                      const float* __restrict__ bm, const float* __restrict__ cm,
                      const float* __restrict__ a, const float* __restrict__ ckpt,
                      const float* __restrict__ dy, const float* __restrict__ carry_in,
                      float* __restrict__ ddt, UT* __restrict__ du,
                      float* __restrict__ part_bc, float* __restrict__ part_a, int Bn,
                      int T, int D) {
  using G = Geo<S>;
  constexpr int NT = G::kThreads;
  extern __shared__ float4 smem4[];
  float* s_dt = reinterpret_cast<float*>(smem4);        // [kChunk][kChan]
  float* s_u = s_dt + kChunk * kChan;                   // u; d u once done
  float* s_dy = s_u + kChunk * kChan;                   // dy; d dt once done
  float* s_b = s_dy + kChunk * kChan;                   // [kChunk][S]
  float* s_c = s_b + kChunk * S;                        // [kChunk][S]
  float* s_sub = s_c + kChunk * S;                      // [kNSub][NT][kPer]
  float* s_red = s_sub + kNSub * NT * kPer;             // [P][kSub][2S]
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int p = lane / G::R, cl = lane % G::R, ch = w * G::R + cl;
  const int d0 = blockIdx.x * kChan, k = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int t0 = k * kChunk, len = min(kChunk, T - t0);
  const int d = d0 + ch;
  const bool live = d < D;
  const size_t row = (size_t)b * T + t0;
  stage_rows<NT>(s_dt, dt, row * D + d0, len, d0, D);
  stage_rows<NT>(s_u, u, row * D + d0, len, d0, D);
  stage_rows<NT>(s_dy, dy, row * D + d0, len, d0, D);
  stage_states<NT, S>(s_b, bm, row * S, len);
  stage_states<NT, S>(s_c, cm, row * S, len);
  float av[kPer], h[kPer], carry[kPer], gacc[kPer];
  const size_t me = (size_t)d * S + p * kPer;
  if (live) {
    load4(h, ckpt + ((size_t)b * (nc + 1) + k) * D * S + me);
    load4(carry, carry_in + ((size_t)b * nc + k) * D * S + me);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    av[i] = live ? a[me + i] : 0.f;
    if (!live) h[i] = carry[i] = 0.f;
    gacc[i] = 0.f;
  }
  __syncthreads();
  // pass 1: the chunk forward from its checkpoint, h kept every kSub steps
#pragma unroll 4
  for (int j = 0; j < len; ++j) {
    if (j % kSub == 0) store4(s_sub + ((j / kSub) * NT + tid) * kPer, h);
    const float dtv = s_dt[j * kChan + ch];
    const float x = dtv * s_u[j * kChan + ch];
    float bv[kPer];
    load4(bv, s_b + j * S + p * kPer);
#pragma unroll
    for (int i = 0; i < kPer; ++i) h[i] = expf(dtv * av[i]) * h[i] + x * bv[i];
  }
  // pass 2: each sub-chunk, last first: its states and decays, then the
  // reverse walk. n is the same for the whole CTA, so every shuffle below
  // has all its lanes.
  for (int q = (len - 1) / kSub; q >= 0; --q) {
    const int j0 = q * kSub, n = min(kSub, len - j0);
    float hh[kSub + 1][kPer], dd[kSub][kPer];   // h_{t-1} at [m], h_t at [m + 1]
    load4(hh[0], s_sub + (q * NT + tid) * kPer);
#pragma unroll
    for (int m = 0; m < kSub; ++m) {
      if (m < n) {
        const float dtv = s_dt[(j0 + m) * kChan + ch];
        const float x = dtv * s_u[(j0 + m) * kChan + ch];
        float bv[kPer];
        load4(bv, s_b + (j0 + m) * S + p * kPer);
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          dd[m][i] = expf(dtv * av[i]);
          hh[m + 1][i] = dd[m][i] * hh[m][i] + x * bv[i];
        }
      }
    }
#pragma unroll
    for (int m = kSub - 1; m >= 0; --m) {
      if (m < n) {
        const int j = j0 + m;
        const float dtv = s_dt[j * kChan + ch];
        const float uv = s_u[j * kChan + ch];
        const float dyv = s_dy[j * kChan + ch];
        const float x = dtv * uv;
        float bv[kPer], cv[kPer], v[2 * kPer];
        load4(bv, s_b + j * S + p * kPer);
        load4(cv, s_c + j * S + p * kPer);
        float gb = 0.f, gh = 0.f;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const float g = dyv * cv[i] + carry[i];
          v[i] = g * x;
          v[kPer + i] = dyv * hh[m + 1][i];
          gb += g * bv[i];
          const float gha = g * hh[m][i] * dd[m][i];
          gh += gha * av[i];
          gacc[i] += gha * dtv;
          carry[i] = dd[m][i] * g;
        }
        gb = channel_sum<G::R>(gb);
        gh = channel_sum<G::R>(gh);
        const float r = warp_transpose_sum<2 * kPer, G::R>(v, lane);
        if (cl < 2 * kPer) {   // value cl of state group p, over the warp's channels
          const int s = cl < kPer ? p * kPer + cl : S + p * kPer + cl - kPer;
          s_red[(w * kSub + m) * 2 * S + s] = r;
        }
        // The channel's lanes read s_u[j][ch] and s_dy[j][ch] before the
        // shuffles above, which need their values: the slots are dead.
        if (p == 0) {
          s_dy[j * kChan + ch] = gh + uv * gb;
          s_u[j * kChan + ch] = dtv * gb;
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < n * 2 * S; e += NT) {
      const int m = e / (2 * S), s = e % (2 * S);
      float acc = 0.f;
#pragma unroll
      for (int ww = 0; ww < G::P; ++ww) acc += s_red[(ww * kSub + m) * 2 * S + s];
      part_bc[(((size_t)blockIdx.x * Bn + b) * T + t0 + j0 + m) * (2 * S) + s] = acc;
    }
    __syncthreads();
  }
  for (int i = tid; i < len * kChan; i += NT) {
    const int j = i / kChan, c = i % kChan;
    if (d0 + c < D) {
      const size_t o = (row + j) * D + d0 + c;
      ddt[o] = s_dy[i];
      put(du + o, s_u[i]);
    }
  }
  if (live) store4(part_a + ((size_t)b * nc + k) * D * S + me, gacc);
}

// Backward, launch 4. d b, d c: the CTAs' partials [nblk, B, T, 2S] added in
// CTA order; d a: the (b, chunk) rows' [rows, D, S] added in row order.
__global__ void __launch_bounds__(kReduceThreads)
scan_bwd_reduce_kernel(const float* __restrict__ part_bc, int nblk, long long n_bc,
                       int S, float* __restrict__ db, float* __restrict__ dc,
                       const float* __restrict__ part_a, int rows, long long n_a,
                       float* __restrict__ da) {
  const long long n = n_bc + n_a;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    if (idx < n_bc) {
      for (int w = 0; w < nblk; ++w) acc += part_bc[(size_t)w * n_bc + idx];
      const long long bt = idx / (2 * S);
      const int j = (int)(idx % (2 * S));
      if (j < S)
        db[bt * S + j] = acc;
      else
        dc[bt * S + j - S] = acc;
    } else {
      const long long k = idx - n_bc;
      for (int r = 0; r < rows; ++r) acc += part_a[(size_t)r * n_a + k];
      da[k] = acc;
    }
  }
}

int grid_for(long long n, int threads) {
  const long long blocks = (n + threads - 1) / threads;
  return (int)(blocks < 65535 ? blocks : 65535);
}

template <int S, typename UT>
int launch_fwd(const void* dt, const void* u, const void* b, const void* c, const void* a,
               const void* h0, void* y, void* h_last, void* ckpt, void* scratch, int B,
               int T, int D, cudaStream_t stream) {
  const int nc = (T + kChunk - 1) / kChunk;
  const dim3 grid((D + kChan - 1) / kChan, nc, B);
  const dim3 grid_local(grid.x, nc > 1 ? nc - 1 : 1, B);   // one launch even at nc = 1
  const long long n = (long long)D * S, total = (long long)B * n;
  float* local = (float*)scratch;
  float* decay = local + (size_t)B * nc * n;
  scan_fwd_chunk_kernel<S, UT, false><<<grid_local, Geo<S>::kThreads, 0, stream>>>(
      (const float*)dt, (const UT*)u, (const float*)b, (const float*)c, (const float*)a,
      nullptr, local, decay, nullptr, T, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_fwd_carry_kernel<<<grid_for(total, kCarryThreads), kCarryThreads, 0, stream>>>(
      (const float*)h0, local, decay, (float*)ckpt, nc, n, total);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_fwd_chunk_kernel<S, UT, true><<<grid, Geo<S>::kThreads, 0, stream>>>(
      (const float*)dt, (const UT*)u, (const float*)b, (const float*)c, (const float*)a,
      (const float*)ckpt, (float*)y, (float*)ckpt, (float*)h_last, T, D);
  return (int)cudaGetLastError();
}

template <int S, typename UT>
int launch_bwd(const void* dt, const void* u, const void* b, const void* c, const void* a,
               const void* ckpt, const void* dy, const void* dh_last, void* ddt, void* du,
               void* db, void* dc, void* da, void* dh0, void* part_bc, void* part_a,
               void* scratch, int B, int T, int D, cudaStream_t stream) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        scan_bwd_chunk_kernel<S, UT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bwd_smem<S>());
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int nc = (T + kChunk - 1) / kChunk;
  const int nblk = (D + kChan - 1) / kChan;
  const dim3 grid(nblk, nc, B);
  const long long n = (long long)D * S, total = (long long)B * n;
  float* local = (float*)scratch;
  float* decay = local + (size_t)B * nc * n;
  float* carry = decay + (size_t)B * nc * n;
  scan_bwd_local_kernel<S><<<grid, Geo<S>::kThreads, 0, stream>>>(
      (const float*)dt, (const float*)c, (const float*)a, (const float*)dy, local, decay, T, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_bwd_carry_kernel<<<grid_for(total, kCarryThreads), kCarryThreads, 0, stream>>>(
      (const float*)dh_last, local, decay, carry, (float*)dh0, nc, n, total);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_bwd_chunk_kernel<S, UT><<<grid, Geo<S>::kThreads, bwd_smem<S>(), stream>>>(
      (const float*)dt, (const UT*)u, (const float*)b, (const float*)c, (const float*)a,
      (const float*)ckpt, (const float*)dy, carry, (float*)ddt, (UT*)du, (float*)part_bc,
      (float*)part_a, B, T, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n_bc = (long long)B * T * 2 * S;
  scan_bwd_reduce_kernel<<<grid_for(n_bc + n, kReduceThreads), kReduceThreads, 0, stream>>>(
      (const float*)part_bc, nblk, n_bc, S, (float*)db, (float*)dc, (const float*)part_a,
      B * nc, n, (float*)da);
  return (int)cudaGetLastError();
}

bool shape_ok(long long B, long long T, long long D) {
  return B >= 1 && B <= 65535 && T >= 1 && D >= 1 && B * T * D < (1LL << 40) &&
         (T + kChunk - 1) / kChunk <= 65535 && D < (1LL << 30);
}

}  // namespace

// The chunk length (steps): the checkpoints' spacing.
extern "C" int selective_scan_chunk() { return kChunk; }

// The forward: y [B, T, D] f32, h_last [B, D, S] f32 and the chunks' start
// states ckpt [B, ceil(T / 64) + 1, D, S] f32 (the last is h_T), the
// backward's checkpoints. Scratch: [2, B, ceil(T / 64), D, S] f32. u_bf16
// selects u's type (0: f32, 1: bf16). Three launches. Returns a cudaError_t.
extern "C" int selective_scan_fwd_launch(const void* dt, const void* u, int u_bf16,
                                         const void* b, const void* c, const void* a,
                                         const void* h0, void* y, void* h_last, void* ckpt,
                                         void* scratch, long long B, long long T, long long D,
                                         int S, void* stream) {
  if (!shape_ok(B, T, D)) return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define FWD(SS, UT) \
  launch_fwd<SS, UT>(dt, u, b, c, a, h0, y, h_last, ckpt, scratch, (int)B, (int)T, (int)D, st)
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
// part_bc [ceil(D / 32), B, T, 2S], part_a [B, ceil(T / 64), D, S] and
// [3, B, ceil(T / 64), D, S], f32. Four launches.
extern "C" int selective_scan_bwd_launch(const void* dt, const void* u, int u_bf16,
                                         const void* b, const void* c, const void* a,
                                         const void* ckpt, const void* dy,
                                         const void* dh_last, void* ddt, void* du, void* db,
                                         void* dc, void* da, void* dh0, void* part_bc,
                                         void* part_a, void* scratch, long long B,
                                         long long T, long long D, int S, void* stream) {
  if (!shape_ok(B, T, D)) return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define BWD(SS, UT)                                                                     \
  launch_bwd<SS, UT>(dt, u, b, c, a, ckpt, dy, dh_last, ddt, du, db, dc, da, dh0, part_bc, \
                     part_a, scratch, (int)B, (int)T, (int)D, st)
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
  return (int)((D + kChan - 1) / kChan);
}
