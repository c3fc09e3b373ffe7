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
// from 0). As in the TPU kernel, masked scores are -1e30, the softmax runs
// online over kv tiles (running max m, sum l, accumulator acc, all f32), and
// the output is acc / max(l, 1e-30) in q's dtype. Both kernels read q, k and
// v through strides, so the model's [B, S, H, d] views need no copy, and mask
// ragged S and T themselves: any S, T >= 1 and any d that is a multiple of 8
// up to 256 run.
//
// Two kernels, chosen by the inputs' dtype (the wrapper calls one of the two
// entry points at the end of this file):
//
// bf16: tensor cores (flash_mma_kernel). One CTA of 4 warps per (64 MT
// query rows, head, batch); each warp owns MT m16 tiles of query rows (MT = 2
// at d = 64, so that every K and V fragment a warp reads with ldmatrix feeds
// two products; MT = 1 at d = 128 and 256, where the registers run out). K
// and V tiles of 64 keys are copied into shared memory with 16-byte
// cp.async.cg (out-of-range rows and the columns past d zero-filled by the
// copy itself) in a ring of three stages: the copies of tiles j + 1 and j + 2
// are in flight while tile j is computed. Rows of the tiles are XOR-swizzled
// in 16-byte chunks (chunk c of row r sits at c ^ (r & 7)), so every
// ldmatrix, and ldmatrix.trans for V, reads eight rows from eight distinct
// bank groups. S = Q K^T and O += P V are mma.sync.m16n8k16 bf16 x bf16
// products accumulating in f32; a bf16 x bf16 product is exact in f32, so S
// is the TPU kernel's "widen to f32, then multiply" up to the order of
// summation. The query tile is copied once and, for d <= 128, kept in
// registers as mma A-fragments for the whole kv loop; at d = 256 (16 x 256
// f32 of O already takes 128 registers a thread) it stays in shared memory
// and is re-read by ldmatrix at each tile. The online softmax runs on the S
// accumulator fragments in registers: a thread holds two rows of each m16
// tile, and the four threads of an mma row agree on its max through quad
// shuffles (__shfl_xor_sync 1, 2); l is summed from the f32 probabilities,
// per thread, and the quad's partial sums are added once at the end. P is
// packed to bf16 in registers and used directly as the A-fragment of the P V
// mma (the accumulator layout of m16n8 is the A layout of m16k16): no round
// trip through shared memory. The k-step and column loops are fully
// unrolled without branches, so the compiler can issue the ldmatrix of the
// next step under the products of this one (a runtime test of d inside them
// kept it from doing so). Causal CTAs stop after the diagonal tile, mask
// only the tiles that reach past a warp's first row (or past key T - 1), and
// a warp skips a tile whose first key is past all its rows. The grid is
// flattened and launched heaviest query tile first, so the long causal rows
// do not finish last. d is templated on 64, 128 and 256 columns of shared
// memory; a smaller d is zero-padded to that width by the copies (the
// padding adds zeros to S and fills output columns that are not stored).
//   The one arithmetic difference from the TPU kernel: P is rounded to bf16
// before the P V product (the TPU kernel keeps P in f32). That is what the
// JAX package's own model does (repro/models/attention.py: softmax(...)
// .astype(v.dtype) before the P.V einsum), and flash_attention_plain does
// the same for bf16 inputs; l is still summed from the unrounded P.
//
// f32: f32 cores (flash_f32_kernel), the first kernel of this port. One CTA of
// 256 threads per (64 query rows, head, batch): the query tile stays in shared
// memory (transposed, f32), kv tiles of 64 keys are staged in shared memory
// (k transposed, v row-major, f32) with plain loads; thread (ty, tx) of the
// 16 x 16 grid computes a 4 x 4 block of scores with fmaf, keeps m and l of
// its 4 rows in registers (agreed through half-warp shuffles), writes its
// probabilities to a shared 64 x 64 tile and accumulates 4 rows x 4 columns
// of every 64 output columns. f32 products keep it at 4e-7 of the plain
// version. Only tests and checks send f32 to the card; the serve path is
// bf16. It is not redesigned.
//
// What bounds it on an H100. At qwen1.5-0.5b prefill (B 8, H = KV = 16,
// S = T = 512, d 64, causal, bf16) a layer's attention is 4.3e9 operations
// (two products of 2 flops over the 131328 visible (query, key) pairs of each
// of the 128 heads, times d), 0.0043 ms at the 989 TFLOP/s of the bf16 tensor
// cores, and moves 33.5 MB of q, k, v and o, 0.010 ms at 3.35 TB/s: bytes
// bound it. At internlm2-1.8b's shapes (B 2, H 16, KV 8, S = T = 1024, d 128,
// causal) it is 8.6e9 operations, 0.0087 ms, against 25.2 MB, 0.0075 ms:
// operations bound it. mma.sync reaches only part of the tensor-core peak
// (wgmma, four warps issuing one 64-row product from shared memory, is the
// only way to all of it); the softmax's exponentials (one MUFU op per score,
// 16 a clock per SM) cost about as much as the products at d = 64. So the
// operations-bound shapes are where the next step, wgmma fed by TMA with a
// producer warp and the softmax of one tile overlapping the products of the
// next, would pay. chip_smoke.py times both shapes beside one
// scaled_dot_product_attention call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64, kBK = 64;  // query rows of a CTA, keys of a kv tile
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// f32 inputs: f32-core kernel
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256, kPad = 4;
constexpr int kLd = kBQ + kPad;  // pitch of the transposed tiles and of P

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

template <int DMAX>
constexpr int f32_smem_floats() {
  return 2 * DMAX * kLd + kBK * (DMAX + kPad) + kBQ * kLd;
}

template <int DMAX>
__global__ void __launch_bounds__(kF32Threads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H, int KV, int S, int Tn,
                 int d, long long qb, long long qh, long long qs, long long kb, long long kh,
                 long long kt, long long vb, long long vh, long long vt, long long ob,
                 long long oh, long long os, float scale, int causal) {
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
  const float* qp = q + b * qb + h * qh;
  const float* kp = k + b * kb + kvh * kh;
  const float* vp = v + b * vb + kvh * vh;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  // the query tile, transposed; rows past S and columns past d are zero
  for (int idx = tid; idx < kBQ * kChunks; idx += kF32Threads) {
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
    for (int idx = tid; idx < kBK * kChunks; idx += kF32Threads) {
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
    float* op = o + b * ob + h * oh + (long long)row * os;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = c * 64 + tx * 4;
      if (col < d)
        store4(op + col, acc[i][c * 4] / lc, acc[i][c * 4 + 1] / lc, acc[i][c * 4 + 2] / lc,
               acc[i][c * 4 + 3] / lc);
    }
  }
}

template <int DMAX>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                       int S, int Tn, int d, const long long* st, float scale, int causal,
                       cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * f32_smem_floats<DMAX>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_f32_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_f32_kernel<DMAX><<<grid, kF32Threads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, KV, S, Tn, d, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], scale, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 inputs: tensor-core kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4, kMmaThreads = 32 * kWarps, kStages = 3;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// element offset of 16-byte chunk `c` of row `r` in a swizzled [64][DMAX] tile
template <int DMAX>
__device__ __forceinline__ int swz(int r, int c) {
  return r * DMAX + ((c ^ (r & 7)) << 3);
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool valid) {
  // src-size 0 copies nothing and fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate (registers
// only: not volatile, so the compiler may schedule it between the loads)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU (ex2.approx, 2 ulp; a large negative x, a masked score, gives 0)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const unsigned*>(&v);
}

// rows r0 .. r0 + ROWS - 1 of a [n_rows, d] matrix (row stride `stride`)
// into a swizzled tile; rows past n_rows and columns past d are zero
template <int DMAX, int ROWS>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src, long long stride, int r0,
                                          int n_rows, int d) {
  constexpr int kChunks = DMAX / 8;
  static_assert(ROWS * kChunks % kMmaThreads == 0, "tile copy splits evenly");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / kMmaThreads; ++it) {
    const int i = threadIdx.x + it * kMmaThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r0 + r < n_rows && c * 8 < d;
    const bf16* g = ok ? src + (long long)(r0 + r) * stride + c * 8 : src;
    cp_async16(smem_u32(dst + swz<DMAX>(r, c)), g, ok);
  }
}

// Per head dim: MT m16 tiles of query rows per warp (a K or V fragment read by
// ldmatrix feeds MT products) and whether Q stays in registers.
template <int DMAX> struct MmaCfg {
  static constexpr int MT = DMAX <= 64 ? 2 : 1;
  static constexpr bool kQInRegs = DMAX <= 128;
  static constexpr int kRows = 16 * MT * kWarps;  // query rows of a CTA
};

template <int DMAX>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int B, int H, int KV, int S,
                 int Tn, int d, long long qb, long long qh, long long qs, long long kb,
                 long long kh, long long kt, long long vb, long long vh, long long vt,
                 long long ob, long long oh, long long os, float scale_log2, int causal) {
  constexpr int MT = MmaCfg<DMAX>::MT, kRows = MmaCfg<DMAX>::kRows;
  constexpr bool kQInRegs = MmaCfg<DMAX>::kQInRegs;
  constexpr int kTile = kBK * DMAX;   // a K or V tile
  constexpr int kKSteps = DMAX / 16;  // k-steps of S = Q K^T; also 16-column groups of O
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [kRows][DMAX]
  bf16* sK = sQ + kRows * DMAX;                   // [kStages][kTile]
  bf16* sV = sK + kStages * kTile;                // [kStages][kTile]

  // heaviest first: the flattened grid hands out the last query tile of
  // every (head, batch) before any earlier one
  const int heads = H * B;
  const int n_qt = (S + kRows - 1) / kRows;
  const int qt = n_qt - 1 - (int)(blockIdx.x / heads);
  const int hb = (int)(blockIdx.x % heads);
  const int h = hb % H, b = hb / H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kRows;
  const bf16* qp = q + b * qb + h * qh;
  const bf16* kp = k + b * kb + kvh * kh;
  const bf16* vp = v + b * vb + kvh * vh;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix: which 8x8 matrix, which of its rows
  const int w0 = warp * 16 * MT;           // this warp's first row in the tile
  const int n_tiles = ((causal ? min(Tn, q0 + kRows) : Tn) + kBK - 1) / kBK;

  // the ring: tiles j + 1 and j + 2 are in flight while tile j is computed
  // (a group is committed for every tile, empty past the last one)
  copy_tile<DMAX, kRows>(sQ, qp, qs, q0, S, d);
  copy_tile<DMAX, kBK>(sK, kp, kt, 0, Tn, d);
  copy_tile<DMAX, kBK>(sV, vp, vt, 0, Tn, d);
  cp_commit();
  if (n_tiles > 1) {
    copy_tile<DMAX, kBK>(sK + kTile, kp, kt, kBK, Tn, d);
    copy_tile<DMAX, kBK>(sV + kTile, vp, vt, kBK, Tn, d);
  }
  cp_commit();

  unsigned qf[kQInRegs ? MT : 1][kQInRegs ? kKSteps : 1][4];
  float oacc[MT][2 * kKSteps][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int t = 0; t < MT; ++t) {
#pragma unroll
    for (int n = 0; n < 2 * kKSteps; ++n)
      oacc[t][n][0] = oacc[t][n][1] = oacc[t][n][2] = oacc[t][n][3] = 0.f;
    m[t][0] = m[t][1] = kNegInf;
    l[t][0] = l[t][1] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    if (j + 2 < n_tiles) {
      const int nx = (j + 2) % kStages;
      copy_tile<DMAX, kBK>(sK + nx * kTile, kp, kt, (j + 2) * kBK, Tn, d);
      copy_tile<DMAX, kBK>(sV + nx * kTile, vp, vt, (j + 2) * kBK, Tn, d);
    }
    cp_commit();
    cp_wait<2>();  // tile j has landed
    __syncthreads();
    const bf16* tK = sK + st * kTile;
    const bf16* tV = sV + st * kTile;
    const int k0 = j * kBK;
    if constexpr (kQInRegs) {
      if (j == 0) {
#pragma unroll
        for (int t = 0; t < MT; ++t)
#pragma unroll
          for (int kk = 0; kk < kKSteps; ++kk)
            ldsm_x4(smem_u32(sQ + swz<DMAX>(w0 + 16 * t + mr + (mi & 1) * 8, 2 * kk + (mi >> 1))),
                    qf[t][kk]);
      }
    }
    // causal: a tile whose first key is past all of this warp's rows adds nothing to them
    if (!(causal && k0 > q0 + w0 + 16 * MT - 1)) {
      // S = Q K^T: this warp's 16 MT rows x 64 keys, eight n-tiles of 8 keys
      float s[MT][8][4];
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int n = 0; n < 8; ++n) s[t][n][0] = s[t][n][1] = s[t][n][2] = s[t][n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        unsigned a[MT][4];
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          if constexpr (kQInRegs) {
            a[t][0] = qf[t][kk][0]; a[t][1] = qf[t][kk][1];
            a[t][2] = qf[t][kk][2]; a[t][3] = qf[t][kk][3];
          } else {
            ldsm_x4(smem_u32(sQ + swz<DMAX>(w0 + 16 * t + mr + (mi & 1) * 8, 2 * kk + (mi >> 1))),
                    a[t]);
          }
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {  // keys 16np .. 16np + 15
          unsigned bk[4];
          ldsm_x4(smem_u32(tK + swz<DMAX>(16 * np + mr + (mi >> 1) * 8, 2 * kk + (mi & 1))), bk);
#pragma unroll
          for (int t = 0; t < MT; ++t) {
            mma_bf16(s[t][2 * np], a[t], bk[0], bk[1]);
            mma_bf16(s[t][2 * np + 1], a[t], bk[2], bk[3]);
          }
        }
      }

      // online softmax on the fragments: s[t][n][0..1] are row r_t, s[t][n][2..3]
      // row r_t + 8 (r_t = q0 + w0 + 16t + lane / 4), keys k0 + 8n + 2 (lane % 4)
      // + {0, 1}; scores in log2 units
      const bool masked = k0 + kBK > Tn || (causal && k0 + kBK - 1 > q0 + w0);
      unsigned pa[MT][4][4];  // P as bf16 A-fragments, per 16-key step
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        const int row_lo = q0 + w0 + 16 * t + lane / 4;
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[t][n][e] *= scale_log2;
        if (masked) {
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + 8 * n + 2 * (lane % 4) + (e & 1);
              const int row = row_lo + (e >> 1) * 8;
              if (key >= Tn || (causal && key > row)) s[t][n][e] = kNegInf;
            }
        }
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[t][n][e]);
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          const float m_new = fmaxf(m[t][i], mx[i]);
          alpha[i] = exp2_fast(m[t][i] - m_new);
          m[t][i] = m_new;
          l[t][i] *= alpha[i];
        }
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[t][n][e] = exp2_fast(s[t][n][e] - m[t][e >> 1]);  // masked: exactly 0
            l[t][e >> 1] += s[t][n][e];
          }
        }
#pragma unroll
        for (int n = 0; n < 2 * kKSteps; ++n) {
          oacc[t][n][0] *= alpha[0]; oacc[t][n][1] *= alpha[0];
          oacc[t][n][2] *= alpha[1]; oacc[t][n][3] *= alpha[1];
        }
        // P in bf16, straight from the score fragments
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          pa[t][ks][0] = pack_bf16(s[t][2 * ks][0], s[t][2 * ks][1]);
          pa[t][ks][1] = pack_bf16(s[t][2 * ks][2], s[t][2 * ks][3]);
          pa[t][ks][2] = pack_bf16(s[t][2 * ks + 1][0], s[t][2 * ks + 1][1]);
          pa[t][ks][3] = pack_bf16(s[t][2 * ks + 1][2], s[t][2 * ks + 1][3]);
        }
      }

      // O += P V
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {  // keys 16ks .. 16ks + 15
#pragma unroll
        for (int nd = 0; nd < kKSteps; ++nd) {  // output columns 16nd .. 16nd + 15
          unsigned bv[4];
          ldsm_x4_trans(
              smem_u32(tV + swz<DMAX>(16 * ks + mr + (mi & 1) * 8, 2 * nd + (mi >> 1))), bv);
#pragma unroll
          for (int t = 0; t < MT; ++t) {
            mma_bf16(oacc[t][2 * nd], pa[t][ks], bv[0], bv[1]);
            mma_bf16(oacc[t][2 * nd + 1], pa[t][ks], bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // normalise, stage this warp's rows in its own rows of sQ (no other warp
  // reads them), then write them with 16-byte stores
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[t][i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      inv[i] = 1.f / fmaxf(li, 1e-30f);
    }
    const int r_lo = w0 + 16 * t + lane / 4;
#pragma unroll
    for (int n = 0; n < 2 * kKSteps; ++n) {
      const int off = 2 * (lane % 4);
      *reinterpret_cast<unsigned*>(sQ + swz<DMAX>(r_lo, n) + off) =
          pack_bf16(oacc[t][n][0] * inv[0], oacc[t][n][1] * inv[0]);
      *reinterpret_cast<unsigned*>(sQ + swz<DMAX>(r_lo + 8, n) + off) =
          pack_bf16(oacc[t][n][2] * inv[1], oacc[t][n][3] * inv[1]);
    }
  }
  __syncwarp();
  constexpr int kChunks = DMAX / 8;
  bf16* op = o + b * ob + h * oh;
#pragma unroll
  for (int it = 0; it < 16 * MT * kChunks / 32; ++it) {
    const int i = lane + it * 32;
    const int r = w0 + i / kChunks, c = i % kChunks;
    if (q0 + r < S && c * 8 < d)
      *reinterpret_cast<uint4*>(op + (long long)(q0 + r) * os + c * 8) =
          *reinterpret_cast<const uint4*>(sQ + swz<DMAX>(r, c));
  }
}

template <int DMAX>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                       int S, int Tn, int d, const long long* st, float scale, int causal,
                       cudaStream_t stream) {
  constexpr int rows = MmaCfg<DMAX>::kRows;
  constexpr int bytes = (rows + 2 * kStages * kBK) * DMAX * (int)sizeof(bf16);  // Q, (K, V) x stages
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long ctas = (long long)((S + rows - 1) / rows) * H * B;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_mma_kernel<DMAX><<<(unsigned)ctas, kMmaThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), B, H, KV, S, Tn, d, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], scale * 1.4426950408889634f, causal);
  return cudaGetLastError();
}

bool bad_shape(long long B, long long H, long long KV, long long S, long long T, long long d) {
  return B < 1 || B > 65535 || H < 1 || H > 65535 || KV < 1 || H % KV != 0 || S < 1 || T < 1 ||
         S > (1LL << 30) || T > (1LL << 30) || d < 8 || d > 256 || d % 8 != 0;
}

}  // namespace

// q [B, H, S, d], k and v [B, KV, T, d], o [B, H, S, d], each with unit stride
// in d and the element strides `strides` = (q: b, h, s; k: b, h, t; v: b, h,
// t; o: b, h, s), all multiples of 8, and 16-byte aligned data.
// Launches on `stream`; returns the cudaError_t of the launch.

// f32 inputs: the f32-core kernel.
extern "C" int flash_attention_f32_launch(const void* q, const void* k, const void* v, void* o,
                                          long long B, long long H, long long KV, long long S,
                                          long long T, long long d, const long long* strides,
                                          int causal, float scale, void* stream) {
  if (bad_shape(B, H, KV, S, T, d)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int b = (int)B, h = (int)H, kv = (int)KV, s = (int)S, t = (int)T, dd = (int)d;
  if (d <= 64) return launch_f32<64>(q, k, v, o, b, h, kv, s, t, dd, strides, scale, causal, st);
  if (d <= 128) return launch_f32<128>(q, k, v, o, b, h, kv, s, t, dd, strides, scale, causal, st);
  return launch_f32<256>(q, k, v, o, b, h, kv, s, t, dd, strides, scale, causal, st);
}

// bf16 inputs: the tensor-core kernel.
extern "C" int flash_attention_bf16_launch(const void* q, const void* k, const void* v, void* o,
                                           long long B, long long H, long long KV, long long S,
                                           long long T, long long d, const long long* strides,
                                           int causal, float scale, void* stream) {
  if (bad_shape(B, H, KV, S, T, d)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int b = (int)B, h = (int)H, kv = (int)KV, s = (int)S, t = (int)T, dd = (int)d;
  if (d <= 64) return launch_mma<64>(q, k, v, o, b, h, kv, s, t, dd, strides, scale, causal, st);
  if (d <= 128) return launch_mma<128>(q, k, v, o, b, h, kv, s, t, dd, strides, scale, causal, st);
  return launch_mma<256>(q, k, v, o, b, h, kv, s, t, dd, strides, scale, causal, st);
}
