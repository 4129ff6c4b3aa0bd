// Stabilized causal mLSTM sequence mix (xLSTM's matrix memory, parallel
// form): the backward, two routes.
//
// Replaces no Pallas kernel: the reference differentiates its jnp mLSTM
// with jax.grad (src/repro/models/ssm.py:mlstm_forward), and its Pallas
// kernel src/repro/kernels/mlstm_attention/kernel.py:26 _mlstm_kernel has
// no backward.  This is the gradient of mlstm_attention_ref (and of the
// forward kernels in mlstm_attention.cu).  Plain version:
// ops.mlstm_attention_backward_torch.  q, k, v and the output gradient dh
// are (B, S, H, hd) in the model's layout, bf16 or float32, k already
// scaled by hd^-0.5; F (inclusive cumulative log-forget) and I (log input
// gate) are (B, S, H) float32.  Outputs dq, dk, dv in q's dtype, dF and dI
// float32.  With D_ts = (F_t - F_s) + I_s for s <= t, m_t = max_s D_ts,
// W_ts = exp(D_ts - m_t), S_ts = (q_t . k_s) W_ts, n_t = sum_s S_ts,
// den_t = max(|n_t|, exp(-m_t)) and e_ts = dh_t . v_s:
//
//   r_t   = sum_s S_ts e_ts                  (= den_t (dh_t . h_t))
//   dn_t  = -sign(n_t) (r_t / den_t) / den_t where |n_t| > exp(-m_t), else 0
//   dS_ts = e_ts / den_t + dn_t
//   dq_t  = sum_s dS_ts W_ts k_s
//   dk_s  = sum_t dS_ts W_ts q_t,   dv_s = sum_t (S_ts / den_t) dh_t
//   dF_t  = sum_s dS_ts S_ts - sum_t' dS_t't S_t't,   dI_s = sum_t dS_ts S_ts
//
// m_t is held constant: h_t does not depend on it (its factor exp(-m_t)
// cancels in either branch of den), so its exact gradient is 0.  Scores,
// sums and weights are float32, the outputs rounded once.
//
// What bounds it on Hopper: operations.  Five products of hd multiply-adds
// over the S (S + 1) / 2 causal pairs of each (b, h) are the least the
// function needs (q k^T, dh v^T, dq, dk, dv): at xlstm-125m's training
// shape (B 4, H 4, S 2048, hd 384, bf16), 1.29e11 flops (two a
// multiply-add), 0.1303 ms at the tensor cores' 989 TFLOP/s.
//
// Route "wgmma" (bf16 at hd 128, 256 and 384;
// mlstm_attention_backward_wgmma_bf16): the tensor cores, fed by TMA, as
// the forward's route of that name (mlstm_attention.cu), in four kernels
// of one shape, each a block of three warpgroups per ((b, h), a 64-row
// tile of its own side):
//   * stats, over query tiles (q and dh fixed, k and v streamed up to the
//     diagonal): the exact stabilizer m_t from F and I in a prologue (the
//     forward's), S = q k^T and e = dh v^T, and from them n_t and r_t in
//     float32; writes m_t, den_t, dn_t (a (B, S, H) scratch each) and dF's
//     row sums.  Two (64, hd) accumulators, (e W) k and W k, would not fit
//     two consumer warpgroups' registers at hd 384: so the stats come
//     first and the passes after them accumulate one product each.
//   * dq, over query tiles (the same tiles): S and e again, G = (e / den +
//     dn) W, dq += G k;
//   * dk, over key tiles (k and v fixed, q and dh streamed from the
//     diagonal): S^T = k q^T, e^T = v dh^T, G^T, dk += G^T q; and dI and
//     dF's column sums;
//   * dv, over key tiles: S^T, P^T = S^T / den, dv += P^T dh.
//   W is computed from the stats' m_t in every pass by one expression, so
//   it has the same bits in all four.  A producer warpgroup (24
//   registers) issues every TMA load: the fixed tiles once, then one
//   stage each of the two streamed tiles on full / empty mbarrier pairs,
//   the one the consumers release first loaded first.  Two consumer
//   warpgroups (240 registers): consumer c computes the products for
//   streamed rows [32 c, 32 c + 32) of each tile (wgmma m64n32k16 over hd
//   / 16 steps from 128-byte-swizzled shared memory), puts its half of G
//   (or P) as one bf16 term into the 64 x 64 operand tile, and, after a
//   named barrier of the two, accumulates output columns [c hd / 2, (c +
//   1) hd / 2) as wgmma m64n(hd/2)k16 with B MN-major (the transpose bit).
//   (Consumer 0 computing S and consumer 1 e as whole m64n64 tiles, so
//   that no operand is read twice, and exchanging their halves through
//   shared memory ran 30% slower on every pass on an H100 80GB HBM3 at
//   700 W.)
//   G and P in one bf16 term: dq, dk and dv are rounded to bf16 themselves,
//   and the error of one term (2^-9 of each element, in sums of random
//   sign) stays far inside the card tolerance of 1e-2 of each gradient's
//   largest magnitude (tests/test_torch_ssm_train.py's CPU emulation of
//   the route holds it).  Ten products of the causal tile pairs (stats 2,
//   dq 3, dk 3, dv 2) against the function's five put this route's floor
//   at 2x the bound.
//   * Shared memory at hd 384: four 64 x 384 bf16 tiles (48 KB each) and
//     the 8 KB operand, 200 KB (one block an SM).  Rows past S come back
//     from TMA as zeros from within the same (b, h); W is 0 above the
//     diagonal and past S.  Every output element is owned by one block and
//     every sum runs in a fixed order: no atomics, two runs give bitwise
//     the same result.
//   * Ablation build only (python -m repro_torch.kernels.ablation stages
//     --only mlstm_bwd): -DMLSTM_BWD_CUT=1 keeps the score products and
//     drops the weighting, the operand and the accumulated products
//     (outputs wrong); on the simt route it drops the accumulated
//     products.
//
// Route "simt" (float32 at every head dim, and bf16 at hd 16, 32 and 64;
// mlstm_attention_backward_simt_bf16 / _f32): float32 FMA on the CUDA
// cores, at best the 67 TFLOP/s float32 rate (a float32 product on the
// tensor cores would be TF32, another function).
//   * Pass A, one block of 256 threads (16 x 16) per ((b, h), 32 query
//     rows): a prologue takes each row's exact m_t from F and I (8 threads
//     a row, the plain version's order of operations); then over the key
//     tiles of 32 up to the diagonal it computes the (32, 32) tiles q k^T
//     and dh v^T (a 2 x 2 block a thread; the 16 threads of a row are 16
//     lanes of a warp, so row sums are shuffles), W, n_t and r_t, puts e W
//     and W in shared memory, and accumulates (e W) k and W k, (32, hd)
//     each in registers (2 rows x hd/16 columns a thread).  At the end it
//     writes dq, the row sum of dD_ts into dF, and m_t, den_t and dn_t to a
//     scratch (B, S, H) each.
//   * Pass B, one block per ((b, h), 32 key rows): its k and v rows stay in
//     shared memory; over the query tiles from the diagonal to S it
//     recomputes k q^T and v dh^T, W (from pass A's m_t: the same bits),
//     S and dS (pass A's den_t, dn_t), accumulates (dS W) q and (S / den)
//     dh into dk, dv in registers, and the column sum of dD_ts; at the end
//     dI_s = the column sum and dF_s -= it.
//   * Each output element is owned by one block, and every sum runs in a
//     fixed order: no atomics, so two runs give bitwise the same result.
//   * Shared memory at hd 384: four tiles of 32 x 388 floats and two 32 x
//     36 weight tiles, 208 KB (one block an SM).  Rows past S load as 0
//     and W is 0 there and above the diagonal.  Each FMA reads about one
//     float from shared memory: the route is bound by shared memory, not
//     by the FMA rate.
//
// The wrapper (kernel.py: route, the forward's rule) picks the route from
// dtype and hd
// before the launch; both count as launches of mlstm_attention_backward.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

#ifndef MLSTM_BWD_CUT
#define MLSTM_BWD_CUT 0  // ablation build: 1 = the products alone
#endif

namespace simt {

constexpr int kB = 32;          // rows a block owns (queries in A, keys in B)
constexpr int kT = 32;          // rows of the other side per step
constexpr int kThreads = 256;   // 16 x 16
constexpr int kPLD = kT + 4;    // row stride of the weight tiles
constexpr float kFloor = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HD> __host__ __device__ constexpr int tile_ld() {
  return HD + 4;
}
template <int HD> constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(4 * kB * tile_ld<HD>() + 2 * kB * kPLD + 4 * kT);
}

// sum over the 16 lanes of a half warp (one row of a tile)
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// a 32-row tile of a (B, S, H, HD) tensor at rows [r0, r0 + 32) into
// shared memory as float32, rows past S as zeros
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          size_t base, size_t row, int r0,
                                          int S) {
  constexpr int LD = tile_ld<HD>();
  for (int i = threadIdx.x; i < kB * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    dst[r * LD + d] =
        r0 + r < S ? to_f(src[base + (size_t)(r0 + r) * row + d]) : 0.f;
  }
}

// s[i][j] = a_(ty*2+i) . b_(tx+16j) and e[i][j] = c_(ty*2+i) . d_(tx+16j)
// over HD, from four shared-memory tiles
template <int HD>
__device__ __forceinline__ void two_products(const float* a, const float* b,
                                             const float* c, const float* e4,
                                             float (&s)[2][2],
                                             float (&e)[2][2]) {
  constexpr int LD = tile_ld<HD>();
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) s[i][j] = e[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 ra[2], rb[2], rc[2], rd[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ra[i] = *reinterpret_cast<const float4*>(&a[(ty * 2 + i) * LD + d]);
      rc[i] = *reinterpret_cast<const float4*>(&c[(ty * 2 + i) * LD + d]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      rb[j] = *reinterpret_cast<const float4*>(&b[(tx + 16 * j) * LD + d]);
      rd[j] = *reinterpret_cast<const float4*>(&e4[(tx + 16 * j) * LD + d]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float t = s[i][j], u = e[i][j];
        t = fmaf(ra[i].x, rb[j].x, t);
        t = fmaf(ra[i].y, rb[j].y, t);
        t = fmaf(ra[i].z, rb[j].z, t);
        t = fmaf(ra[i].w, rb[j].w, t);
        u = fmaf(rc[i].x, rd[j].x, u);
        u = fmaf(rc[i].y, rd[j].y, u);
        u = fmaf(rc[i].z, rd[j].z, u);
        u = fmaf(rc[i].w, rd[j].w, u);
        s[i][j] = t;
        e[i][j] = u;
      }
  }
}

// acc1[i][n] += sum_j p1[row][j] x1[j][col], acc2 likewise with p2 and x2,
// row = ty*2+i, col = tx+16n, over the first kn (a multiple of 4 is read;
// the weights past kn are 0) of the kT columns of the weight tiles
template <int HD>
__device__ __forceinline__ void accumulate(const float* p1, const float* x1,
                                           const float* p2, const float* x2,
                                           int kn, float (&acc1)[2][HD / 16],
                                           float (&acc2)[2][HD / 16]) {
  constexpr int LD = tile_ld<HD>();
  constexpr int NC = HD / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int j = 0; j < kn; j += 4) {
    float4 w1[2], w2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      w1[i] = *reinterpret_cast<const float4*>(&p1[(ty * 2 + i) * kPLD + j]);
      w2[i] = *reinterpret_cast<const float4*>(&p2[(ty * 2 + i) * kPLD + j]);
    }
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int d = tx + 16 * n;
      const float a0 = x1[(j + 0) * LD + d], a1 = x1[(j + 1) * LD + d];
      const float a2 = x1[(j + 2) * LD + d], a3 = x1[(j + 3) * LD + d];
      const float b0 = x2[(j + 0) * LD + d], b1 = x2[(j + 1) * LD + d];
      const float b2 = x2[(j + 2) * LD + d], b3 = x2[(j + 3) * LD + d];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float t = acc1[i][n], u = acc2[i][n];
        t = fmaf(w1[i].x, a0, t);
        t = fmaf(w1[i].y, a1, t);
        t = fmaf(w1[i].z, a2, t);
        t = fmaf(w1[i].w, a3, t);
        u = fmaf(w2[i].x, b0, u);
        u = fmaf(w2[i].y, b1, u);
        u = fmaf(w2[i].z, b2, u);
        u = fmaf(w2[i].w, b3, u);
        acc1[i][n] = t;
        acc2[i][n] = u;
      }
    }
  }
}

// pass A: one block per ((b, h), kB query rows)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
mlstm_bwd_rows(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ Fc,
               const float* __restrict__ Ig, const T* __restrict__ dh,
               T* __restrict__ dq, float* __restrict__ dF,
               float* __restrict__ Mrow, float* __restrict__ Den,
               float* __restrict__ Dn, int S, int H) {
  constexpr int LD = tile_ld<HD>();
  constexpr int NC = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;              // kB x LD
  float* hs = qs + kB * LD;      // kB x LD: dh rows
  float* ks = hs + kB * LD;      // kT x LD
  float* vs = ks + kB * LD;      // kT x LD
  float* p1 = vs + kB * LD;      // kB x kPLD: e W
  float* p2 = p1 + kB * kPLD;    // kB x kPLD: W
  float* fk = p2 + kB * kPLD;    // kT
  float* ik = fk + kT;           // kT
  float* ms = ik + kT;           // kB: m of the block's rows

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kB;  // longest tiles first
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const size_t row = (size_t)H * HD;
  const size_t base = (size_t)b * S * row + (size_t)h * HD;
  const size_t gbase = (size_t)b * S * H + h;

  load_tile<T, HD>(qs, q, base, row, q0, S);
  load_tile<T, HD>(hs, dh, base, row, q0, S);
  {  // the exact stabilizer of each row: 8 threads a row
    const int r = tid >> 3, sub = tid & 7, t = q0 + r;
    float mx = -INFINITY;
    if (t < S) {
      const float ft = Fc[gbase + (size_t)t * H];
      for (int s = sub; s <= t; s += 8) {
        const size_t off = gbase + (size_t)s * H;
        mx = fmaxf(mx, (ft - Fc[off]) + Ig[off]);
      }
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (sub == 0) ms[r] = fmaxf(mx, kFloor);
  }
  __syncthreads();
  float fq[2], m[2], npart[2], rpart[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + ty * 2 + i;
    fq[i] = t < S ? Fc[gbase + (size_t)t * H] : 0.f;
    m[i] = ms[ty * 2 + i];
    npart[i] = rpart[i] = 0.f;
  }
  float acc[2][NC], u[2][NC];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = u[i][n] = 0.f;

  const int kv_end = min(q0 + kB, S);
  for (int k0 = 0; k0 < kv_end; k0 += kT) {
    __syncthreads();  // the previous step is done with ks, vs, p1, p2
    load_tile<T, HD>(ks, k, base, row, k0, S);
    load_tile<T, HD>(vs, v, base, row, k0, S);
    if (tid < kT) {
      const bool in = k0 + tid < S;
      const size_t off = gbase + (size_t)(k0 + tid) * H;
      fk[tid] = in ? Fc[off] : 0.f;
      ik[tid] = in ? Ig[off] : 0.f;
    }
    __syncthreads();
    float s[2][2], e[2][2];
    two_products<HD>(qs, ks, hs, vs, s, e);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = q0 + ty * 2 + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tx + 16 * j, kp = k0 + c;
        const bool live = t < S && kp <= t;
        const float W =
            live ? expf(((fq[i] - fk[c]) + ik[c]) - m[i]) : 0.f;
        const float Sv = s[i][j] * W;
        npart[i] += Sv;
        rpart[i] += Sv * e[i][j];
        p1[(ty * 2 + i) * kPLD + c] = e[i][j] * W;
        p2[(ty * 2 + i) * kPLD + c] = W;
      }
    }
    __syncthreads();
    if (MLSTM_BWD_CUT != 1)
      accumulate<HD>(p1, ks, p2, ks, min(kT, kv_end - k0), acc, u);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + ty * 2 + i;
    const float n = row_sum(npart[i]), r = row_sum(rpart[i]);
    if (t >= S) continue;
    const float floor = expf(-m[i]);
    const float den = fmaxf(fabsf(n), floor);
    const float dhh = r / den;
    const float dn = fabsf(n) > floor ? (-copysignf(1.f, n) * dhh) / den : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dq[base + (size_t)t * row + tx + 16 * c] =
          from_f<T>(acc[i][c] / den + dn * u[i][c]);
    if (tx == 0) {
      const size_t off = gbase + (size_t)t * H;
      dF[off] = dhh + dn * n;
      Mrow[off] = m[i];
      Den[off] = den;
      Dn[off] = dn;
    }
  }
}

// pass B: one block per ((b, h), kB key rows)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
mlstm_bwd_cols(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ Fc,
               const float* __restrict__ Ig, const T* __restrict__ dh,
               const float* __restrict__ Mrow, const float* __restrict__ Den,
               const float* __restrict__ Dn, T* __restrict__ dk,
               T* __restrict__ dv, float* __restrict__ dF,
               float* __restrict__ dI, int S, int H) {
  constexpr int LD = tile_ld<HD>();
  constexpr int NC = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;              // kB x LD: the block's k rows
  float* vs = ks + kB * LD;      // kB x LD: its v rows
  float* qs = vs + kB * LD;      // kT x LD
  float* hs = qs + kB * LD;      // kT x LD: dh rows
  float* p1 = hs + kB * LD;      // kB x kPLD: dS W
  float* p2 = p1 + kB * kPLD;    // kB x kPLD: S / den
  float* fq = p2 + kB * kPLD;    // kT
  float* mq = fq + kT;           // kT
  float* dq_den = mq + kT;       // kT
  float* dq_dn = dq_den + kT;    // kT

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int s0 = blockIdx.y * kB;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const size_t row = (size_t)H * HD;
  const size_t base = (size_t)b * S * row + (size_t)h * HD;
  const size_t gbase = (size_t)b * S * H + h;

  load_tile<T, HD>(ks, k, base, row, s0, S);
  load_tile<T, HD>(vs, v, base, row, s0, S);
  float fk[2], ik[2], cpart[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = s0 + ty * 2 + i;
    fk[i] = s < S ? Fc[gbase + (size_t)s * H] : 0.f;
    ik[i] = s < S ? Ig[gbase + (size_t)s * H] : 0.f;
    cpart[i] = 0.f;
  }
  float gk[2][NC], gv[2][NC];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) gk[i][n] = gv[i][n] = 0.f;

  for (int t0 = s0; t0 < S; t0 += kT) {
    __syncthreads();  // the previous step is done with qs, hs, p1, p2
    load_tile<T, HD>(qs, q, base, row, t0, S);
    load_tile<T, HD>(hs, dh, base, row, t0, S);
    if (tid < kT) {
      const bool in = t0 + tid < S;
      const size_t off = gbase + (size_t)(t0 + tid) * H;
      fq[tid] = in ? Fc[off] : 0.f;
      mq[tid] = in ? Mrow[off] : 0.f;
      dq_den[tid] = in ? Den[off] : 1.f;
      dq_dn[tid] = in ? Dn[off] : 0.f;
    }
    __syncthreads();
    float s[2][2], e[2][2];
    two_products<HD>(ks, qs, vs, hs, s, e);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int sk = s0 + ty * 2 + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tx + 16 * j, t = t0 + c;
        const bool live = t < S && sk <= t;
        const float W = live ? expf(((fq[c] - fk[i]) + ik[i]) - mq[c]) : 0.f;
        const float Sv = s[i][j] * W;
        const float dS = e[i][j] / dq_den[c] + dq_dn[c];
        cpart[i] += dS * Sv;
        p1[(ty * 2 + i) * kPLD + c] = dS * W;
        p2[(ty * 2 + i) * kPLD + c] = Sv / dq_den[c];
      }
    }
    __syncthreads();
    if (MLSTM_BWD_CUT != 1)
      accumulate<HD>(p1, qs, p2, hs, min(kT, S - t0), gk, gv);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = s0 + ty * 2 + i;
    const float col = row_sum(cpart[i]);
    if (s >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const size_t off = base + (size_t)s * row + tx + 16 * c;
      dk[off] = from_f<T>(gk[i][c]);
      dv[off] = from_f<T>(gv[i][c]);
    }
    if (tx == 0) {
      const size_t off = gbase + (size_t)s * H;
      dI[off] = col;
      dF[off] = dF[off] - col;
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* F,
           const void* I, const void* dh, void* dq, void* dk, void* dv,
           void* dF, void* dI, void* M, void* Den, void* Dn, int B, int S,
           int H, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_bwd_rows<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(mlstm_bwd_cols<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + kB - 1) / kB);
  mlstm_bwd_rows<T, HD><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)F,
      (const float*)I, (const T*)dh, (T*)dq, (float*)dF, (float*)M,
      (float*)Den, (float*)Dn, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlstm_bwd_cols<T, HD><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)F,
      (const float*)I, (const T*)dh, (const float*)M, (const float*)Den,
      (const float*)Dn, (T*)dk, (T*)dv, (float*)dF, (float*)dI, S, H);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* F,
             const void* I, const void* dh, void* dq, void* dk, void* dv,
             void* dF, void* dI, void* M, void* Den, void* Dn, int B, int S,
             int H, int hd, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || (long long)B * H >= (1LL << 31) ||
      (S + kB - 1) / kB > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define MLSTM_BWD_CASE(HD)                                                  \
  case HD:                                                                  \
    return launch<T, HD>(q, k, v, F, I, dh, dq, dk, dv, dF, dI, M, Den, Dn, \
                         B, S, H, st);
  switch (hd) {
    MLSTM_BWD_CASE(16)
    MLSTM_BWD_CASE(32)
    MLSTM_BWD_CASE(64)
    MLSTM_BWD_CASE(128)
    MLSTM_BWD_CASE(256)
    MLSTM_BWD_CASE(384)
    default: return (int)cudaErrorInvalidValue;
  }
#undef MLSTM_BWD_CASE
}

}  // namespace simt

namespace wg {

constexpr int kThreads = 384;  // producer + two consumer warpgroups
constexpr int kPBytes = kRows * kRows * 2;  // the bf16 operand tile
constexpr float kFloor = -1e30f;

// the route's four kernels, launched in this order
enum Pass { kStats = 0, kDq = 1, kDk = 2, kDv = 3 };

// Shared memory: two fixed tiles (q and dh of the block's query rows, or k
// and v of its key rows), two streamed ones (k and v of a key tile, or q
// and dh of a query tile), one stage each, and the bf16 operand (64 x 64)
template <int HD> struct Layout {
  static constexpr int kTile = (HD / kBox) * kBoxBytes;  // 64 rows x HD
  static constexpr int kF0 = 0;
  static constexpr int kF1 = kTile;
  static constexpr int kX0 = 2 * kTile;
  static constexpr int kX1 = 3 * kTile;
  static constexpr int kP = 4 * kTile;
  static constexpr int kBytes = kP + kPBytes;
};
static_assert(Layout<384>::kBytes == 204800, "200 KB at hd 384");
// keys whose (F, I) the stabilizer's prologue stages at a time, as float2
// in the operand tile
constexpr int kStaged = kPBytes / 8;

template <int PASS> struct Role {
  static constexpr bool kRowsPass = PASS == kStats || PASS == kDq;
  static constexpr bool kNeedE = PASS != kDv;   // the dh . v products
  static constexpr bool kAcc = PASS != kStats;  // an accumulated product
  // the streamed tile the accumulated product reads: X0 (k for dq, q for
  // dk) or X1 (dh for dv); the other one is released first
  static constexpr int kAccX = PASS == kDv ? 1 : 0;
};

// One pass of the backward over ((b, h), a 64-row tile of its own side):
// see the header.  Maps in role order: F0, F1 (fixed), X0, X1 (streamed).
template <int HD, int PASS>
__global__ void __launch_bounds__(kThreads, 1)
mlstm_bwd_wgmma(const __grid_constant__ CUtensorMap f0map,
                const __grid_constant__ CUtensorMap f1map,
                const __grid_constant__ CUtensorMap x0map,
                const __grid_constant__ CUtensorMap x1map,
                const float* __restrict__ Fc, const float* __restrict__ Ig,
                float* Mrow, float* Den, float* Dn, float* dF,
                float* __restrict__ dI, __nv_bfloat16* __restrict__ out,
                int S, int H) {
  using L = Layout<HD>;
  using R = Role<PASS>;
  constexpr int NO = HD / 4;  // accumulator floats a thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_fixed, bar_full[2], bar_empty[2];
  __shared__ float m_row[kRows];          // stats: each row's stabilizer
  __shared__ float half[2][2][kRows];     // each consumer's row sums
  // cols passes: F_t, m_t, den_t, dn_t of a query tile's columns, two
  // tiles' worth (the one in use and the next)
  __shared__ float colv[2][4][kRows];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int n_tiles = (S + kRows - 1) / kRows;
  // rows passes: query tiles from the last (the longest first), key tiles
  // from 0 up to the diagonal; cols passes: key tiles from the first,
  // query tiles from the last down to the diagonal.  Either way the blocks
  // of one (b, h) in flight read the same streamed tiles at about the same
  // time, which keeps them in L2
  const int tile = R::kRowsPass ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int count = R::kRowsPass ? tile + 1 : n_tiles - tile;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int wgi = threadIdx.x / 128, tig = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(&bar_fixed, 1);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      mbar_init(&bar_full[x], 1);
      mbar_init(&bar_empty[x], 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    // producer: one thread issues every load; of the two streamed tiles
    // the one the consumers release first is loaded first
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tig == 0) {
      constexpr int kBoxes = HD / kBox;
      mbar_expect_tx(&bar_fixed, (R::kNeedE ? 2 : 1) * L::kTile);
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) {
        tma_load_4d(smem + L::kF0 + x * kBoxBytes, &f0map, &bar_fixed,
                    x * kBox, h, tile * kRows, b);
        if (R::kNeedE)
          tma_load_4d(smem + L::kF1 + x * kBoxBytes, &f1map, &bar_fixed,
                      x * kBox, h, tile * kRows, b);
      }
      for (int j = 0; j < count; ++j) {
        const int row = (R::kRowsPass ? j : n_tiles - 1 - j) * kRows;
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          const int x = R::kAccX == 0 ? 1 - o : o;   // early one first
          if (j >= 1) mbar_wait(&bar_empty[x], (j - 1) & 1);
          mbar_expect_tx(&bar_full[x], L::kTile);
          uint8_t* dst = smem + (x == 0 ? L::kX0 : L::kX1);
          const CUtensorMap* map = x == 0 ? &x0map : &x1map;
#pragma unroll
          for (int y = 0; y < kBoxes; ++y)
            tma_load_4d(dst + y * kBoxBytes, map, &bar_full[x], y * kBox, h,
                        row, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw computes the products for the streamed rows
  // 32 cw .. + 31 of each tile and owns the accumulated columns cw HD/2 ..
  // + HD/2 - 1; a thread holds rows rl and rl + 8 of the fixed tile,
  // columns 8 n + 2 quad + {0, 1} of each fragment
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wgi - 1, ct = threadIdx.x - 128;
  const int warp = tig / 32, lane = tig % 32, quad = lane % 4;
  const int rl = 16 * warp + lane / 4;
  const int r0 = tile * kRows + rl, r1 = r0 + 8;   // the fixed rows
  const size_t gbase = (size_t)b * S * H + h;      // F, I of (b, 0, h)
  const bool in0 = r0 < S, in1 = r1 < S;

  // per fixed row: rows passes F_t, m_t (and den_t, dn_t for dq); cols
  // passes F_s, I_s
  float fr0 = in0 ? Fc[gbase + (size_t)r0 * H] : 0.f;
  float fr1 = in1 ? Fc[gbase + (size_t)r1 * H] : 0.f;
  float m0 = 0.f, m1 = 0.f, den0 = 1.f, den1 = 1.f, dn0 = 0.f, dn1 = 0.f;
  float ir0 = 0.f, ir1 = 0.f;
  if constexpr (PASS == kStats) {
    // the exact stabilizer m_t = max(-1e30, max_{s <= t} (F_t - F_s) + I_s)
    // while the first loads land: (F_s, I_s) staged as float2 in the
    // operand tile, kStaged keys at a time; four threads a row
    const int kv_end = min((tile + 1) * kRows, S);
    const int row = ct >> 2, part = ct & 3, t = tile * kRows + row;
    float2* fi = reinterpret_cast<float2*>(smem + L::kP);
    const float ft = t < S ? Fc[gbase + (size_t)t * H] : 0.f;
    float mx = kFloor;
    for (int s0 = 0; s0 < kv_end; s0 += kStaged) {
      const int n = min(kStaged, kv_end - s0);
      if (s0 > 0) consumers_sync();  // the last chunk is read
      for (int i = ct; i < n; i += 256) {
        const size_t g = gbase + (size_t)(s0 + i) * H;
        fi[i] = make_float2(Fc[g], Ig[g]);
      }
      consumers_sync();
      const int hi = min(t - s0, n - 1);  // the row's last key here
#pragma unroll 8
      for (int i = part; i <= hi; i += 4) {
        const float2 x = fi[i];
        mx = fmaxf(mx, (ft - x.x) + x.y);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    if (part == 0) m_row[row] = t < S ? mx : 0.f;
    consumers_sync();
    m0 = m_row[rl];
    m1 = m_row[rl + 8];
  } else if constexpr (PASS == kDq) {
    if (in0) {
      m0 = Mrow[gbase + (size_t)r0 * H];
      den0 = Den[gbase + (size_t)r0 * H];
      dn0 = Dn[gbase + (size_t)r0 * H];
    }
    if (in1) {
      m1 = Mrow[gbase + (size_t)r1 * H];
      den1 = Den[gbase + (size_t)r1 * H];
      dn1 = Dn[gbase + (size_t)r1 * H];
    }
  } else {
    ir0 = in0 ? Ig[gbase + (size_t)r0 * H] : 0.f;
    ir1 = in1 ? Ig[gbase + (size_t)r1 * H] : 0.f;
  }
  // the last live key of each query row (rows passes): t, or none past S
  const int last0 = in0 ? r0 : -1, last1 = in1 ? r1 : -1;

  float acc[R::kAcc ? NO : 1];
#pragma unroll
  for (int i = 0; i < (R::kAcc ? NO : 1); ++i) acc[i] = 0.f;
  float sum0 = 0.f, sum1 = 0.f;   // stats: n; dk: the column sums of dD
  float rs0 = 0.f, rs1 = 0.f;     // stats: r
  const uint32_t f0addr = smem_u32(smem + L::kF0);
  const uint32_t f1addr = smem_u32(smem + L::kF1);
  // this consumer's 32 streamed rows of each box
  const uint32_t x0addr = smem_u32(smem + L::kX0) + cw * 32 * 128;
  const uint32_t x1addr = smem_u32(smem + L::kX1) + cw * 32 * 128;
  // the accumulated product's B: this consumer's HD / 2 columns
  const uint32_t xacc = smem_u32(smem + (R::kAccX == 0 ? L::kX0 : L::kX1)) +
                        cw * (HD / 128) * kBoxBytes;
  uint8_t* pt = smem + L::kP;
  // cols passes: consumer thread ct loads value ct / 64 (F, m, den, dn) of
  // column ct % 64 of the next query tile, a tile ahead (past S: 0, 0, 1,
  // 0; dn only in dk)
  const int cv = ct / kRows, cc = ct % kRows;
  auto col_value = [&](int jj) {
    const int t = (n_tiles - 1 - jj) * kRows + cc;
    if (jj >= count || t >= S) return cv == 2 ? 1.f : 0.f;
    const size_t g = gbase + (size_t)t * H;
    return cv == 0 ? Fc[g] : cv == 1 ? Mrow[g] : cv == 2 ? Den[g]
                                       : PASS == kDk ? Dn[g] : 0.f;
  };
  float col_next = R::kRowsPass ? 0.f : col_value(0);
  mbar_wait(&bar_fixed, 0);
  for (int j = 0; j < count; ++j) {
    const int jt = R::kRowsPass ? j : n_tiles - 1 - j;   // streamed tile
    const int c0 = jt * kRows + 32 * cw + 2 * quad;      // + 8 n + e
    // per streamed column: rows passes F_s, I_s of the key (registers);
    // cols passes F_t, m_t, den_t, dn_t of the query (shared memory)
    float ca[8], cb[8];
    float* cvt = &colv[j & 1][0][0];
    if constexpr (R::kRowsPass) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + 8 * n + e, i = 2 * n + e;
          const size_t g = gbase + (size_t)col * H;
          ca[i] = col < S ? Fc[g] : 0.f;
          cb[i] = col < S ? Ig[g] : 0.f;
        }
    } else {
      // every consumer read this buffer two tiles ago, before it reached
      // the last tile's barrier here
      cvt[cv * kRows + cc] = col_next;
      consumers_sync();
      col_next = col_value(j + 1);
    }

    // the products over hd in steps of 16: s = F0 X0^T and (but for dv)
    // e = F1 X1^T, this consumer's 32 columns (wgmma m64n32k16)
    float sc[16], ec[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = ec[i] = 0.f;
    mbar_wait(&bar_full[0], j & 1);
    if (R::kNeedE) mbar_wait(&bar_full[1], j & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_n32(sc, desc_sw128(f0addr + off, 16, 1024),
                   desc_sw128(x0addr + off, 16, 1024), 1);
      if (R::kNeedE)
        wgmma_ss_n32(ec, desc_sw128(f1addr + off, 16, 1024),
                     desc_sw128(x1addr + off, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(ec);
    // release what no later product of this tile reads
    if (R::kAccX != 0 || !R::kAcc) mbar_arrive(&bar_empty[0]);
    if (R::kNeedE && (R::kAccX != 1 || !R::kAcc)) mbar_arrive(&bar_empty[1]);

    if (MLSTM_BWD_CUT == 1) {
      // ablation: keep the products, drop the rest (outputs wrong); a tile
      // is released only once its load has landed
#pragma unroll
      for (int i = 0; i < 16; ++i) sum0 += sc[i] + ec[i];
      if (R::kAcc) {
        if (R::kAccX == 1) mbar_wait(&bar_full[1], j & 1);
        mbar_arrive(&bar_empty[R::kAccX]);
      }
      continue;
    }

    // element (row, column) of fragment (n, e): sc / ec index 4 n + e for
    // row rl, 4 n + 2 + e for row rl + 8
    float p[16];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * n + e, col = c0 + 8 * n + e;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int x = 4 * n + 2 * rr + e;
          bool live;
          float W, den, dn;
          if (R::kRowsPass) {
            live = col <= (rr ? last1 : last0);
            const float fr = rr ? fr1 : fr0, m = rr ? m1 : m0;
            W = expf(((fr - ca[i]) + cb[i]) - m);
            den = rr ? den1 : den0;
            dn = rr ? dn1 : dn0;
          } else {
            const int s = rr ? r1 : r0, k = col - jt * kRows;
            live = s <= col && col < S;
            W = expf(((cvt[k] - (rr ? fr1 : fr0)) + (rr ? ir1 : ir0)) -
                     cvt[kRows + k]);
            den = cvt[2 * kRows + k];
            dn = cvt[3 * kRows + k];
          }
          const float Sv = sc[x] * W;
          if constexpr (PASS == kStats) {
            const float sv = live ? Sv : 0.f;
            (rr ? sum1 : sum0) += sv;
            (rr ? rs1 : rs0) += sv * ec[x];
            p[x] = 0.f;
          } else if constexpr (PASS == kDv) {
            p[x] = live ? Sv / den : 0.f;
          } else {
            const float dS = ec[x] / den + dn;
            p[x] = live ? dS * W : 0.f;
            if (PASS == kDk) (rr ? sum1 : sum0) += live ? dS * Sv : 0.f;
          }
        }
      }
    if constexpr (R::kAcc) {
      // the other consumer is done reading the last tile's operand
      if (j > 0) consumers_sync();
      // the operand in bf16 into the swizzled tile: row r's 16-byte chunk
      // x sits at chunk x ^ (r % 8); row rl + 8 is the same chunk, + 1024
      const int off = rl * 128 + 4 * quad;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int at = off + (((4 * cw + n) ^ (rl & 7)) << 4);
        *reinterpret_cast<__nv_bfloat162*>(pt + at) =
            __floats2bfloat162_rn(p[4 * n], p[4 * n + 1]);
        *reinterpret_cast<__nv_bfloat162*>(pt + at + 1024) =
            __floats2bfloat162_rn(p[4 * n + 2], p[4 * n + 3]);
      }
      fence_async_smem();
      consumers_sync();  // both halves of the operand are in
      if (R::kAccX == 1) mbar_wait(&bar_full[1], j & 1);
      // acc += P (64 x 64 streamed rows) . X (64 x this consumer's HD / 2)
      const uint32_t p0 = smem_u32(pt);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
        wgmma_pv<HD>(acc, desc_sw128(p0 + kk * 32, 16, 1024),
                     desc_sw128(xacc + kk * 2048, kBoxBytes, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(&bar_empty[R::kAccX]);
    }
  }

  if constexpr (PASS == kStats || PASS == kDk) {
    // the row sums over the quad, then over both consumers (consumer 0's
    // half first)
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
    }
    if (quad == 0) {
      half[cw][0][rl] = sum0;
      half[cw][0][rl + 8] = sum1;
      half[cw][1][rl] = rs0;
      half[cw][1][rl + 8] = rs1;
    }
    consumers_sync();
    if (cw == 0 && quad == 0) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = rl + 8 * rr, t = tile * kRows + r;
        if (t >= S) continue;
        const float s = half[0][0][r] + half[1][0][r];
        const size_t g = gbase + (size_t)t * H;
        if constexpr (PASS == kStats) {
          // den_t, dn_t and dF's row sum, as the simt route computes them
          const float rsum = half[0][1][r] + half[1][1][r];
          const float m = rr ? m1 : m0;
          const float floor = expf(-m);
          const float den = fmaxf(fabsf(s), floor);
          const float dhh = rsum / den;
          const float dn =
              fabsf(s) > floor ? (-copysignf(1.f, s) * dhh) / den : 0.f;
          Mrow[g] = m;
          Den[g] = den;
          Dn[g] = dn;
          dF[g] = dhh + dn * s;
        } else {
          dI[g] = s;
          dF[g] = dF[g] - s;
        }
      }
    }
  }
  if constexpr (R::kAcc) {
    const size_t row = (size_t)H * HD;  // a position's stride
    __nv_bfloat16* obase = out + (size_t)b * S * row + (size_t)h * HD +
                           cw * (HD / 2) + 2 * quad;
#pragma unroll
    for (int n = 0; n < NO / 4; ++n) {
      if (in0)
        *reinterpret_cast<__nv_bfloat162*>(obase + (size_t)r0 * row + 8 * n) =
            __floats2bfloat162_rn(acc[4 * n], acc[4 * n + 1]);
      if (in1)
        *reinterpret_cast<__nv_bfloat162*>(obase + (size_t)r1 * row + 8 * n) =
            __floats2bfloat162_rn(acc[4 * n + 2], acc[4 * n + 3]);
    }
  }
}

template <int HD, int PASS>
int launch_pass(const CUtensorMap& f0, const CUtensorMap& f1,
                const CUtensorMap& x0, const CUtensorMap& x1, const void* F,
                const void* I, void* M, void* Den, void* Dn, void* dF,
                void* dI, void* out, int B, int S, int H,
                cudaStream_t stream) {
  const size_t smem = Layout<HD>::kBytes + 1024;  // + alignment slack
  const cudaError_t e = cudaFuncSetAttribute(
      mlstm_bwd_wgmma<HD, PASS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (S + kRows - 1) / kRows);
  mlstm_bwd_wgmma<HD, PASS><<<grid, kThreads, smem, stream>>>(
      f0, f1, x0, x1, (const float*)F, (const float*)I, (float*)M,
      (float*)Den, (float*)Dn, (float*)dF, (float*)dI, (__nv_bfloat16*)out,
      S, H);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* F,
           const void* I, const void* dh, void* dq, void* dk, void* dv,
           void* dF, void* dI, void* M, void* Den, void* Dn, int B, int S,
           int H, cudaStream_t st) {
  CUtensorMap qm, km, vm, hm;
  int err = make_map(&qm, q, HD, H, S, B);
  if (err == 0) err = make_map(&km, k, HD, H, S, B);
  if (err == 0) err = make_map(&vm, v, HD, H, S, B);
  if (err == 0) err = make_map(&hm, dh, HD, H, S, B);
  if (err == 0)
    err = launch_pass<HD, kStats>(qm, hm, km, vm, F, I, M, Den, Dn, dF, dI,
                                  nullptr, B, S, H, st);
  if (err == 0)
    err = launch_pass<HD, kDq>(qm, hm, km, vm, F, I, M, Den, Dn, dF, dI, dq,
                               B, S, H, st);
  if (err == 0)
    err = launch_pass<HD, kDk>(km, vm, qm, hm, F, I, M, Den, Dn, dF, dI, dk,
                               B, S, H, st);
  if (err == 0)
    err = launch_pass<HD, kDv>(km, vm, qm, hm, F, I, M, Den, Dn, dF, dI, dv,
                               B, S, H, st);
  return err;
}

}  // namespace wg

extern "C" int mlstm_attention_backward_wgmma_bf16(
    const void* q, const void* k, const void* v, const void* F,
    const void* I, const void* dh, void* dq, void* dk, void* dv, void* dF,
    void* dI, void* M, void* Den, void* Dn, int B, int S, int H, int hd,
    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || (long long)B * H >= (1LL << 31) ||
      (S + wg::kRows - 1) / wg::kRows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 128:
      return wg::launch<128>(q, k, v, F, I, dh, dq, dk, dv, dF, dI, M, Den,
                             Dn, B, S, H, st);
    case 256:
      return wg::launch<256>(q, k, v, F, I, dh, dq, dk, dv, dF, dI, M, Den,
                             Dn, B, S, H, st);
    case 384:
      return wg::launch<384>(q, k, v, F, I, dh, dq, dk, dv, dF, dI, M, Den,
                             Dn, B, S, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mlstm_attention_backward_simt_bf16(
    const void* q, const void* k, const void* v, const void* F,
    const void* I, const void* dh, void* dq, void* dk, void* dv, void* dF,
    void* dI, void* M, void* Den, void* Dn, int B, int S, int H, int hd,
    void* stream) {
  return simt::dispatch<__nv_bfloat16>(q, k, v, F, I, dh, dq, dk, dv, dF, dI, M,
                                 Den, Dn, B, S, H, hd, stream);
}

extern "C" int mlstm_attention_backward_simt_f32(
    const void* q, const void* k, const void* v, const void* F,
    const void* I, const void* dh, void* dq, void* dk, void* dv, void* dF,
    void* dI, void* M, void* Den, void* Dn, int B, int S, int H, int hd,
    void* stream) {
  return simt::dispatch<float>(q, k, v, F, I, dh, dq, dk, dv, dF, dI, M, Den, Dn,
                         B, S, H, hd, stream);
}
