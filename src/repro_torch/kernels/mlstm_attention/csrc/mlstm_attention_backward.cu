// Stabilized causal mLSTM sequence mix (xLSTM's matrix memory, parallel
// form): the backward.
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
//         = (sum_s e_ts W_ts k_s) / den_t + dn_t sum_s W_ts k_s
//   dk_s  = sum_t dS_ts W_ts q_t,   dv_s = sum_t (S_ts / den_t) dh_t
//   dF_t  = sum_s dS_ts S_ts - sum_t' dS_t't S_t't,   dI_s = sum_t dS_ts S_ts
//
// m_t is held constant: h_t does not depend on it (its factor exp(-m_t)
// cancels in either branch of den), so its exact gradient is 0.  All
// arithmetic is float32, the outputs rounded once.
//
// What bounds it on Hopper: operations.  Five products of hd multiply-adds
// over the S (S + 1) / 2 causal pairs of each (b, h) are the least the
// function needs (q k^T, dh v^T, dq, dk, dv): at xlstm-125m's training
// shape (B 4, H 4, S 2048, hd 384, bf16), 6.4e10 flops, 0.065 ms at the
// tensor cores' 989 TFLOP/s.
//
// Design (simple first: float32 FMA on the CUDA cores, deterministic):
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
//     and W is 0 there and above the diagonal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

}  // namespace

extern "C" int mlstm_attention_backward_bf16(
    const void* q, const void* k, const void* v, const void* F,
    const void* I, const void* dh, void* dq, void* dk, void* dv, void* dF,
    void* dI, void* M, void* Den, void* Dn, int B, int S, int H, int hd,
    void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, F, I, dh, dq, dk, dv, dF, dI, M,
                                 Den, Dn, B, S, H, hd, stream);
}

extern "C" int mlstm_attention_backward_f32(
    const void* q, const void* k, const void* v, const void* F,
    const void* I, const void* dh, void* dq, void* dk, void* dv, void* dF,
    void* dI, void* M, void* Den, void* Dn, int B, int S, int H, int hd,
    void* stream) {
  return dispatch<float>(q, k, v, F, I, dh, dq, dk, dv, dF, dI, M, Den, Dn,
                         B, S, H, hd, stream);
}
