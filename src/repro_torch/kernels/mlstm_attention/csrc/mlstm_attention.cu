// Stabilized causal mLSTM sequence mix (xLSTM's matrix memory, parallel
// form), forward.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/mlstm_attention/kernel.py:_mlstm_kernel
// (launched by mlstm_attention_kernel).  Plain version:
// ops.mlstm_attention_torch.  q, k, v are (B, S, H, hd) in the model's
// layout (the Pallas kernel's (BH, S, hd) is the case H = 1), k already
// scaled by hd^-0.5; F (the inclusive cumulative log-forget) and I (the
// log input gate) are (B, S, H) float32; the output is (B, S, H, hd) in
// q's dtype.  For each query t of each (b, h):
//
//   D_ts = F_t - F_s + I_s  (s <= t),   m_t = max_{s<=t} D_ts
//   h_t  = sum_s exp(D_ts - m_t) (q_t . k_s) v_s
//          / max(|sum_s exp(D_ts - m_t) (q_t . k_s)|, exp(-m_t))
//
// All arithmetic is float32; the output is rounded once.  Where
// exp(-m_t) overflows (m_t below about -88) the output is 0, as in the
// reference; m is not clamped.
//
// What bounds it on Hopper: operations.  Two chained products of
// 2 x hd x S (S + 1) / 2 multiply-adds per (b, h): at xlstm-125m's prefill
// (B 8, H 4, S 2048, hd 384, bf16) that is 1.03e11 flops against 0.20 GB
// of q, k, v, F, I and output, so the tensor cores' 989 TFLOP/s
// (0.104 ms) bound it, not the 3.35 TB/s of HBM (0.060 ms).
//
// Design (simple first: CUDA cores, float32 FMA, so at best the 67 TFLOP/s
// float32 rate; wgmma and TMA are later work):
//   * one block of 256 threads (16 x 16) per ((b, h), query tile of 64
//     rows); the grid's x walks (b, h) and its y the query tiles from the
//     last, so the tiles with the most keys are launched first; any S
//     (the ragged tile is masked, where the Pallas kernel asserts
//     S % bq == 0);
//   * hd = 384 makes the (64, hd) float32 accumulator 96 KB: it lives in
//     registers, 4 rows x hd/16 columns a thread (96 floats at hd = 384),
//     and the key tile is 32 rows, so the q tile (64 x (hd + 4) floats),
//     the k tile (32 x (hd + 4)) and the v tile (32 x hd) take 198 KB of
//     shared memory at hd = 384 (one block an SM);
//   * each thread owns a 4 x 2 block of the (64, 32) score tile (rows
//     ty*4+i, keys tx+16j); the 16 threads of a row are 16 lanes of one
//     warp, so the row's tile max and signed score sum are shuffle
//     reductions, and every one of the 16 keeps the row's running (m, sum)
//     in registers (the butterfly gives all of them the same bits);
//   * masking sets the decay weight W to 0 for s > t and for keys past S;
//     m starts at -1e30 (the reference's floor), so it stays finite.  Key
//     tile 0 gives every query a live key (s = 0), so m is a real max from
//     the first tile on, whatever order the blocks run in;
//   * the key loop stops at the diagonal (the Pallas kernel's causal block
//     skip); the weighted scores overwrite the k tile's space, and the
//     accumulator update reads them back from shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBKV = 32;       // key rows per step
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPLD = kBKV + 4; // row stride of the weighted-score tile
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
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

template <int HD> __host__ __device__ constexpr int tile_ld() {
  return HD + 4;
}
template <int HD> __host__ __device__ constexpr int kp_floats() {
  return kBKV * tile_ld<HD>() > kBQ * kPLD ? kBKV * tile_ld<HD>()
                                           : kBQ * kPLD;
}
template <int HD> constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(kBQ * tile_ld<HD>() + kp_floats<HD>() +
                                  kBKV * HD + 2 * kBKV);
}

// max and sum over the 16 lanes of a half warp (one score row)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
mlstm_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const float* __restrict__ Fc,
          const float* __restrict__ Ig, T* __restrict__ o, int S, int H) {
  constexpr int LD = tile_ld<HD>();
  constexpr int NC = HD / 16;  // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // kBQ x LD
  float* ks = qs + kBQ * LD;          // kBKV x LD, then kBQ x kPLD scores
  float* vs = ks + kp_floats<HD>();   // kBKV x HD
  float* fk = vs + kBKV * HD;         // kBKV
  float* ik = fk + kBKV;              // kBKV

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest tiles first
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const size_t row = (size_t)H * HD;                  // a position's stride
  const size_t base = (size_t)b * S * row + (size_t)h * HD;
  const size_t gbase = (size_t)b * S * H + h;         // F, I of (b, 0, h)

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    qs[r * LD + d] =
        q0 + r < S ? to_f(q[base + (size_t)(q0 + r) * row + d]) : 0.f;
  }
  float fq[4], m[4], ssum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    fq[i] = t < S ? Fc[gbase + (size_t)t * H] : 0.f;
    m[i] = kFloor;
    ssum[i] = 0.f;
  }
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;

  const int kv_end = min(q0 + kBQ, S);  // keys [0, kv_end) can count
  for (int k0 = 0; k0 < kv_end; k0 += kBKV) {
    __syncthreads();  // the previous step is done with ks, vs, fk, ik
    for (int i = tid; i < kBKV * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < S;
      const size_t off = base + (size_t)(k0 + r) * row + d;
      ks[r * LD + d] = in ? to_f(k[off]) : 0.f;
      vs[r * HD + d] = in ? to_f(v[off]) : 0.f;
    }
    if (tid < kBKV) {
      const bool in = k0 + tid < S;
      const size_t off = gbase + (size_t)(k0 + tid) * H;
      fk[tid] = in ? Fc[off] : 0.f;
      ik[tid] = in ? Ig[off] : 0.f;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], c[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&qs[(ty * 4 + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        c[j] = *reinterpret_cast<const float4*>(&ks[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float t = s[i][j];
          t = fmaf(a[i].x, c[j].x, t);
          t = fmaf(a[i].y, c[j].y, t);
          t = fmaf(a[i].z, c[j].z, t);
          t = fmaf(a[i].w, c[j].w, t);
          s[i][j] = t;
        }
    }

    // decay weights, the online stabilizer and the signed score sums
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + ty * 4 + i;
      float D[2];
      bool live[2];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + tx + 16 * j;
        live[j] = kp < S && kp <= t;
        D[j] = (fq[i] - fk[tx + 16 * j]) + ik[tx + 16 * j];
        if (live[j]) mx = fmaxf(mx, D[j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - m_new);
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] = live[j] ? s[i][j] * expf(D[j] - m_new) : 0.f;
        part += s[i][j];
      }
      ssum[i] = ssum[i] * corr[i] + row_sum(part);
      m[i] = m_new;
    }
    __syncthreads();  // every read of the k tile is done: it takes scores

    float* ps = ks;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ps[(ty * 4 + i) * kPLD + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] *= corr[i];
    const int kn = min(kBKV, kv_end - k0);  // rows past it hold weight 0
    for (int j = 0; j < kn; j += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(&ps[(ty * 4 + i) * kPLD + j]);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int d = tx + 16 * n;
        const float v0 = vs[(j + 0) * HD + d], v1 = vs[(j + 1) * HD + d];
        const float v2 = vs[(j + 2) * HD + d], v3 = vs[(j + 3) * HD + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float t = acc[i][n];
          t = fmaf(p[i].x, v0, t);
          t = fmaf(p[i].y, v1, t);
          t = fmaf(p[i].z, v2, t);
          t = fmaf(p[i].w, v3, t);
          acc[i][n] = t;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= S) continue;
    const float den = fmaxf(fabsf(ssum[i]), expf(-m[i]));
#pragma unroll
    for (int n = 0; n < NC; ++n)
      o[base + (size_t)t * row + tx + 16 * n] = from_f<T>(acc[i][n] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* F,
           const void* I, void* o, int B, int S, int H, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  mlstm_fwd<T, HD><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)F,
      (const float*)I, (T*)o, S, H);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* F,
             const void* I, void* o, int B, int S, int H, int hd,
             void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || (long long)B * H >= (1LL << 31) ||
      (S + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, F, I, o, B, S, H, st);
    case 32: return launch<T, 32>(q, k, v, F, I, o, B, S, H, st);
    case 64: return launch<T, 64>(q, k, v, F, I, o, B, S, H, st);
    case 128: return launch<T, 128>(q, k, v, F, I, o, B, S, H, st);
    case 256: return launch<T, 256>(q, k, v, F, I, o, B, S, H, st);
    case 384: return launch<T, 384>(q, k, v, F, I, o, B, S, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int mlstm_attention_bf16(const void* q, const void* k,
                                    const void* v, const void* F,
                                    const void* I, void* o, int B, int S,
                                    int H, int hd, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, F, I, o, B, S, H, hd, stream);
}

extern "C" int mlstm_attention_f32(const void* q, const void* k,
                                   const void* v, const void* F,
                                   const void* I, void* o, int B, int S,
                                   int H, int hd, void* stream) {
  return dispatch<float>(q, k, v, F, I, o, B, S, H, hd, stream);
}
