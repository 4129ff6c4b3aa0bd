// Causal (or full) grouped-query flash attention, forward.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py:_flash_kernel
// (launched by flash_attention_kernel).  Plain version:
// ops.flash_attention_torch.  q is (BK, G, S, hd), k and v are (BK, S, hd),
// the output is (BK, G, S, hd) in q's dtype; BK = batch x kv heads and G
// query heads share one kv head.  The scores are (q . k) x scale, with the
// scale (hd^-0.5) passed in as the wrapper computes it.  Scores,
// probabilities and the running (m, l, acc) stay in float32; the output is
// rounded once, at the end.
//
// What bounds it on Hopper: operations.  A causal pass does
// 2 x 2 x hd x S^2 / 2 flops per (BK, G) row: at the prefill shape of
// qwen2-1.5b (BK = 16, G = 6, S = 2048, hd = 128) that is 103 GFLOP
// against 151 MB of q, k, v and output, so the tensor cores' 989 TFLOP/s
// (0.10 ms) bound it, not the 3.35 TB/s of HBM (0.05 ms).
//
// Design (simple first: CUDA cores, float32 FMA; tensor cores are later
// work, and so this kernel runs at the 67 TFLOP/s float32 rate at best):
//   * one block of 256 threads per (query tile of 64 rows, g, bk): the
//     grid's x walks the query tiles, so a block computes its own offsets
//     and masks the ragged edge (any S, where the Pallas kernel asserts
//     S % bq == 0);
//   * the q tile is staged once in shared memory as float32; each key tile
//     of 64 rows of k and v is staged per step; rows are padded to hd + 4
//     floats so the float4 reads of the score loop hit distinct banks;
//   * each thread owns a 4 x 4 block of scores (rows ty*4+i, keys tx+16j)
//     and a 4 x hd/16 block of the accumulator in registers;
//   * the scores overwrite the k tile as probabilities; one warp per 8 rows
//     does the online-softmax update of (m, l) and a per-row correction;
//   * causal: the loop over key tiles stops at the diagonal (the Pallas
//     kernel's block skip), and keys past the query or past S get -inf;
//     a row with no live key yet uses 0 as its max, so exp gives 0, never
//     NaN;
//   * the output is acc / max(l, 1e-30), as in the Pallas kernel.
// Two blocks fit on an SM at hd = 128 (99.6 KB of shared memory each).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBKV = 64;       // key rows per step
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPLD = kBKV + 4; // row stride of the probability tile

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
  return sizeof(float) *
         (size_t)(kBQ * tile_ld<HD>() + kp_floats<HD>() + kBKV * HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int G, int S,
          float scale, int causal) {
  constexpr int LD = tile_ld<HD>();
  constexpr int NC = HD / 16;  // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                        // kBQ x LD
  float* ks = qs + kBQ * LD;               // kBKV x LD, then kBQ x kPLD probs
  float* vs = ks + kp_floats<HD>();        // kBKV x HD
  __shared__ float m_s[kBQ], l_s[kBQ], c_s[kBQ];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kBQ, g = blockIdx.y, bk = blockIdx.z;
  const size_t qbase = ((size_t)bk * G + g) * (size_t)S * HD;
  const size_t kbase = (size_t)bk * (size_t)S * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    qs[r * LD + d] =
        q0 + r < S ? to_f(q[qbase + (size_t)(q0 + r) * HD + d]) : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;

  const int q_last = min(q0 + kBQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;  // keys [0, kv_end) can count
  for (int k0 = 0; k0 < kv_end; k0 += kBKV) {
    __syncthreads();  // the previous step is done with ks and vs
    for (int i = tid; i < kBKV * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < S;
      const size_t off = kbase + (size_t)(k0 + r) * HD + d;
      ks[r * LD + d] = in ? to_f(k[off]) : 0.f;
      vs[r * HD + d] = in ? to_f(v[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&qs[(ty * 4 + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(&ks[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(a[i].x, b[j].x, t);
          t = fmaf(a[i].y, b[j].y, t);
          t = fmaf(a[i].z, b[j].z, t);
          t = fmaf(a[i].w, b[j].w, t);
          s[i][j] = t;
        }
    }
    __syncthreads();  // every read of the k tile is done: it becomes probs

    float* ps = ks;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        const int kp = k0 + c;
        const bool live = kp < S && (!causal || kp <= q0 + r);
        ps[r * kPLD + c] = live ? s[i][j] * scale : -INFINITY;
      }
    __syncthreads();

    // online softmax: warp w updates rows 8w .. 8w + 7
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      float* row = ps + r * kPLD;
      const float x0 = row[lane], x1 = row[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float p0 = expf(x0 - m_use), p1 = expf(x1 - m_use);
      row[lane] = p0;
      row[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_prev - m_use);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = c_s[ty * 4 + i];
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] *= c;
    }
    for (int j = 0; j < kBKV; j += 4) {
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
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= S) continue;
    const float den = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < NC; ++n)
      o[qbase + (size_t)(q0 + r) * HD + tx + 16 * n] =
          from_f<T>(acc[i][n] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int BK,
           int G, int S, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, G, BK);
  flash_fwd<T, HD><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, G, S, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int BK,
             int G, int S, int hd, int causal, float scale, void* stream) {
  if (BK <= 0 || G <= 0 || S <= 0 || BK > 65535 || G > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, BK, G, S, causal, scale, st);
    case 32: return launch<T, 32>(q, k, v, o, BK, G, S, causal, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, BK, G, S, causal, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, BK, G, S, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int BK, int G,
                                    int S, int hd, int causal, float scale,
                                    void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, BK, G, S, hd, causal, scale,
                                 stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int BK, int G,
                                   int S, int hd, int causal, float scale,
                                   void* stream) {
  return dispatch<float>(q, k, v, o, BK, G, S, hd, causal, scale, stream);
}
