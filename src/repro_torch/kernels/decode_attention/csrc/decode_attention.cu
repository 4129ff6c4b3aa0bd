// Flash-decoding, phase 1: per-chunk partial softmax of one query token.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention/kernel.py:_decode_kernel
// (launched by decode_attention_partials).  Plain version:
// ops.decode_attention_partials_torch; phase 2, the log-sum-exp combine,
// is plain torch in ops.py as it is jnp in the reference.
//
// Layout: q is (B, KH, G, hd); k and v are the model's KV cache,
// (B, S, KH, hd), read in place with a key stride of KH x hd (the
// reference's (BK, S, hd) layout is the case KH = 1).  Outputs, float32:
// acc (B*KH, G, nc, hd), m and l (B*KH, G, nc), nc = ceil(S / bc).
// Only keys j < kv_len count (the cache is preallocated and valid up to
// the write index): chunk c covers keys [c*bc, min((c+1)*bc, kv_len));
// a chunk wholly past kv_len writes m = -inf, l = 0, acc = 0, and a ragged
// last chunk is cut at kv_len.  This is the Pallas kernel applied to
// k[:, :kv_len], which asserts S % bc == 0 and has no mask.
//
// What bounds it on Hopper: bytes.  Each valid key and value row is read
// once (2 x kv_len x hd x 2 B per (b, kv head) in bf16) for 4 x G x hd
// flops per key: at qwen2-1.5b's decode shape (B*KH = 16, G = 6, hd = 128,
// 2080 keys) 17 MB, 5 us at 3.35 TB/s.
//
// Design (simple first):
//   * one block of 256 threads per (chunk, b*KH): q (G x hd) and the
//     chunk's scores (G x bc) live in shared memory as float32;
//   * pass 1 stages 64-key tiles of k in shared memory (coalesced rows,
//     padded to hd + 4 floats for conflict-free float4 reads) and computes
//     each (g, key) score as a dot product;
//   * one warp per g takes the max, the probabilities and their sum;
//   * pass 2 stages 64-key tiles of v and each thread accumulates its
//     (g, d) pairs of acc in registers (at most 8 per thread, so
//     G x hd <= 2048).
// With bc = 512 and 2080 keys there are only 5 x 16 = 80 blocks for 132
// SMs; more, smaller chunks or a split over kv heads is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTK = 64;         // keys per staged tile
constexpr int kThreads = 256;
constexpr int kMaxPairs = 8;    // (g, d) accumulator pairs per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int HD> __host__ __device__ constexpr int tile_ld() {
  return HD + 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_partials(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, float* __restrict__ acc_out,
                float* __restrict__ m_out, float* __restrict__ l_out, int KH,
                int G, int S, int kv_len, int bc, int nc, float scale) {
  constexpr int LD = tile_ld<HD>();
  extern __shared__ __align__(16) float smem[];
  float* ts = smem;             // kTK x LD: a staged k or v tile
  float* qs = ts + kTK * LD;    // G x HD
  float* ps = qs + G * HD;      // G x bc: scores, then probabilities

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = blockIdx.x, bk = blockIdx.y;
  const int b = bk / KH, h = bk % KH;
  const int j0 = c * bc;
  const int n = min(bc, kv_len - j0);  // live keys of this chunk
  const size_t stat = (size_t)bk * G * nc + c;  // (bk, g = 0, c)

  if (n <= 0) {  // wholly past kv_len
    for (int g = tid; g < G; g += kThreads) {
      m_out[stat + (size_t)g * nc] = -INFINITY;
      l_out[stat + (size_t)g * nc] = 0.f;
    }
    for (int i = tid; i < G * HD; i += kThreads)
      acc_out[(stat + (size_t)(i / HD) * nc) * HD + i % HD] = 0.f;
    return;
  }

  const size_t row = (size_t)KH * HD;  // stride between keys
  const size_t kvbase = (size_t)b * S * row + (size_t)h * HD;
  for (int i = tid; i < G * HD; i += kThreads)
    qs[i] = to_f(q[(size_t)bk * G * HD + i]);

  // pass 1: scores
  for (int t0 = 0; t0 < n; t0 += kTK) {
    const int tn = min(kTK, n - t0);
    __syncthreads();
    for (int i = tid; i < kTK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      ts[r * LD + d] =
          r < tn ? to_f(k[kvbase + (size_t)(j0 + t0 + r) * row + d]) : 0.f;
    }
    __syncthreads();
    for (int p = tid; p < G * kTK; p += kThreads) {
      const int g = p / kTK, r = p % kTK;
      if (r >= tn) continue;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; d += 4) {
        const float4 a = *reinterpret_cast<const float4*>(&qs[g * HD + d]);
        const float4 e = *reinterpret_cast<const float4*>(&ts[r * LD + d]);
        s = fmaf(a.x, e.x, s);
        s = fmaf(a.y, e.y, s);
        s = fmaf(a.z, e.z, s);
        s = fmaf(a.w, e.w, s);
      }
      ps[g * bc + t0 + r] = s * scale;
    }
  }
  __syncthreads();

  // max, probabilities and their sum: one warp per g
  for (int g = warp; g < G; g += kThreads / 32) {
    float* sr = ps + g * bc;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sr[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(sr[j] - mx);
      sr[j] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      m_out[stat + (size_t)g * nc] = mx;
      l_out[stat + (size_t)g * nc] = sum;
    }
  }

  // pass 2: acc[g][d] = sum_j p[g][j] v[j][d]
  float a[kMaxPairs];
#pragma unroll
  for (int u = 0; u < kMaxPairs; ++u) a[u] = 0.f;
  for (int t0 = 0; t0 < n; t0 += kTK) {
    const int tn = min(kTK, n - t0);
    __syncthreads();  // probabilities written; the previous tile consumed
    for (int i = tid; i < kTK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      ts[r * LD + d] =
          r < tn ? to_f(v[kvbase + (size_t)(j0 + t0 + r) * row + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kMaxPairs; ++u) {
      const int p = tid + u * kThreads;
      if (p >= G * HD) break;
      const int g = p / HD, d = p % HD;
      const float* pr = ps + g * bc + t0;
      float s = a[u];
      for (int r = 0; r < tn; ++r) s = fmaf(pr[r], ts[r * LD + d], s);
      a[u] = s;
    }
  }
#pragma unroll
  for (int u = 0; u < kMaxPairs; ++u) {
    const int p = tid + u * kThreads;
    if (p >= G * HD) break;
    const int g = p / HD, d = p % HD;
    acc_out[(stat + (size_t)g * nc) * HD + d] = a[u];
  }
}

template <int HD> size_t smem_bytes(int G, int bc) {
  return sizeof(float) * ((size_t)G * HD + (size_t)G * bc +
                          (size_t)kTK * tile_ld<HD>());
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* acc, void* m,
           void* l, int B, int KH, int G, int S, int kv_len, int bc,
           float scale, cudaStream_t stream) {
  if (G * HD > kMaxPairs * kThreads) return (int)cudaErrorInvalidValue;
  const int nc = (S + bc - 1) / bc;
  const size_t smem = smem_bytes<HD>(G, bc);
  cudaError_t err = cudaFuncSetAttribute(
      decode_partials<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nc, B * KH);
  decode_partials<T, HD><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (float*)acc, (float*)m,
      (float*)l, KH, G, S, kv_len, bc, nc, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* acc,
             void* m, void* l, int B, int KH, int G, int S, int hd,
             int kv_len, int bc, float scale, void* stream) {
  if (B <= 0 || KH <= 0 || G <= 0 || S <= 0 || bc <= 0 || kv_len < 1 ||
      kv_len > S || B * KH > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, acc, m, l, B, KH, G, S, kv_len, bc,
                           scale, st);
    case 32:
      return launch<T, 32>(q, k, v, acc, m, l, B, KH, G, S, kv_len, bc,
                           scale, st);
    case 64:
      return launch<T, 64>(q, k, v, acc, m, l, B, KH, G, S, kv_len, bc,
                           scale, st);
    case 128:
      return launch<T, 128>(q, k, v, acc, m, l, B, KH, G, S, kv_len, bc,
                            scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, void* acc, void* m,
                                     void* l, int B, int KH, int G, int S,
                                     int hd, int kv_len, int bc, float scale,
                                     void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, acc, m, l, B, KH, G, S, hd, kv_len,
                                 bc, scale, stream);
}

extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, void* acc, void* m,
                                    void* l, int B, int KH, int G, int S,
                                    int hd, int kv_len, int bc, float scale,
                                    void* stream) {
  return dispatch<float>(q, k, v, acc, m, l, B, KH, G, S, hd, kv_len, bc,
                         scale, stream);
}
