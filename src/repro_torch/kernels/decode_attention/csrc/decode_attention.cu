// Flash-decoding: one query token's attention over a KV cache, both phases
// in one launch.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention/kernel.py:19 (_decode_kernel,
//   launched by decode_attention_partials)
// and the jnp log-sum-exp combine of its phase 2,
//   src/repro/kernels/decode_attention/ops.py:16-27.
// Plain version: ops.decode_attention_torch (the whole function).
//
// Layout: q is (B, KH, G, hd); k and v are the model's KV cache,
// (B, S, KH, hd), read in place with a key stride of KH x hd (no copy, no
// transpose); only keys j < kv_len count.  The output is (B, KH, G, hd) in
// q's dtype: softmax((q . k) x scale) . v over the live keys, in float32,
// rounded once.
//
// What bounds it on Hopper: bytes.  Each live key and value row is read
// once (2 x kv_len x hd x 2 B per (b, kv head) in bf16) for 4 x G x hd
// flops per key: at qwen2-1.5b's decode shape (B*KH = 16, G = 6, hd = 128,
// kv_len 2049) 16.8 MB, 5 us at 3.35 TB/s.  G = 6 rows are too few for
// the tensor cores, so it runs on the CUDA cores and spends its design on
// keeping enough bytes in flight.
//
// Design:
//   * grid (nsplit, B*KH): split s of (b, kv head) takes keys
//     [s*kps, min((s+1)*kps, kv_len)); the wrapper's planner
//     (kernel.py: plan_splits) picks nsplit from kv_len and the SM count
//     (about 2 blocks an SM, at least 64 keys a split, no empty split);
//   * the split's key and value rows stream into a ring of 4 chunks of
//     8 KB each (32 keys at hd 128 in bf16) in shared memory: one TMA box
//     of a 3-D tensor map (hd, KH, B x S) brings a chunk's k rows of one
//     kv head, another its v rows, completion on one mbarrier a chunk.  A
//     block asks for its first 64 KB at once, so the bytes in flight, not
//     the threads, cover HBM's latency; a thread refills a chunk as soon
//     as every warp is done with it.  The maps are encoded on the host by
//     cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint (no
//     -lcuda);
//   * one pass, online softmax: a group of L lanes owns one key row at a
//     time, each lane 16 bytes of it (bf16 at hd 128: 16 lanes x 8), and
//     dots it against all G query rows it keeps in registers (float32),
//     reduced by shuffles within the group; scores in log2 units
//     (scale x log2(e)); a group takes 4 rows of a chunk before each
//     rescale and keeps its own (m, l, acc) for the G heads;
//   * the groups of a warp merge by shuffles, the warps in shared memory
//     (the ring, now free), in a fixed order;
//   * fused combine: with one split the block writes the output.  Else
//     each block writes its split's (m, l, acc) to a float32 workspace
//     (B*KH, nsplit, G, hd + 4), fences, and takes a ticket on its (b, kv
//     head)'s counter; the last block resets the counter to 0, weighs
//     the splits by exp2(m_s - max m) (once per split and head), brings
//     the records into shared memory by bulk copies (as many splits a
//     copy as the ring holds), sums them in split order and writes the
//     output.  No float atomics: the same inputs give the same
//     bits.  The counters (one int32 per b*KH, zero at rest) belong to the
//     wrapper; two calls running at once on two streams must not share
//     them (the port runs on one stream).
// At G <= 6 three blocks fit an SM (64 KB of ring, <= 168 registers).
#include <cuda.h>  // CUtensorMap and its enums: declarations only
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;          // chunks of the ring
constexpr int kChunkBytes = 8192;   // of k (and as many of v) a chunk
constexpr int kRingBytes = kStages * 2 * kChunkBytes;
constexpr int kMaxSplits = 256;
constexpr float kLog2e = 1.4426950408889634f;

// 16 bytes of T as float32
template <typename T> struct Row;
template <> struct Row<__nv_bfloat16> {
  static constexpr int E = 8;
  static constexpr CUtensorMapDataType kType =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Row<float> {
  static constexpr int E = 4;
  static constexpr CUtensorMapDataType kType =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

__device__ __forceinline__ float from_f(float x, float*) { return x; }
__device__ __forceinline__ __nv_bfloat16 from_f(float x, __nv_bfloat16*) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 3-D tensor map into shared memory, completion on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// bytes (a multiple of 16) from global to shared memory, completion on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// (m, l, acc) of b merged into a; m in log2 units, -inf when empty
template <int E>
__device__ __forceinline__ void merge(float& m, float& l, float* acc,
                                      float mb, float lb, const float* accb) {
  const float mn = fmaxf(m, mb);
  const float mu = mn == -INFINITY ? 0.f : mn;
  const float ca = exp2f(m - mu), cb = exp2f(mb - mu);
  l = l * ca + lb * cb;
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = acc[e] * ca + accb[e] * cb;
  m = mn;
}

// a split's record in the workspace and in shared memory: m, l, two floats
// of padding, acc[HD] (16-byte multiples, for the bulk copies)
template <int HD> __host__ __device__ constexpr int rec_floats() {
  return HD + 4;
}

// The last block's merge of the nsplit records of its (b, kv head), wsb,
// in split order.  The weights exp2(m_s - max m) and the denominator are
// computed once per (split, g) from the records' m and l; the records'
// acc rows come into shared memory by bulk copies (as many splits a copy
// as the ring holds, beside the weights), and thread tid sums column tid
// of every g.  Not inlined: it keeps its registers out of the main loop's
// allocation.
template <typename T, int HD, int GM>
__device__ __noinline__ void combine_splits(const float* wsb, T* out,
                                            uint8_t* smem, uint64_t* comb,
                                            int G, int nsplit) {
  constexpr int RF = rec_floats<HD>();
  static_assert(HD <= kThreads, "a column a thread");
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split_bytes = G * RF * (int)sizeof(float);
  // the ring's end: w[g][s], then l[g][s], then den[g]
  const int wbytes =
      ((2 * G * nsplit + G) * (int)sizeof(float) + 127) / 128 * 128;
  float* w = reinterpret_cast<float*>(smem + kRingBytes - wbytes);
  float* lw = w + G * nsplit;
  float* den = lw + G * nsplit;
  const int per = (kRingBytes - wbytes) / split_bytes;  // splits a copy
  const float* recs = reinterpret_cast<const float*>(smem);
  // the other blocks' records were written by plain stores: order them
  // before the bulk copies that read them
  asm volatile("fence.proxy.async;\n" ::: "memory");
  if (tid == 0) {
    mbar_expect_tx(comb, min(per, nsplit) * split_bytes);
    bulk_load(smem, wsb, min(per, nsplit) * split_bytes, comb);
  }
  for (int p = tid; p < G * nsplit; p += kThreads) {  // record p = (s, g)
    const int s = p / G, g = p % G;
    w[g * nsplit + s] = __ldcg(wsb + (size_t)p * RF);
    lw[g * nsplit + s] = __ldcg(wsb + (size_t)p * RF + 1);
  }
  __syncthreads();
  for (int g = warp; g < G; g += kWarps) {  // a warp a g
    float* wg = w + g * nsplit;
    float mx = -INFINITY;
    for (int s = lane; s < nsplit; s += 32) mx = fmaxf(mx, wg[s]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    for (int s = lane; s < nsplit; s += 32) wg[s] = exp2f(wg[s] - mx);
    __syncwarp();
    if (lane == 0) {
      float dn = 0.f;
      for (int s = 0; s < nsplit; ++s) dn = fmaf(wg[s], lw[g * nsplit + s], dn);
      den[g] = fmaxf(dn, 1e-30f);
    }
  }
  __syncthreads();
  float num[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) num[g] = 0.f;
  for (int s0 = 0, phase = 0; s0 < nsplit; s0 += per, phase ^= 1) {
    const int ns = min(per, nsplit - s0);
    if (s0 > 0) {
      __syncthreads();  // the previous group is consumed
      if (tid == 0) {
        mbar_expect_tx(comb, ns * split_bytes);
        bulk_load(smem, wsb + (size_t)s0 * G * RF, ns * split_bytes, comb);
      }
    }
    mbar_wait(comb, phase);
    if (tid < HD) {
      for (int s = 0; s < ns; ++s) {
#pragma unroll
        for (int g = 0; g < GM; ++g)
          if (g < G)
            num[g] = fmaf(w[g * nsplit + s0 + s],
                          recs[(s * G + g) * RF + 4 + tid], num[g]);
      }
    }
  }
  if (tid < HD) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G) out[g * HD + tid] = from_f(num[g] / den[g], (T*)nullptr);
  }
}

template <typename T, int HD, int GM>
__global__ void __launch_bounds__(kThreads, GM <= 6 ? 3 : 2)
decode_fused(const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             const T* __restrict__ q, T* __restrict__ out,
             float* __restrict__ ws, int* __restrict__ counters, int KH,
             int G, int S, int kv_len, int nsplit, int kps,
             float scale_log2) {
  constexpr int E = Row<T>::E;   // elements a lane reads from a row
  constexpr int L = HD / E;      // lanes a key row
  constexpr int KPW = 32 / L;    // key rows a warp step
  constexpr int STEP = kWarps * KPW;  // key rows a block step
  constexpr int RB = HD * (int)sizeof(T);  // bytes a row
  constexpr int CK = kChunkBytes / RB;     // rows a chunk
  constexpr int U = CK / STEP;             // rows a group takes a chunk
  constexpr int RF = rec_floats<HD>();
  static_assert(L >= 1 && L <= 32 && 32 % L == 0, "lanes per row");
  static_assert(U * STEP == CK && CK <= 256, "a chunk is whole steps");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], comb;
  __shared__ int last;
  // TMA writes to 128-byte aligned shared memory
  uint8_t* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / L, sub = lane % L;
  const int split = blockIdx.x, bk = blockIdx.y;
  const int b = bk / KH, h = bk % KH;
  const int j0 = split * kps, n = min(kv_len, j0 + kps) - j0;
  const int nchunks = (n + CK - 1) / CK;

  // chunk c: rows j0 + c*CK .. + CK - 1 of kv head h (rows past the split
  // are read and not used; rows past B x S read as zeros)
  const CUtensorMap *kp = &kmap, *vp = &vmap;
  auto issue = [&](int c) {
    const int st = c % kStages;
    uint8_t* ks = smem + st * 2 * kChunkBytes;
    mbar_expect_tx(&full[st], 2 * kChunkBytes);
    tma_load_3d(ks, kp, &full[st], 0, h, b * S + j0 + c * CK);
    tma_load_3d(ks + kChunkBytes, vp, &full[st], 0, h, b * S + j0 + c * CK);
  };
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) mbar_init(&full[st], 1);
    mbar_init(&comb, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < min(kStages, nchunks); ++c) issue(c);
  }

  float qf[GM][E];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          q + ((size_t)bk * G + g) * HD + sub * E);
      Row<T>::unpack(u, qf[g]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qf[g][e] = 0.f;
    }
  }
  float m[GM], l[GM], acc[GM][E];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }
  __syncthreads();  // the barriers are initialised

  for (int c = 0; c < nchunks; ++c) {
    const int st = c % kStages, rows = min(CK, n - c * CK);
    mbar_wait(&full[st], (c / kStages) & 1);
    const uint8_t* ks = smem + st * 2 * kChunkBytes + sub * 16;
    const uint8_t* vs = ks + kChunkBytes;
    // this group's U rows of the chunk; a row past the split scores -inf
    // (every lane reaches every shuffle)
    const int r0 = warp * KPW + grp;
    float s[U][GM];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * STEP;
      float kf[E];
      Row<T>::unpack(*reinterpret_cast<const uint4*>(ks + r * RB), kf);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qf[g][e], kf[e], d);
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        // (q . k) x scale, in log2 units
        s[u][g] = r < rows ? d * scale_log2 : -INFINITY;
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, s[u][g]);
      const float mn = fmaxf(m[g], mx);
      const float mu = mn == -INFINITY ? 0.f : mn;
      const float cr = exp2f(m[g] - mu);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u][g] = exp2f(s[u][g] - mu);
        psum += s[u][g];
      }
      l[g] = l[g] * cr + psum;
      m[g] = mn;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= cr;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r0 + u * STEP >= rows) break;  // a value row past the split is
      float vf[E];                       // never read, whatever it holds
      Row<T>::unpack(
          *reinterpret_cast<const uint4*>(vs + (r0 + u * STEP) * RB), vf);
#pragma unroll
      for (int g = 0; g < GM; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[g][e] = fmaf(s[u][g], vf[e], acc[g][e]);
    }
    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && c + kStages < nchunks) issue(c + kStages);
  }

  // merge the warp's groups (lanes sub, sub + L, ...) by shuffles
#pragma unroll
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float accb[E];
#pragma unroll
      for (int e = 0; e < E; ++e)
        accb[e] = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
      const float mb = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lb = __shfl_xor_sync(0xffffffffu, l[g], off);
      merge<E>(m[g], l[g], acc[g], mb, lb, accb);
    }
  }
  // the ring is free (every chunk was waited for): the warps' records
  float* red = reinterpret_cast<float*>(smem);  // [warp][g][RF]
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float* rec = red + (warp * GM + g) * RF;
#pragma unroll
      for (int e = 0; e < E; ++e) rec[4 + sub * E + e] = acc[g][e];
      if (sub == 0) {
        rec[0] = m[g];
        rec[1] = l[g];
      }
    }
  }
  __syncthreads();

  // the block's split: warps merged in order, one (g, d) a thread
  for (int p = tid; p < G * HD; p += kThreads) {
    const int g = p / HD, d = p % HD;
    const float* r0 = red + g * RF;
    float mw = r0[0], lw = r0[1], aw = r0[4 + d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float* rw = red + (w * GM + g) * RF;
      merge<1>(mw, lw, &aw, rw[0], rw[1], rw + 4 + d);
    }
    if (nsplit == 1) {
      out[((size_t)bk * G + g) * HD + d] =
          from_f(aw / fmaxf(lw, 1e-30f), (T*)nullptr);
    } else {
      float* rec = ws + (((size_t)bk * nsplit + split) * G + g) * RF;
      rec[4 + d] = aw;
      if (d == 0) {
        rec[0] = mw;
        rec[1] = lw;
        rec[2] = rec[3] = 0.f;
      }
    }
  }
  if (nsplit == 1) return;

  // the last block of this (b, kv head) combines the splits
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(&counters[bk], 1);
    last = ticket == nsplit - 1;
    if (last) counters[bk] = 0;  // every split has arrived: at rest again
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  combine_splits<T, HD, GM>(ws + (size_t)bk * nsplit * G * RF,
                            out + (size_t)bk * G * HD, smem, &comb, G,
                            nsplit);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (so the
// library needs no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the cache (B, S, KH, hd) as a 3-D map (hd, KH, B x S): a box is `rows`
// consecutive keys of one kv head, no swizzle
template <typename T>
int make_map(CUtensorMap* map, const void* base, int hd, int KH, int BS,
             int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)KH, (cuuint64_t)BS};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * sizeof(T),
                                 (cuuint64_t)KH * hd * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)hd, 1, (cuuint32_t)rows};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, Row<T>::kType, 3, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T, int HD, int GM>
int launch(const void* q, const void* k, const void* v, void* out, void* ws,
           void* counters, int B, int KH, int G, int S, int kv_len,
           int nsplit, int kps, float scale, cudaStream_t stream) {
  constexpr int smem = kRingBytes + 128;  // + alignment slack
  const cudaError_t e = cudaFuncSetAttribute(
      decode_fused<T, HD, GM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap km, vm;
  const int rows = kChunkBytes / (HD * (int)sizeof(T));
  int err = make_map<T>(&km, k, HD, KH, B * S, rows);
  if (err == 0) err = make_map<T>(&vm, v, HD, KH, B * S, rows);
  if (err != 0) return err;
  const dim3 grid(nsplit, B * KH);
  decode_fused<T, HD, GM><<<grid, kThreads, smem, stream>>>(
      km, vm, (const T*)q, (T*)out, (float*)ws, (int*)counters, KH, G, S,
      kv_len, nsplit, kps, scale * kLog2e);
  return (int)cudaGetLastError();
}

// G is rounded up to a register bucket: 1, 2, 4, 6 or 8
template <typename T, int HD>
int by_g(const void* q, const void* k, const void* v, void* out, void* ws,
         void* counters, int B, int KH, int G, int S, int kv_len, int nsplit,
         int kps, float scale, cudaStream_t st) {
#define DECODE_G(GM)                                                      \
  if (G <= GM)                                                            \
    return launch<T, HD, GM>(q, k, v, out, ws, counters, B, KH, G, S,     \
                             kv_len, nsplit, kps, scale, st);
  DECODE_G(1)
  DECODE_G(2)
  DECODE_G(4)
  DECODE_G(6)
  DECODE_G(8)
#undef DECODE_G
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             void* ws, void* counters, int B, int KH, int G, int S, int hd,
             int kv_len, int nsplit, int kps, float scale, void* stream) {
  if (B <= 0 || KH <= 0 || G <= 0 || G > 8 || S <= 0 || kv_len < 1 ||
      kv_len > S || B * KH > 65535 || (long long)B * S > 2147483647LL ||
      nsplit < 1 || nsplit > kMaxSplits || kps < 1 ||
      (long long)(nsplit - 1) * kps >= kv_len ||
      (long long)nsplit * kps < kv_len)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16:
      return by_g<T, 16>(q, k, v, out, ws, counters, B, KH, G, S, kv_len,
                         nsplit, kps, scale, st);
    case 32:
      return by_g<T, 32>(q, k, v, out, ws, counters, B, KH, G, S, kv_len,
                         nsplit, kps, scale, st);
    case 64:
      return by_g<T, 64>(q, k, v, out, ws, counters, B, KH, G, S, kv_len,
                         nsplit, kps, scale, st);
    case 128:
      return by_g<T, 128>(q, k, v, out, ws, counters, B, KH, G, S, kv_len,
                          nsplit, kps, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, void* out, void* ws,
                                     void* counters, int B, int KH, int G,
                                     int S, int hd, int kv_len, int nsplit,
                                     int kps, float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, ws, counters, B, KH, G, S, hd,
                                 kv_len, nsplit, kps, scale, stream);
}

extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, void* out, void* ws,
                                    void* counters, int B, int KH, int G,
                                    int S, int hd, int kv_len, int nsplit,
                                    int kps, float scale, void* stream) {
  return dispatch<float>(q, k, v, out, ws, counters, B, KH, G, S, hd, kv_len,
                         nsplit, kps, scale, stream);
}
