// Causal (or full) grouped-query flash attention, forward: two routes.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py:20 (_flash_kernel,
//   launched by flash_attention_kernel).
// Plain version: ops.flash_attention_torch.  q is (BK, G, S, hd), k and v
// are (BK, S, hd), the output is (BK, G, S, hd) in q's dtype; BK = batch x
// kv heads and G query heads share one kv head.  The scores are
// (q . k) x scale, scale = hd^-0.5 as the wrapper passes it.  Scores, the
// running (m, l) and the accumulator stay in float32; the output is
// acc / max(l, 1e-30), rounded once to q's dtype; a row with no live key
// gives 0, never NaN.
//
// What bounds it on Hopper: operations.  A causal pass does
// 2 x 2 x hd x S^2 / 2 flops per (BK, G) row: at the prefill shape of
// qwen2-1.5b (BK = 16, G = 6, S = 2048, hd = 128) that is 103 GFLOP
// against 151 MB of q, k, v and output, so the tensor cores' 989 TFLOP/s
// (0.104 ms) bound it, not the 3.35 TB/s of HBM (0.05 ms).
//
// Route "wgmma" (bf16, hd 64 and 128; flash_attention_wgmma_bf16): the
// tensor cores, fed by TMA, warp-specialised.
//   * One block of three warpgroups per (query tile of 128 rows, g, bk).
//     Warpgroup 0 is the producer: it drops to 24 registers and one of
//     its threads issues every TMA load.  Warpgroups 1 and 2 are the
//     consumers, 64 query rows each, raised to 240 registers.  The grid's
//     slowest axis walks the query tiles in reverse, so the long causal
//     tiles start first and do not form the tail.
//   * q, k and v are read through 3-D tensor maps, (hd, S, BK x G) and
//     (hd, S, BK), boxes of 64 columns (128 bytes, the swizzle span) x 128
//     rows with the 128-byte swizzle: rows past S come back as zeros from
//     within the same (bk, g) slice, so a ragged S reads no other slice.
//     The maps are encoded on the host by cuTensorMapEncodeTiled, found
//     through cudaGetDriverEntryPoint (no -lcuda), and passed as
//     __grid_constant__ parameters.
//   * Shared memory: the q tile (128 x hd bf16, loaded once) and a ring of
//     two stages of k and v tiles (128 keys each), one full and one empty
//     mbarrier per stage: 160 KB at hd 128, one block an SM.
//   * S = Q K^T: wgmma m64n128k16, bf16 x bf16 -> f32, A and B K-major
//     from swizzled shared memory, hd / 16 steps.
//   * The online softmax runs on the accumulator fragment in registers: a
//     row lives in the 4 threads of a quad, so its max and sum take two
//     __shfl_xor_sync.  exp2f with scale x log2(e) folded in.  The causal
//     and ragged-key masks (key > query, key >= S -> -inf) are applied
//     only to tiles that reach the diagonal or S; a row with no live key
//     yet uses 0 as its max.
//   * O += P V on the tensor cores with P split in two bf16 terms,
//     hi = bf16(p) and lo = bf16(p - hi): v is bf16 and exact and hi + lo
//     carries p to about 2^-17, so the product keeps the float32
//     probabilities' precision (one bf16 P is what SDPA does; it misses
//     the 1e-5 absolute tolerance near 0).  The fragments are the S
//     accumulator's own layout, converted in place (A from registers); v
//     is B, MN-major (the transpose bit).  The split doubles P V, so this
//     route's floor is 1.5x the function's bound (0.156 ms at the prefill
//     shape): the price of keeping the function.
//   * The epilogue divides by l and writes the rows < S from registers.
//
// Route "simt" (float32 at every head dim, and bf16 at hd 16 and 32;
// flash_attention_simt_bf16 / _f32): float32 FMA on the CUDA cores.  A
// float32 product on the tensor cores would be TF32, another function;
// hd 16 and 32 (the reduced configs) are below wgmma's 64-column boxes.
//   * one block of 256 threads per (query tile of 64 rows, g, bk); the
//     block computes its own offsets and masks the ragged edge;
//   * the q tile is staged once in shared memory as float32; each key tile
//     of 64 rows of k and v is staged per step; rows are padded to hd + 4
//     floats so the float4 reads of the score loop hit distinct banks;
//   * each thread owns a 4 x 4 block of scores (rows ty*4+i, keys tx+16j)
//     and a 4 x hd/16 block of the accumulator in registers;
//   * the scores overwrite the k tile as probabilities; one warp per 8 rows
//     does the online-softmax update of (m, l) and a per-row correction;
//   * causal: the loop over key tiles stops at the diagonal (the Pallas
//     kernel's block skip), and keys past the query or past S get -inf;
//     a row with no live key yet uses 0 as its max.
//   Two blocks fit on an SM at hd = 128 (99.6 KB of shared memory each).
//
// The wrapper (kernel.py: route) picks the route from dtype and hd before
// the launch; both count as launches of flash_attention.
#include <cuda.h>  // CUtensorMap and its enums: declarations only
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace simt {


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
flash_fwd_simt(const T* __restrict__ q, const T* __restrict__ k,
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
      flash_fwd_simt<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, G, BK);
  flash_fwd_simt<T, HD><<<grid, kThreads, smem, stream>>>(
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

}  // namespace simt

namespace wg {

constexpr int kBM = 128;        // query rows per block: 2 consumers x 64
constexpr int kBN = 128;        // keys per tile
constexpr int kStages = 2;      // k/v ring
constexpr int kThreads = 384;   // producer + two consumer warpgroups
constexpr int kBox = 64;        // columns per TMA box: 128 bytes of bf16
constexpr int kBoxBytes = kBox * 128 * 2;   // one 64-column x 128-row box
constexpr float kLog2e = 1.4426950408889634f;

template <int HD> struct Layout {
  static constexpr int kBoxes = HD / kBox;             // boxes per tile
  static constexpr int kTileBytes = kBoxes * kBoxBytes;   // 128 x HD bf16
  static constexpr int kQ = 0;                         // q tile
  static constexpr int kK = kTileBytes;                // stage s: k at
  static constexpr int kStage = 2 * kTileBytes;        //   kK + s*kStage,
  static constexpr int kBytes = kTileBytes + kStages * kStage;  // v after k
};

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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_u32(bar))
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

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of these registers across
// a wgmma issue or wait
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.  K-major tiles (q, k):
// 8-row groups 1024 bytes apart (SBO); the leading offset is unused.
// MN-major tiles (v as B of P V): SBO = 1024 bytes between groups of 8 keys,
// LBO = the distance between the 64-column boxes along hd.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// d (64 x 128, f32) [+]= A (64 x 16) . B^T, A and B K-major bf16 in swizzled
// shared memory; the accumulator is replaced when scale_d is 0
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, f32) += A (64 x 16, bf16 fragments in registers) . B, B
// MN-major bf16 in swizzled shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 fragments in registers) . B, B
// MN-major bf16 in swizzled shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x HD) += P (64 x 16) . V (16 x HD)
template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2],
                                         const uint32_t* a, uint64_t db) {
  if constexpr (HD == 128) {
    wgmma_rs_n128(d, a, db);
  } else {
    wgmma_rs_n64(d, a, db);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                __nv_bfloat16* __restrict__ o, int G, int S,
                float scale_log2, int causal) {
  using L = Layout<HD>;
  constexpr int NO = HD / 2;  // accumulator floats a thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, bar_full[kStages],
      bar_empty[kStages];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int tile = gridDim.z - 1 - blockIdx.z;  // longest tiles first
  const int g = blockIdx.x, bk = blockIdx.y;
  const int q0 = tile * kBM;
  const int kv_end = causal ? min(q0 + kBM, S) : S;
  const int n_kv = (kv_end + kBN - 1) / kBN;
  const int wgi = threadIdx.x / 128, tig = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar_full[s], 1);
      mbar_init(&bar_empty[s], 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tig == 0) {
      mbar_expect_tx(&bar_q, L::kTileBytes);
#pragma unroll
      for (int b = 0; b < L::kBoxes; ++b)
        tma_load_3d(smem + L::kQ + b * kBoxBytes, &qmap, &bar_q, b * kBox,
                    q0, bk * G + g);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&bar_empty[s], ((j / kStages) - 1) & 1);
        uint8_t* ks = smem + L::kK + s * L::kStage;
        uint8_t* vs = ks + L::kTileBytes;
        mbar_expect_tx(&bar_full[s], 2 * L::kTileBytes);
#pragma unroll
        for (int b = 0; b < L::kBoxes; ++b) {
          tma_load_3d(ks + b * kBoxBytes, &kmap, &bar_full[s], b * kBox,
                      j * kBN, bk);
          tma_load_3d(vs + b * kBoxBytes, &vmap, &bar_full[s], b * kBox,
                      j * kBN, bk);
        }
      }
    }
  } else {
    // consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63; a thread
    // holds rows r0 and r0 + 8, columns 8 n + 2 quad + {0, 1}
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wgi - 1;
    const int warp = tig / 32, lane = tig % 32, quad = lane % 4;
    const int row_lo = q0 + 64 * cw;
    const int r0 = row_lo + 16 * warp + lane / 4;
    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    // this consumer's 64 rows of each q box: 64 x 128 bytes in
    const uint32_t qaddr = smem_u32(smem + L::kQ) + cw * 64 * 128;
    mbar_wait(&bar_q, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % kStages;
      mbar_wait(&bar_full[s], (j / kStages) & 1);
      const uint32_t kaddr = smem_u32(smem + L::kK + s * L::kStage);
      const uint32_t vaddr = kaddr + L::kTileBytes;

      // S = Q K^T over hd in steps of 16 (32 bytes within a box)
      float sc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss_n128(sc, desc_sw128(qaddr + off, 16, 1024),
                      desc_sw128(kaddr + off, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // masks: only on a tile that reaches the diagonal or S
      const int k0 = j * kBN;
      if (k0 + kBN > S || (causal && k0 + kBN - 1 > row_lo)) {
#pragma unroll
        for (int n = 0; n < 16; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * n + 2 * quad + e;
            if (key >= S || (causal && key > r0)) sc[4 * n + e] = -INFINITY;
            if (key >= S || (causal && key > r0 + 8))
              sc[4 * n + 2 + e] = -INFINITY;
          }
      }

      // online softmax on the fragment: a row lives in one quad
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0 * scale_log2);
      const float mn1 = fmaxf(m1, mx1 * scale_log2);
      // no live key yet: 0 as the max, so exp2 gives 0, never NaN
      const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
      const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
      const float c0 = exp2f(m0 - mu0), c1 = exp2f(m1 - mu1);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * n + e] = exp2f(fmaf(sc[4 * n + e], scale_log2, -mu0));
          sc[4 * n + 2 + e] =
              exp2f(fmaf(sc[4 * n + 2 + e], scale_log2, -mu1));
          s0 += sc[4 * n + e];
          s1 += sc[4 * n + 2 + e];
        }
      l0 = l0 * c0 + s0;  // this thread's columns; the quad sums at the end
      l1 = l1 * c1 + s1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int n = 0; n < NO / 4; ++n) {
        acc[4 * n] *= c0;
        acc[4 * n + 1] *= c0;
        acc[4 * n + 2] *= c1;
        acc[4 * n + 3] *= c1;
      }

      // P in two bf16 terms, in the A-fragment layout of m64k16: the four
      // registers of key step kk are sc[8 kk .. 8 kk + 7] in pairs
      uint32_t ph[32], pl[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(sc[2 * i],
                                                       sc[2 * i + 1]);
        const float2 hf = __bfloat1622float2(h);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            sc[2 * i] - hf.x, sc[2 * i + 1] - hf.y);
        ph[i] = *reinterpret_cast<const uint32_t*>(&h);
        pl[i] = *reinterpret_cast<const uint32_t*>(&lo);
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)  // 16 keys = 2048 bytes of v
        wgmma_pv<HD>(acc, ph + 4 * kk,
                     desc_sw128(vaddr + kk * 2048, kBoxBytes, 1024));
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_pv<HD>(acc, pl + 4 * kk,
                     desc_sw128(vaddr + kk * 2048, kBoxBytes, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      mbar_arrive(&bar_empty[s]);
    }

    // epilogue: acc / max(l, 1e-30), rounded once, rows < S
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* orow = o + ((size_t)bk * G + g) * (size_t)S * HD;
#pragma unroll
    for (int n = 0; n < NO / 4; ++n) {
      const int col = 8 * n + 2 * quad;
      if (r0 < S)
        *reinterpret_cast<__nv_bfloat162*>(orow + (size_t)r0 * HD + col) =
            __floats2bfloat162_rn(acc[4 * n] / d0, acc[4 * n + 1] / d0);
      if (r0 + 8 < S)
        *reinterpret_cast<__nv_bfloat162*>(orow + (size_t)(r0 + 8) * HD +
                                           col) =
            __floats2bfloat162_rn(acc[4 * n + 2] / d1, acc[4 * n + 3] / d1);
    }
  }
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

// a bf16 tensor (depth, S, hd) as a 3-D map (hd, S, depth): boxes of 64
// columns x 128 rows x 1, 128-byte swizzle, rows past S read as zeros
int make_map(CUtensorMap* map, const void* base, int hd, int S, int depth) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)S,
                              (cuuint64_t)depth};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)S * (cuuint64_t)hd * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kBox, (cuuint32_t)kBM, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int BK,
           int G, int S, int causal, float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int err = make_map(&qm, q, HD, S, BK * G);
  if (err == 0) err = make_map(&km, k, HD, S, BK);
  if (err == 0) err = make_map(&vm, v, HD, S, BK);
  if (err != 0) return err;
  const size_t smem = Layout<HD>::kBytes + 1024;  // + alignment slack
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(G, BK, (S + kBM - 1) / kBM);
  flash_fwd_wgmma<HD><<<grid, kThreads, smem, stream>>>(
      qm, km, vm, (__nv_bfloat16*)o, G, S, scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

}  // namespace wg

extern "C" int flash_attention_wgmma_bf16(const void* q, const void* k,
                                          const void* v, void* o, int BK,
                                          int G, int S, int hd, int causal,
                                          float scale, void* stream) {
  if (BK <= 0 || G <= 0 || S <= 0 || BK > 65535 ||
      (S + wg::kBM - 1) / wg::kBM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 64: return wg::launch<64>(q, k, v, o, BK, G, S, causal, scale, st);
    case 128: return wg::launch<128>(q, k, v, o, BK, G, S, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_simt_bf16(const void* q, const void* k,
                                         const void* v, void* o, int BK,
                                         int G, int S, int hd, int causal,
                                         float scale, void* stream) {
  return simt::dispatch<__nv_bfloat16>(q, k, v, o, BK, G, S, hd, causal,
                                       scale, stream);
}

extern "C" int flash_attention_simt_f32(const void* q, const void* k,
                                        const void* v, void* o, int BK,
                                        int G, int S, int hd, int causal,
                                        float scale, void* stream) {
  return simt::dispatch<float>(q, k, v, o, BK, G, S, hd, causal, scale,
                               stream);
}
