// Stabilized causal mLSTM sequence mix (xLSTM's matrix memory, parallel
// form), forward: two routes.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/mlstm_attention/kernel.py:26 (_mlstm_kernel,
//   launched by mlstm_attention_kernel).
// Plain version: ops.mlstm_attention_torch.  q, k, v are (B, S, H, hd) in
// the model's layout (the Pallas kernel's (BH, S, hd) is the case H = 1),
// k already scaled by hd^-0.5; F (the inclusive cumulative log-forget) and
// I (the log input gate) are (B, S, H) float32; the output is (B, S, H,
// hd) in q's dtype.  For each query t of each (b, h):
//
//   D_ts = F_t - F_s + I_s  (s <= t),   m_t = max(max_{s<=t} D_ts, -1e30)
//   h_t  = sum_s exp(D_ts - m_t) (q_t . k_s) v_s
//          / max(|sum_s exp(D_ts - m_t) (q_t . k_s)|, exp(-m_t))
//
// All arithmetic is float32; the output is rounded once.  Where
// exp(-m_t) overflows (m_t below about -88) the output is 0, as in the
// reference.
//
// What bounds it on Hopper: operations.  Two chained products of
// 2 x hd x S (S + 1) / 2 multiply-adds per (b, h): at xlstm-125m's prefill
// (B 8, H 4, S 2048, hd 384, bf16) that is 1.03e11 flops against 0.20 GB
// of q, k, v, F, I and output, so the tensor cores' 989 TFLOP/s
// (0.104 ms) bound it, not the 3.35 TB/s of HBM (0.060 ms).
//
// Route "wgmma" (bf16 at hd 128, 256 and 384; mlstm_attention_wgmma_bf16):
// the tensor cores, fed by TMA, warp-specialised.
//   * One block of three warpgroups per ((b, h), query tile of 64 rows);
//     the grid's y walks the tiles from the last, so the long causal tiles
//     start first.  Warpgroup 0 is the producer: it drops to 24 registers
//     and one of its threads issues every TMA load.  Warpgroups 1 and 2
//     are the consumers, raised to 240 registers; both own all 64 query
//     rows.  A (64, 384) float32 accumulator in one warpgroup would be 192
//     registers a thread, so consumer c owns output columns
//     [c hd/2, (c + 1) hd/2): O += P V as wgmma m64n(hd/2)k16, 96
//     accumulator registers at hd 384.
//   * The stabilizer needs no score: m_t depends on F and I alone.  A
//     prologue computes each row's exact m_t = max((F_t - F_s) + I_s) over
//     s <= t (F and I staged in shared memory, then four threads a row, a
//     subtract, an add and a max per key, the plain version's own order of
//     operations) while the first tiles load.  So W = exp(D - m) <= 1 from the first key tile on, the
//     accumulator is never rescaled (no online max as in flash), and the
//     two consumers share nothing but P and, at the end, the row sums.
//   * q, k and v are read in place through 4-D tensor maps (hd, H, S, B),
//     boxes of 64 columns (128 bytes, the swizzle span) x 1 head x 64 rows
//     x 1 with the 128-byte swizzle: rows past S come back as zeros from
//     within the same (b, h), so a ragged S reads no other slice.  hd 384
//     is six boxes.  The maps are encoded on the host by
//     cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint (no
//     -lcuda), and passed as __grid_constant__ parameters.  F and I of a
//     key tile (8 floats each a thread) are read from global memory by the
//     consumers before they wait for the tile.
//   * Shared memory at hd 384 (227 KB a block): the q tile, 64 x 384 bf16
//     = 48 KB, loaded once; k in one stage of 64 keys (48 KB), v in two
//     (2 x 48 KB), each stage on its own full/empty mbarrier pair; P as
//     three bf16 terms of 64 x 64 (24 KB).  216 KB in all: two stages of k
//     and v together would be 240.  k of tile j + 1 loads during tile j's
//     P V, v of tile j + 1 during all of tile j.
//   * Scores: consumer c computes S for its half of the key tile, keys
//     [32 c, 32 c + 32), as wgmma m64n32k16 over hd / 16 steps, A (q) and B
//     (k) K-major from swizzled shared memory; Q K^T is done once, not by
//     both consumers.
//   * Weighting: p = s x exp(D - m), with D = (F_t - F_s) + I_s and W = 0
//     for s > t and in rows past S (only the diagonal tile masks anything;
//     key tile 0 gives every row a live key).  The signed row sum is taken
//     from the float32 p, in registers.
//   * P in three bf16 terms: t1 = bf16(p), t2 = bf16(p - t1), t3 = bf16(p -
//     t1 - t2), which carry p to about 2^-24 (v is bf16 and exact).  Two
//     terms (flash's hi and lo, about 2^-16) are not enough here: p is
//     signed and the denominator |sum p| can be small, so outputs near 0
//     miss the card's tolerance (atol 1e-5) at S 2047-2048; the CPU
//     emulation in tests/test_torch_mlstm_attention.py shows it.  The
//     terms go into the 128-byte-swizzled P tiles; a proxy fence and a
//     named barrier across the two consumers only (bar.sync 1, 256; one
//     more before the writes, so that neither overwrites P the other still
//     reads), and both read the full P (64 x 64) as wgmma's A from shared
//     memory: 4 key steps a term, B = v MN-major (the transpose bit).  The
//     three P V products put this route's floor at 2x the function's bound
//     (0.208 ms at the prefill shape), the price of keeping the function.
//   * Epilogue: the row sums are reduced over a quad by shuffles, the two
//     consumers' halves added through shared memory (consumer 0's first),
//     and acc / max(|sum|, exp(-m)) written in bf16 from registers, rows < S.
//   * hd 64 would give each consumer 32 output columns inside one 64-column
//     box; it and hd 16 / 32 (below the box) stay on the simt route.
//
// Route "simt" (float32 at every head dim, and bf16 at hd 16, 32 and 64;
// mlstm_attention_simt_bf16 / _f32): float32 FMA on the CUDA cores, at
// best the 67 TFLOP/s float32 rate.  A float32 product on the tensor cores
// would be TF32, another function.
//   * one block of 256 threads (16 x 16) per ((b, h), query tile of 64
//     rows), tiles launched from the last; any S (the ragged tile is
//     masked, where the Pallas kernel asserts S % bq == 0);
//   * the (64, hd) float32 accumulator lives in registers, 4 rows x hd/16
//     columns a thread, and the key tile is 32 rows, so the q tile (64 x
//     (hd + 4) floats), the k tile (32 x (hd + 4)) and the v tile (32 x
//     hd) take 198 KB of shared memory at hd = 384 (one block an SM);
//   * each thread owns a 4 x 2 block of the (64, 32) score tile (rows
//     ty*4+i, keys tx+16j); the 16 threads of a row are 16 lanes of one
//     warp, so the row's tile max and signed score sum are shuffle
//     reductions, and every one of the 16 keeps the row's running (m, sum)
//     in registers (an online stabilizer, rescaled per key tile);
//   * masking sets W to 0 for s > t and for keys past S; m starts at -1e30
//     (the reference's floor), so it stays finite;
//   * the key loop stops at the diagonal (the Pallas kernel's causal block
//     skip); the weighted scores overwrite the k tile's space, and the
//     accumulator update reads them back from shared memory.
//
// The wrapper (kernel.py: route) picks the route from dtype and hd before
// the launch; both count as launches of mlstm_attention.  Ablation builds
// (python -m repro_torch.kernels.ablation stages) compile this source with
// -DMLSTM_CUT=1 (Q K^T only) or 2 (no P V), whose outputs are wrong, or
// with -DMLSTM_WAITS (clock cycles in each kind of mbarrier wait, in the
// prologue and in the consumers' whole run);
// the library the port loads defines none of them.
#include <cuda.h>  // CUtensorMap and its enums: declarations only
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace simt {

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

}  // namespace simt

namespace wg {

constexpr int kBM = 64;        // query rows a block (both consumers)
constexpr int kBN = 64;        // keys a tile: 32 a consumer for the scores
constexpr int kVStages = 2;    // v ring; k has one stage
constexpr int kTerms = 3;      // bf16 terms of P
constexpr int kThreads = 384;  // producer + two consumer warpgroups
constexpr int kPBytes = kBM * kBN * 2;    // one bf16 term of P
constexpr float kFloor = -1e30f;

template <int HD> struct Layout {
  static constexpr int kBoxes = HD / kBox;            // boxes a tile
  static constexpr int kTile = kBoxes * kBoxBytes;    // 64 rows x HD bf16
  static constexpr int kQ = 0;                        // the q tile
  static constexpr int kK = kTile;                    // the k tile
  static constexpr int kV = kK + kTile;               // v stage s at + s kTile
  static constexpr int kP = kV + kVStages * kTile;    // term i at + i kPBytes
  static constexpr int kBytes = kP + kTerms * kPBytes;
};
static_assert(Layout<384>::kBytes == 221184, "216 KB at hd 384");
// keys whose (F, I) the prologue stages at a time, as float2 in the P tiles
constexpr int kStaged = kTerms * kPBytes / 8;

#ifdef MLSTM_WAITS
// ablation build only: clock cycles summed over one thread a warpgroup,
// by kind: 0 consumers waiting for k, 1 for v, 2 the producer waiting for
// a free k stage, 3 for a free v stage, 4 the consumers' whole run, 5
// their prologue (the stabilizer)
__device__ unsigned long long g_waits[6];
__device__ __forceinline__ void add_cycles(int kind, long long t0,
                                           bool count) {
  if (count) atomicAdd(&g_waits[kind], (unsigned long long)(clock64() - t0));
}
#else
__device__ __forceinline__ void add_cycles(int, long long, bool) {}
#endif
__device__ __forceinline__ long long cycles() {
#ifdef MLSTM_WAITS
  return clock64();
#else
  return 0;
#endif
}
__device__ __forceinline__ void timed_wait(int kind, uint64_t* bar,
                                           uint32_t parity, bool count) {
  const long long t0 = cycles();
  mbar_wait(bar, parity);
  add_cycles(kind, t0, count);
}

#ifndef MLSTM_CUT
#define MLSTM_CUT 0  // ablation builds: 1 = Q K^T only, 2 = no P V
#endif

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
mlstm_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const float* __restrict__ Fc, const float* __restrict__ Ig,
                __nv_bfloat16* __restrict__ o, int S, int H) {
  using L = Layout<HD>;
  constexpr int NO = HD / 4;  // accumulator floats a thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, bar_kfull, bar_kempty,
      bar_vfull[kVStages], bar_vempty[kVStages];
  __shared__ float m_row[kBM];        // each row's stabilizer
  __shared__ float l_half[2][kBM];    // each consumer's signed row sums
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int tile = gridDim.y - 1 - blockIdx.y;  // longest tiles first
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = tile * kBM;
  const int n_kv = (min(q0 + kBM, S) + kBN - 1) / kBN;
  const int wgi = threadIdx.x / 128, tig = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
    mbar_init(&bar_kfull, 1);
    mbar_init(&bar_kempty, 256);  // every consumer thread
#pragma unroll
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(&bar_vfull[s], 1);
      mbar_init(&bar_vempty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tig == 0) {
      mbar_expect_tx(&bar_q, L::kTile);
#pragma unroll
      for (int x = 0; x < L::kBoxes; ++x)
        tma_load_4d(smem + L::kQ + x * kBoxBytes, &qmap, &bar_q, x * kBox,
                    h, q0, b);
      for (int j = 0; j < n_kv; ++j) {
        // k of tile j once Q K^T of tile j - 1 is done; v of tile j once
        // P V of tile j - 2 is done
        if (j >= 1) timed_wait(2, &bar_kempty, (j - 1) & 1, true);
        mbar_expect_tx(&bar_kfull, L::kTile);
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load_4d(smem + L::kK + x * kBoxBytes, &kmap, &bar_kfull,
                      x * kBox, h, j * kBN, b);
        const int s = j % kVStages;
        if (j >= kVStages)
          timed_wait(3, &bar_vempty[s], ((j / kVStages) - 1) & 1, true);
        uint8_t* vs = smem + L::kV + s * L::kTile;
        mbar_expect_tx(&bar_vfull[s], L::kTile);
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load_4d(vs + x * kBoxBytes, &vmap, &bar_vfull[s], x * kBox, h,
                      j * kBN, b);
      }
    }
  } else {
    // consumers: warpgroup cw computes the scores of keys 32 cw .. + 31 of
    // each tile and owns output columns cw HD/2 .. + HD/2 - 1; a thread
    // holds rows rl and rl + 8 of the tile, columns 8 n + 2 quad + {0, 1}
    // of each fragment
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const long long start = cycles();
    const int cw = wgi - 1, ct = threadIdx.x - 128;
    const int warp = tig / 32, lane = tig % 32, quad = lane % 4;
    const int rl = 16 * warp + lane / 4;
    const int t0 = q0 + rl, t1 = t0 + 8;
    // the last live key of each row: t, or none for a row past S
    const int last0 = t0 < S ? t0 : -1, last1 = t1 < S ? t1 : -1;
    const size_t gbase = (size_t)b * S * H + h;  // F, I of (b, 0, h)

    // prologue: m_t = max(-1e30, max_{s <= t} (F_t - F_s) + I_s), while
    // the producer's first loads land.  (F_s, I_s) of the keys this tile
    // reads are staged as float2 in the P tiles (not written before the
    // first P), kStaged keys at a time; four threads a row take the max
    // over their keys
    {
      const int kv_end = min(q0 + kBM, S);
      const int row = ct >> 2, part = ct & 3, t = q0 + row;
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
    }
    consumers_sync();
    add_cycles(5, start, tig == 0);
    const float m0 = m_row[rl], m1 = m_row[rl + 8];
    const float f0 = t0 < S ? Fc[gbase + (size_t)t0 * H] : 0.f;
    const float f1 = t1 < S ? Fc[gbase + (size_t)t1 * H] : 0.f;

    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    float l0 = 0.f, l1 = 0.f;  // this thread's columns; summed at the end
    const uint32_t qaddr = smem_u32(smem + L::kQ);
    // this consumer's 32 rows of each k box, its HD/2 columns of v
    const uint32_t kaddr = smem_u32(smem + L::kK) + cw * 32 * 128;
    const uint32_t vbase = smem_u32(smem + L::kV) + cw * (HD / 128) * kBoxBytes;
    uint8_t* pt = smem + L::kP;
    mbar_wait(&bar_q, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % kVStages;
      const int k0 = j * kBN + 32 * cw + 2 * quad;  // + 8 n + e
      float fk[8], ik[8];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * n + e;
          const size_t g = gbase + (size_t)key * H;
          fk[2 * n + e] = key < S ? Fc[g] : 0.f;
          ik[2 * n + e] = key < S ? Ig[g] : 0.f;
        }
      timed_wait(0, &bar_kfull, j & 1, tig == 0);

      // S = Q K^T for this consumer's 32 keys, over hd in steps of 16
      float sc[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) sc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss_n32(sc, desc_sw128(qaddr + off, 16, 1024),
                     desc_sw128(kaddr + off, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      mbar_arrive(&bar_kempty);

      if (MLSTM_CUT != 1) {
        // p = s W, W = exp(D - m) <= 1, 0 past the diagonal (and so past
        // S) and in rows past S; the signed sums from the float32 p
        float p[16];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * n + e;
            const float w0 = expf(((f0 - fk[2 * n + e]) + ik[2 * n + e]) - m0);
            const float w1 = expf(((f1 - fk[2 * n + e]) + ik[2 * n + e]) - m1);
            p[4 * n + e] = key <= last0 ? sc[4 * n + e] * w0 : 0.f;
            p[4 * n + 2 + e] = key <= last1 ? sc[4 * n + 2 + e] * w1 : 0.f;
            l0 += p[4 * n + e];
            l1 += p[4 * n + 2 + e];
          }
        // the other consumer is done reading the last tile's P
        if (j > 0) consumers_sync();
        // P as three bf16 terms, each the bf16 rounding of what the terms
        // before it left, into the swizzled tiles: row r's 16-byte chunk x
        // sits at chunk x ^ (r % 8); row rl + 8 is the same chunk, + 1024
        const int off = rl * 128 + 4 * quad;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int at = off + (((4 * cw + n) ^ (rl & 7)) << 4);
#pragma unroll
          for (int i = 0; i < kTerms; ++i) {
            const __nv_bfloat162 r0 =
                __floats2bfloat162_rn(p[4 * n], p[4 * n + 1]);
            const __nv_bfloat162 r1 =
                __floats2bfloat162_rn(p[4 * n + 2], p[4 * n + 3]);
            *reinterpret_cast<__nv_bfloat162*>(pt + i * kPBytes + at) = r0;
            *reinterpret_cast<__nv_bfloat162*>(pt + i * kPBytes + at + 1024) =
                r1;
            if (i + 1 < kTerms) {  // what the next term takes
              const float2 g0 = __bfloat1622float2(r0);
              const float2 g1 = __bfloat1622float2(r1);
              p[4 * n] -= g0.x;
              p[4 * n + 1] -= g0.y;
              p[4 * n + 2] -= g1.x;
              p[4 * n + 3] -= g1.y;
            }
          }
        }
        fence_async_smem();
        consumers_sync();  // both halves of P are in
      }

      timed_wait(1, &bar_vfull[s], (j / kVStages) & 1, tig == 0);
      if (MLSTM_CUT == 0) {
        // O += P V, term by term, 16 keys (2048 bytes of v) a step
        const uint32_t p0 = smem_u32(pt);
        const uint32_t vaddr = vbase + s * L::kTile;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < kTerms; ++i)
#pragma unroll
          for (int kk = 0; kk < kBN / 16; ++kk)
            wgmma_pv<HD>(acc,
                         desc_sw128(p0 + i * kPBytes + kk * 32, 16, 1024),
                         desc_sw128(vaddr + kk * 2048, kBoxBytes, 1024));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      }
      mbar_arrive(&bar_vempty[s]);
    }

    // epilogue: the signed row sums over the quad, then over both
    // consumers (consumer 0's half first); acc / max(|sum|, exp(-m))
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    if (quad == 0) {
      l_half[cw][rl] = l0;
      l_half[cw][rl + 8] = l1;
    }
    consumers_sync();
    const float d0 = fmaxf(fabsf(l_half[0][rl] + l_half[1][rl]), expf(-m0));
    const float d1 =
        fmaxf(fabsf(l_half[0][rl + 8] + l_half[1][rl + 8]), expf(-m1));
    const size_t row = (size_t)H * HD;  // a position's stride
    __nv_bfloat16* obase = o + (size_t)b * S * row + (size_t)h * HD +
                           cw * (HD / 2) + 2 * quad;
#pragma unroll
    for (int n = 0; n < NO / 4; ++n) {
      if (t0 < S)
        *reinterpret_cast<__nv_bfloat162*>(obase + (size_t)t0 * row + 8 * n) =
            __floats2bfloat162_rn(acc[4 * n] / d0, acc[4 * n + 1] / d0);
      if (t1 < S)
        *reinterpret_cast<__nv_bfloat162*>(obase + (size_t)t1 * row + 8 * n) =
            __floats2bfloat162_rn(acc[4 * n + 2] / d1, acc[4 * n + 3] / d1);
    }
    add_cycles(4, start, tig == 0);
  }
}


template <int HD>
int launch(const void* q, const void* k, const void* v, const void* F,
           const void* I, void* o, int B, int S, int H, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int err = make_map(&qm, q, HD, H, S, B);
  if (err == 0) err = make_map(&km, k, HD, H, S, B);
  if (err == 0) err = make_map(&vm, v, HD, H, S, B);
  if (err != 0) return err;
  const size_t smem = Layout<HD>::kBytes + 1024;  // + alignment slack
  const cudaError_t e = cudaFuncSetAttribute(
      mlstm_fwd_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (S + kBM - 1) / kBM);
  mlstm_fwd_wgmma<HD><<<grid, kThreads, smem, stream>>>(
      qm, km, vm, (const float*)F, (const float*)I, (__nv_bfloat16*)o, S, H);
  return (int)cudaGetLastError();
}

}  // namespace wg

extern "C" int mlstm_attention_wgmma_bf16(const void* q, const void* k,
                                          const void* v, const void* F,
                                          const void* I, void* o, int B,
                                          int S, int H, int hd,
                                          void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || (long long)B * H >= (1LL << 31) ||
      (S + wg::kBM - 1) / wg::kBM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 128: return wg::launch<128>(q, k, v, F, I, o, B, S, H, st);
    case 256: return wg::launch<256>(q, k, v, F, I, o, B, S, H, st);
    case 384: return wg::launch<384>(q, k, v, F, I, o, B, S, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mlstm_attention_simt_bf16(const void* q, const void* k,
                                         const void* v, const void* F,
                                         const void* I, void* o, int B,
                                         int S, int H, int hd,
                                         void* stream) {
  return simt::dispatch<__nv_bfloat16>(q, k, v, F, I, o, B, S, H, hd,
                                       stream);
}

extern "C" int mlstm_attention_simt_f32(const void* q, const void* k,
                                        const void* v, const void* F,
                                        const void* I, void* o, int B,
                                        int S, int H, int hd, void* stream) {
  return simt::dispatch<float>(q, k, v, F, I, o, B, S, H, hd, stream);
}

#ifdef MLSTM_WAITS
// ablation build only: copy the six cycle counters to out and zero them
extern "C" int mlstm_waits(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, wg::g_waits, sizeof(wg::g_waits));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(wg::g_waits, zero, sizeof(zero));
}
#endif
