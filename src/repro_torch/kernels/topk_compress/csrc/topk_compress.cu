// Blockwise magnitude top-k: per row of x (nb, block) float32, the k
// entries of largest |x|, as float32 values and block-local int32 indices.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/topk_compress/kernel.py:_topk_kernel
// (launched by topk_compress_kernel).  Plain version:
// ops.topk_compress_torch.  The order is lax.top_k's: |x| descending, ties
// to the lower index.  NaN is out of scope (a NaN's key sorts above +inf).
//
// What bounds it on Hopper: bytes, one read of x (4 bytes per element for
// float32) and k values and indices written per row; the comparisons are a
// few integer operations per element.  On the qwen2-1.5b gradient leaves
// (1.54 G float32 elements per pod) the bound is 6.18 GB, 1.8 ms at
// 3.35 TB/s.
//
// Design (simple first, right for any block up to 2^31 - 1 and any k up to
// block; on the path block runs from 256 to 13,762,560 and k from 2 to
// 137,625, so no row fits one shared-memory tile):
//   * one block of 512 threads per row; everything streams the row from
//     global memory.  With the stacked leaves' 28 rows only 28 of the 132
//     SMs work: more blocks per row are later work;
//   * the key of an entry is the bit pattern of |x| as float32, a uint32
//     that orders like |x|;
//   * radix select: 4 passes of 8 bits, most significant first, each a
//     histogram (per-warp copies in shared memory, lanes with equal digits
//     merged by __match_any_sync) of the keys that match the prefix found
//     so far; warp 0 finds the digit where the count from the top reaches
//     the k still wanted.  After 4 passes the prefix is the k-th largest
//     key, K, and `need` is how many entries equal to K are taken;
//   * compaction in index order: every key > K and the first `need` keys
//     == K, written with their indices to scratch (8 entries a thread a
//     tile, one block-wide exclusive scan of the packed counts a tile);
//   * a stable LSD radix sort of the k survivors on the descending key,
//     one bit a pass (keys with the bit set first), between two scratch
//     buffers; a pass where every key has the same bit is skipped.  Ties
//     keep index order, which gives lax.top_k's order;
//   * the values are gathered from x at the sorted indices.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                  // entries a thread a tile
constexpr int kTile = kThreads * kItems;   // 4096: counts fit 16 bits
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t key_of(float x) {
  return __float_as_uint(fabsf(x));
}

// Block-wide exclusive scan of one int a thread; *total gets the sum.
// smem holds kWarps + 1 ints.  Every thread of the block must call it.
__device__ int block_exclusive_scan(int v, int* total, int* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += n;
  }
  if (lane == 31) smem[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? smem[lane] : 0;
    int winc = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(kFull, winc, o);
      if (lane >= o) winc += n;
    }
    if (lane < kWarps) smem[lane] = winc - w;
    if (lane == kWarps - 1) smem[kWarps] = winc;
  }
  __syncthreads();
  const int out = smem[warp] + inc - v;
  *total = smem[kWarps];
  __syncthreads();  // smem may be reused right after
  return out;
}

__global__ void __launch_bounds__(kThreads)
topk_rows(const float* __restrict__ x, float* __restrict__ vals,
          int32_t* __restrict__ idx, uint32_t* __restrict__ keys_a,
          int32_t* __restrict__ idx_a, uint32_t* __restrict__ keys_b,
          int32_t* __restrict__ idx_b, long long block, int k) {
  __shared__ unsigned hist[kWarps][256];
  __shared__ unsigned total_hist[256];
  __shared__ int scan_smem[kWarps + 1];
  __shared__ int s_digit, s_need;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.x;
  const float* xr = x + row * block;

  // ---- radix select of the k-th largest key ---------------------------
  uint32_t prefix = 0, mask = 0;
  int need = k;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    for (int i = tid; i < kWarps * 256; i += kThreads)
      (&hist[0][0])[i] = 0u;
    __syncthreads();
    for (long long base = 0; base < block; base += kTile) {
      uint32_t kk[kItems];
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const long long i = base + (long long)j * kThreads + tid;
        kk[j] = i < block ? key_of(xr[i]) : 0u;
      }
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const long long i = base + (long long)j * kThreads + tid;
        const bool live = i < block && (kk[j] & mask) == prefix;
        const unsigned bin = live ? (kk[j] >> shift) & 255u : 256u;
        const unsigned peers = __match_any_sync(kFull, bin);
        if (bin < 256u && lane == __ffs(peers) - 1)
          atomicAdd(&hist[warp][bin], (unsigned)__popc(peers));
      }
    }
    __syncthreads();
    for (int b = tid; b < 256; b += kThreads) {
      unsigned s = 0;
      for (int w = 0; w < kWarps; ++w) s += hist[w][b];
      total_hist[b] = s;
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds bins 255 - 8l down to 248 - 8l: counts from the top
      unsigned part = 0;
      for (int j = 0; j < 8; ++j) part += total_hist[255 - 8 * lane - j];
      unsigned inc = part;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned n = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += n;
      }
      const unsigned hit = __ballot_sync(kFull, inc >= (unsigned)need);
      const int first = __ffs(hit) - 1;  // the k-th key is in this lane
      if (lane == first) {
        unsigned cum = inc - part;
        int d = 255 - 8 * lane;
        for (int j = 0; j < 8; ++j, --d) {
          const unsigned c = total_hist[d];
          if (cum + c >= (unsigned)need || j == 7) break;
          cum += c;
        }
        s_digit = d;
        s_need = need - (int)cum;
      }
    }
    __syncthreads();
    prefix |= (uint32_t)s_digit << shift;
    mask |= 255u << shift;
    need = s_need;
    __syncthreads();
  }
  const uint32_t kth = prefix;

  // ---- compaction in index order ----------------------------------------
  uint32_t* ka = keys_a + row * k;
  int32_t* ia = idx_a + row * k;
  int gt_run = 0, eq_run = 0;
  for (long long base = 0; base < block; base += kTile) {
    uint32_t kk[kItems];
    int ngt = 0, neq = 0;
    const long long first = base + (long long)tid * kItems;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long i = first + j;
      kk[j] = i < block ? key_of(xr[i]) : 0u;
      const bool live = i < block;
      ngt += live && kk[j] > kth;
      neq += live && kk[j] == kth;
    }
    int total;
    const int before =
        block_exclusive_scan(ngt | (neq << 16), &total, scan_smem);
    int gt = gt_run + (before & 0xffff), eq = eq_run + (before >> 16);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long i = first + j;
      if (i >= block) break;
      if (kk[j] > kth) {
        const int pos = gt + min(eq, need);
        ka[pos] = kk[j];
        ia[pos] = (int32_t)i;
        ++gt;
      } else if (kk[j] == kth) {
        if (eq < need) {
          ka[gt + eq] = kk[j];
          ia[gt + eq] = (int32_t)i;
        }
        ++eq;
      }
    }
    gt_run += total & 0xffff;
    eq_run += total >> 16;
  }
  __syncthreads();

  // ---- stable LSD sort of the k survivors, descending key -----------------
  uint32_t* src_k = ka;
  int32_t* src_i = ia;
  uint32_t* dst_k = keys_b + row * k;
  int32_t* dst_i = idx_b + row * k;
  for (int bit = 0; bit < 31; ++bit) {  // bit 31 of |x| is always 0
    int ones = 0;
    for (int base = 0; base < k; base += kThreads) {
      const int i = base + tid;
      ones += __syncthreads_count(i < k && ((src_k[i] >> bit) & 1u));
    }
    if (ones == 0 || ones == k) continue;  // the same bit everywhere
    int ones_run = 0;
    for (int base = 0; base < k; base += kTile) {
      uint32_t kk[kItems];
      int n1 = 0;
      const int first = base + tid * kItems;
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int i = first + j;
        kk[j] = i < k ? src_k[i] : 0u;
        n1 += i < k && ((kk[j] >> bit) & 1u);
      }
      int total;
      int o = ones_run + block_exclusive_scan(n1, &total, scan_smem);
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int i = first + j;
        if (i >= k) break;
        // ones first, in order; zeros after them, in order
        const int pos = ((kk[j] >> bit) & 1u) ? o++ : ones + (i - o);
        dst_k[pos] = kk[j];
        dst_i[pos] = src_i[i];
      }
      ones_run += total;
    }
    __syncthreads();
    uint32_t* tk = src_k; src_k = dst_k; dst_k = tk;
    int32_t* ti = src_i; src_i = dst_i; dst_i = ti;
  }

  // ---- values at the sorted indices ---------------------------------------
  float* vr = vals + row * k;
  int32_t* ir = idx + row * k;
  for (int j = tid; j < k; j += kThreads) {
    const int32_t i = src_i[j];
    ir[j] = i;
    vr[j] = xr[i];
  }
}

}  // namespace

extern "C" int topk_compress(const void* x, void* vals, void* idx,
                             void* keys_a, void* idx_a, void* keys_b,
                             void* idx_b, int nb, long long block, int k,
                             void* stream) {
  if (nb <= 0 || block <= 0 || k <= 0 || k > block ||
      block > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  topk_rows<<<nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)vals, (int32_t*)idx, (uint32_t*)keys_a,
      (int32_t*)idx_a, (uint32_t*)keys_b, (int32_t*)idx_b, block, k);
  return (int)cudaGetLastError();
}
