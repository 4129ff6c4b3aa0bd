// Blockwise magnitude top-k: per row of x (nb, block) float32, the k
// entries of largest |x|, as float32 values and block-local int32 indices.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/topk_compress/kernel.py:_topk_kernel
// (launched by topk_compress_kernel).  Plain version:
// ops.topk_compress_torch.  The order is lax.top_k's: |x| descending, ties
// to the lower index.  NaN is out of scope (a NaN's key sorts above +inf).
//
// What bounds it on Hopper: bytes, one read of x (4 bytes per element) and
// k values and indices written per row; the comparisons are a few integer
// operations per element.  On qwen2-1.5b's stacked MLP rows, (28,
// 13,762,560) with k = 137,625, that is 1.54 GB: 0.469 ms at 3.35 TB/s.
//
// One total order settles the selection, the ties and the output order at
// once: the composite key of entry i of a row of n is
//     c = (bits(|x_i|) << b) | (n - 1 - i),   b = ceil(log2 n),
// 31 + b <= 62 bits, unique within the row.  The top k of the row are its
// k largest c, in descending c: |x| descending, ties to the lower index.
// Nothing before the final sort has to keep any order.
//
// Two routes, picked by the wrapper before the launch (kernel.route):
//
// "row" (block <= 4096: embed's rows of 1536, the norms' and biases'; nb
// alone fills the card): one block per row.  The row's keys sit in shared
// memory; a radix select over c, 8 bits a pass from the top, finds the
// k-th largest c (or stops early when the digit's whole bucket is taken);
// the k survivors are compacted into shared memory and bitonic-sorted in
// descending c; the values are gathered from x.
//
// "split" (longer rows: the stacked leaves' 28 rows of 393,216 to
// 13,762,560): each row is cut into chunks of 16,384 entries spread over
// about 8 blocks an SM (the (28, 13,762,560) leaf: 38 blocks a row, 1064
// on 132 SMs, each looping over its chunks).  A radix select in the
// manner of AIR top-k (Zhang et al., SC '23), where only the first two
// passes read x:
//   * select level l, two kernels.  sel_hist: each block counts the digit
//     of c (11 bits: the first is bits 30..20 of |x|) of its share of the
//     source in shared memory and adds the counts to the row's histogram
//     with integer atomics (the sums do not depend on the order); the last
//     block of the row to finish (a ticket) finds the digit d holding the
//     k-th key, how many entries of its bucket are still wanted (need) and
//     the bucket's size, and zeroes the histogram for the next level.
//     sel_filter: entries of the current bucket whose digit is above d are
//     winners, appended to the row's winner buffer; entries with digit d
//     are appended to a candidate buffer of `cap` entries a row, or, when
//     need equals the bucket's size, are winners too and the row is done;
//   * the source of level 0 is x; of a later level, the candidates of
//     the level before, a block per 16,384 of cap, or x
//     again (read with the prefix found so far, each block looping over
//     chunks) when the bucket was larger than cap (a row of many ties or
//     zeros: right, and slower); a row that is done returns at once;
//   * level 0 over a row of 16-byte aligned float4s (n % 4 == 0), the
//     common case, counts and classifies bits 30..20 of |x| straight from
//     the loads and builds a 64-bit key only for what it writes;
//   * a lane counts its winners and candidates of a tile (16 entries, 32
//     at level 0), a warp scan places them, and one global atomic a warp,
//     tile and kind claims the slots, so the winners arrive in no set
//     order;
//   * the k winners of each row are sorted on descending c by an LSD radix
//     sort, 8 bits a pass over the 32 + b bits that vary (7 passes at b =
//     24), two kernels a pass: sort_up counts each 2048-key tile's digits
//     and the last tile of the row (a ticket) scans the counts into
//     offsets; sort_down ranks each tile's keys stably (per warp with
//     __match_any_sync, then across warps) and scatters them;
//   * the split route's keys carry x's sign bit below the composite key
//     (it never decides an order), so gather writes the indices and the
//     values from the sorted keys alone, without reading x a third time.
// Results are bitwise those of the plain version and deterministic: every
// atomic is an integer count or a slot claim whose order the sort undoes.
//
// The wrapper allocates every buffer (kernel.py); the launcher allocates
// nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSelBits = 11;                 // digit width of the select
constexpr int kSelBins = 1 << kSelBits;
constexpr int kChunk = 16384;                // source entries a block
constexpr int kSub = 4096;                   // entries a tile
constexpr int kSortItems = 8;
constexpr int kTile = kThreads * kSortItems;  // keys a sort block
constexpr int kRowMax = 4096;                // route "row": block <= this
constexpr int kRowBits = 8;                  // digit width, route "row"
constexpr int kMaxRows = 65535;              // gridDim.y
constexpr int kBlocksPerSm = 8;              // level 0's grid, all rows

// the words of a row's select state (int64 each)
enum {
  kPrefix = 0,   // c >> shift of the current bucket, d included
  kNeed = 1,     // entries still wanted from the current bucket
  kTake = 2,     // l + 1 once level l takes its whole bucket: the row is
                 // done after level l's filter; 0 before
  kMode = 3,     // kMode + (level & 1): the source of that level
  kCount = 5,    // kCount + (level & 1): candidates in that level's buffer
  kWins = 7,     // winners appended so far
  kStateWords = 8
};
enum { kFromX = 0, kFromCand = 1 };

// Whether the row of state st is done before level `level` runs.
__device__ __forceinline__ bool done_before(const long long* st, int level) {
  const long long taken = st[kTake];
  return taken != 0 && taken <= level;
}

__device__ __forceinline__ uint32_t key_of(float v) {
  return __float_as_uint(v) & 0x7fffffffu;   // the bits of |v|
}

__device__ __forceinline__ uint64_t composite(uint32_t key, long long i,
                                              long long n, int b) {
  return ((uint64_t)key << b) | (uint64_t)(n - 1 - i);
}

// The split route's key: the composite key and, below it, x's sign bit, so
// that the winners carry x's own bits and the values need no second read
// of x.  The sign bit never decides an order (the composite is unique).
__device__ __forceinline__ uint64_t split_key(float v, long long i,
                                              long long n, int b) {
  return (composite(key_of(v), i, n, b) << 1) | (__float_as_uint(v) >> 31);
}

__device__ __forceinline__ float lane_of(const float4& q, int t) {
  return t == 0 ? q.x : t == 1 ? q.y : t == 2 ? q.z : q.w;
}

// Block-wide exclusive scan of one unsigned a thread; *total gets the sum.
// smem holds kWarps + 1 words.  Every thread of the block must call it.
__device__ unsigned long long block_scan(unsigned long long v,
                                         unsigned long long* total,
                                         unsigned long long* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long n = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += n;
  }
  if (lane == 31) smem[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const unsigned long long w = lane < kWarps ? smem[lane] : 0;
    unsigned long long winc = w;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long n = __shfl_up_sync(kFull, winc, o);
      if (lane >= o) winc += n;
    }
    if (lane < kWarps) smem[lane] = winc - w;
    if (lane == kWarps - 1) smem[kWarps] = winc;
  }
  __syncthreads();
  const unsigned long long out = smem[warp] + inc - v;
  *total = smem[kWarps];
  __syncthreads();   // smem may be reused right after
  return out;
}

// Find, from the top of `bins` counts (sh[bin], bins <= 2048), the digit
// whose bucket holds the need-th largest entry: *digit, the entries above
// it (*above) and its bucket's size (*bucket).  Every thread must call it.
__device__ void find_digit(const unsigned* sh, int bins, long long need,
                           int* digit, long long* above, long long* bucket,
                           unsigned long long* scan) {
  constexpr int kPer = kSelBins / kThreads;   // 8 bins a thread, top down
  __shared__ int s_digit;
  __shared__ long long s_above;
  if (threadIdx.x == 0) {   // a count short of need (never on valid state)
    s_digit = 0;            // stays in range
    s_above = 0;
  }
  unsigned long long part = 0;
  for (int j = 0; j < kPer; ++j) {
    const int v = kSelBins - 1 - (threadIdx.x * kPer + j);
    part += v < bins ? sh[v] : 0u;
  }
  unsigned long long total;
  const unsigned long long before = block_scan(part, &total, scan);
  if (before < (unsigned long long)need &&
      before + part >= (unsigned long long)need) {
    unsigned long long cum = before;
    for (int j = 0; j < kPer; ++j) {
      const int v = kSelBins - 1 - (threadIdx.x * kPer + j);
      const unsigned c = v < bins ? sh[v] : 0u;
      if (cum + c >= (unsigned long long)need) {
        s_digit = v;
        s_above = (long long)cum;
        break;
      }
      cum += c;
    }
  }
  __syncthreads();
  *digit = s_digit;
  *above = s_above;
  *bucket = sh[s_digit];
  __syncthreads();
}

// One tile of a level's source into registers, the kSub entries from
// `base` on: kHeld split keys a thread (ok = false past `end`), from x or
// from the row's candidates.  The order of the entries does not matter to
// the select.  A block takes the tiles of chunks blockIdx.x, blockIdx.x +
// gridDim.x, ... of the source: level 0 launches about kBlocksPerSm blocks
// an SM, a later level only enough blocks for `cap` candidates (they loop
// over x when the bucket overflowed).
constexpr int kHeld = kSub / kThreads;        // 16 entries a thread a tile
constexpr int kTilesPerChunk = kChunk / kSub;

__device__ __forceinline__ void load_tile(int mode, const float* xr,
                                          const uint64_t* cr,
                                          long long base, long long end,
                                          long long n, int b,
                                          uint64_t (&c)[kHeld],
                                          bool (&ok)[kHeld]) {
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    const long long i = base + j * kThreads + threadIdx.x;
    ok[j] = i < end;
    c[j] = mode == kFromX ? split_key(ok[j] ? xr[i] : 0.f, i, n, b)
                          : (ok[j] ? cr[i] : 0ull);
  }
}

// The tiles of this block's chunks: f(base) for each, the same number of
// calls on every thread of the block.
template <class F>
__device__ __forceinline__ void for_tiles(long long end, F f) {
  for (long long c0 = (long long)blockIdx.x * kChunk; c0 < end;
       c0 += (long long)gridDim.x * kChunk)
    for (int sub = 0; sub < kTilesPerChunk; ++sub) {
      const long long base = c0 + (long long)sub * kSub;
      if (base >= end) break;
      f(base);
    }
}

// Count digit d in the block's histogram sh (when ok): one shared-memory
// atomic an entry (on the H100 3x faster than merging a warp's equal
// digits with __match_any_sync first: kernels/ablation.py).
__device__ __forceinline__ void count_digit(unsigned* sh, unsigned d,
                                            bool ok) {
  if (ok) atomicAdd(&sh[d], 1u);
}

// ---- split route: select level `level`, the histogram (and the find) ----
__global__ void __launch_bounds__(kThreads)
sel_hist(const float* __restrict__ x, const uint64_t* __restrict__ cand,
         long long* __restrict__ state, unsigned* __restrict__ hist,
         int* __restrict__ ticket, long long n, int b, long long k,
         long long cap, int level, int shift, int width, bool vec) {
  __shared__ unsigned sh[kSelBins];
  __shared__ unsigned long long scan[kWarps + 1];
  __shared__ bool s_last;
  const long long row = blockIdx.y;
  long long* st = state + row * kStateWords;
  if (done_before(st, level)) return;
  const int mode = level == 0 ? kFromX : (int)st[kMode + (level & 1)];
  const int bins = 1 << width;
  for (int i = threadIdx.x; i < bins; i += kThreads) sh[i] = 0u;
  __syncthreads();
  const uint64_t parent = level == 0 ? 0ull : (uint64_t)st[kPrefix];
  const long long count =
      level == 0 ? 0 : min(st[kCount + (level & 1)], cap);
  const int hi = shift + width;
  const unsigned dmask = (unsigned)bins - 1u;
  const long long end = mode == kFromX ? n : count;
  if (level == 0 && vec) {
    // level 0 from x, the common case: the digit is bits 30..20 of |x|,
    // counted from the loads directly, kVec float4s a thread in flight
    constexpr int kVec = 8;
    const float4* x4 = reinterpret_cast<const float4*>(x + row * n);
    const long long nv = n >> 2;
    for (long long v0 = (long long)blockIdx.x * kThreads * kVec; v0 < nv;
         v0 += (long long)gridDim.x * kThreads * kVec) {
      float4 q[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const long long v = v0 + j * kThreads + threadIdx.x;
        q[j] = v < nv ? __ldcs(x4 + v) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const bool ok = v0 + j * kThreads + threadIdx.x < nv;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          count_digit(sh, key_of(lane_of(q[j], t)) >> 20, ok);
      }
    }
  } else {
    for_tiles(end, [&](long long base) {
      uint64_t c[kHeld];
      bool ok[kHeld];
      load_tile(mode, x + row * n, cand + row * cap, base, end, n, b, c,
                ok);
#pragma unroll
      for (int j = 0; j < kHeld; ++j)
        count_digit(sh, (unsigned)(c[j] >> shift) & dmask,
                    ok[j] && (c[j] >> hi) == parent);
    });
  }
  __syncthreads();
  unsigned* hr = hist + row * kSelBins;
  for (int i = threadIdx.x; i < bins; i += kThreads)
    if (sh[i]) atomicAdd(&hr[i], sh[i]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&ticket[row], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  // the last block of the row: the whole histogram is in hr
  __threadfence();
  for (int i = threadIdx.x; i < bins; i += kThreads) {
    sh[i] = __ldcg(&hr[i]);
    hr[i] = 0u;                                   // for the next level
  }
  __syncthreads();
  const long long need = level == 0 ? k : st[kNeed];
  int d;
  long long above, bucket;
  find_digit(sh, bins, need, &d, &above, &bucket, scan);
  if (threadIdx.x == 0) {
    const long long left = need - above;          // 1 <= left <= bucket
    const bool take = left == bucket;
    st[kPrefix] = (long long)((parent << width) | (uint64_t)d);
    st[kNeed] = left;
    st[kTake] = take ? level + 1 : 0;
    st[kMode + ((level + 1) & 1)] = bucket <= cap ? kFromCand : kFromX;
    st[kCount + ((level + 1) & 1)] = 0;
    ticket[row] = 0;
  }
}

// ---- split route: select level `level`, the filter ----------------------
// Claim slots for a lane's nw winners and nc candidates (each at most
// 32): one atomic a warp and kind; *wpos and *cpos get the lane's first
// slots.  Every thread of the warp calls it together.
__device__ __forceinline__ void claim(unsigned nw, unsigned nc,
                                      unsigned long long* wins_n,
                                      unsigned long long* cand_n,
                                      unsigned long long* wpos,
                                      unsigned long long* cpos) {
  const int lane = threadIdx.x & 31;
  const unsigned mine = nw | (nc << 16);       // a warp's sums fit 16 bits
  unsigned inc = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned m = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += m;
  }
  const unsigned total = __shfl_sync(kFull, inc, 31);
  unsigned long long bw = 0ull, bc = 0ull;
  if (lane == 0) {
    if (total & 0xffffu)
      bw = atomicAdd(wins_n, (unsigned long long)(total & 0xffffu));
    if (total >> 16)
      bc = atomicAdd(cand_n, (unsigned long long)(total >> 16));
  }
  bw = __shfl_sync(kFull, bw, 0);
  bc = __shfl_sync(kFull, bc, 0);
  const unsigned before = inc - mine;
  *wpos = bw + (before & 0xffffu);
  *cpos = bc + (before >> 16);
}

__global__ void __launch_bounds__(kThreads, 4)   // 4 blocks an SM
sel_filter(const float* __restrict__ x, const uint64_t* __restrict__ cand,
           uint64_t* __restrict__ cand_next, long long* __restrict__ state,
           uint64_t* __restrict__ wins, long long n, int b, long long k,
           long long cap, int level, int shift, int width, bool vec) {
  const long long row = blockIdx.y;
  long long* st = state + row * kStateWords;
  if (done_before(st, level)) return;
  const int mode = level == 0 ? kFromX : (int)st[kMode + (level & 1)];
  const uint64_t pre = (uint64_t)st[kPrefix];
  const uint64_t parent = pre >> width;
  const bool take = st[kTake] == level + 1;
  const bool keep = st[kMode + ((level + 1) & 1)] == kFromCand;
  const long long count =
      level == 0 ? 0 : min(st[kCount + (level & 1)], cap);
  const int hi = shift + width;
  unsigned long long* wins_n = (unsigned long long*)&st[kWins];
  unsigned long long* cand_n =
      (unsigned long long*)&st[kCount + ((level + 1) & 1)];
  uint64_t* wr = wins + row * k;
  uint64_t* cn = cand_next + row * cap;
  // an entry's kind: 1 winner, 2 candidate, 0 neither; 2 bits an entry
  auto write = [&](unsigned kind, uint64_t key, unsigned long long* wpos,
                   unsigned long long* cpos) {
    if (kind == 1u) {
      if (*wpos < (unsigned long long)k) wr[*wpos] = key;
      ++*wpos;
    } else if (kind == 2u) {
      if (*cpos < (unsigned long long)cap) cn[*cpos] = key;
      ++*cpos;
    }
  };
  if (level == 0 && vec) {
    // level 0 from x, the common case: classify by bits 30..20 of |x|
    // (pre is the digit itself) straight from the loads, kVec float4s a
    // thread in flight
    constexpr int kVec = 8;
    const float4* x4 = reinterpret_cast<const float4*>(x + row * n);
    const long long nv = n >> 2;
    const unsigned d0 = (unsigned)pre;
    for (long long v0 = (long long)blockIdx.x * kThreads * kVec; v0 < nv;
         v0 += (long long)gridDim.x * kThreads * kVec) {
      float4 q[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const long long v = v0 + j * kThreads + threadIdx.x;
        q[j] = v < nv ? __ldcs(x4 + v) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      uint64_t kinds = 0ull;
      unsigned nw = 0u, nc = 0u;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const bool ok = v0 + j * kThreads + threadIdx.x < nv;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const unsigned dig = key_of(lane_of(q[j], t)) >> 20;
          const unsigned kind =
              !ok || dig < d0 ? 0u
              : (dig > d0 || take) ? 1u : (keep ? 2u : 0u);
          kinds |= (uint64_t)kind << (2 * (4 * j + t));
          nw += kind == 1u;
          nc += kind == 2u;
        }
      }
      unsigned long long wpos, cpos;
      claim(nw, nc, wins_n, cand_n, &wpos, &cpos);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const long long i = 4 * (v0 + j * kThreads + threadIdx.x);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const unsigned kind = (unsigned)(kinds >> (2 * (4 * j + t))) & 3u;
          if (kind)
            write(kind, split_key(lane_of(q[j], t), i + t, n, b), &wpos,
                  &cpos);
        }
      }
    }
    return;
  }
  const long long end = mode == kFromX ? n : count;
  for_tiles(end, [&](long long base) {
    uint64_t c[kHeld];
    bool ok[kHeld];
    load_tile(mode, x + row * n, cand + row * cap, base, end, n, b, c,
              ok);
    unsigned kinds = 0u, nw = 0u, nc = 0u;
#pragma unroll
    for (int j = 0; j < kHeld; ++j) {
      unsigned kind = 0u;
      if (ok[j] && (c[j] >> hi) == parent) {
        const uint64_t top = c[j] >> shift;
        if (top > pre || (top == pre && take)) kind = 1u;
        else if (top == pre && keep) kind = 2u;
      }
      kinds |= kind << (2 * j);
      nw += kind == 1u;
      nc += kind == 2u;
    }
    unsigned long long wpos, cpos;
    claim(nw, nc, wins_n, cand_n, &wpos, &cpos);
#pragma unroll
    for (int j = 0; j < kHeld; ++j) {
      const unsigned kind = (kinds >> (2 * j)) & 3u;
      if (kind) write(kind, c[j], &wpos, &cpos);
    }
  });
}

// ---- split route: one LSD pass of the winners' sort, the counts ---------
__global__ void __launch_bounds__(kThreads)
sort_up(const uint64_t* __restrict__ src, unsigned* __restrict__ counts,
        int* __restrict__ ticket, long long k, int tiles, int shift) {
  __shared__ unsigned cnt[256];
  __shared__ unsigned long long scan[kWarps + 1];
  __shared__ bool s_last;
  const long long row = blockIdx.y;
  const int tile = blockIdx.x;
  cnt[threadIdx.x] = 0u;
  __syncthreads();
  const uint64_t* s = src + row * k;
  for (int j = 0; j < kSortItems; ++j) {
    const long long i = (long long)tile * kTile + j * kThreads + threadIdx.x;
    if (i < k) atomicAdd(&cnt[(unsigned)((~s[i]) >> shift) & 255u], 1u);
  }
  __syncthreads();
  // counts[row][tile][digit]: a tile's 256 counts are one coalesced row
  unsigned* cr = counts + row * 256LL * tiles;
  cr[(long long)tile * 256 + threadIdx.x] = cnt[threadIdx.x];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&ticket[row], 1) == tiles - 1;
  __syncthreads();
  if (!s_last) return;
  // the last tile of the row: counts -> offsets, digit-major, tile-minor;
  // thread t walks digit t's column, 8 tiles a round trip
  __threadfence();
  constexpr int kBatch = 8;
  unsigned long long sum = 0;
  for (int t0 = 0; t0 < tiles; t0 += kBatch) {
    unsigned v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      v[j] = t0 + j < tiles
                 ? __ldcg(&cr[(long long)(t0 + j) * 256 + threadIdx.x]) : 0u;
#pragma unroll
    for (int j = 0; j < kBatch; ++j) sum += v[j];
  }
  unsigned long long total;
  unsigned long long run = block_scan(sum, &total, scan);
  for (int t0 = 0; t0 < tiles; t0 += kBatch) {
    unsigned v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      v[j] = t0 + j < tiles
                 ? __ldcg(&cr[(long long)(t0 + j) * 256 + threadIdx.x]) : 0u;
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (t0 + j < tiles) {
        cr[(long long)(t0 + j) * 256 + threadIdx.x] = (unsigned)run;
        run += v[j];
      }
  }
  if (threadIdx.x == 0) ticket[row] = 0;
}

// ---- split route: one LSD pass of the winners' sort, the scatter --------
__global__ void __launch_bounds__(kThreads)
sort_down(const uint64_t* __restrict__ src, uint64_t* __restrict__ dst,
          const unsigned* __restrict__ counts, long long k, int tiles,
          int shift) {
  __shared__ unsigned wc[kWarps][256];
  const long long row = blockIdx.y;
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  for (int i = threadIdx.x; i < kWarps * 256; i += kThreads)
    (&wc[0][0])[i] = 0u;
  __syncthreads();
  const uint64_t* s = src + row * k;
  // warp w ranks keys [w * 256, w * 256 + 256) of the tile, 32 at a step,
  // in order: the rank is stable
  const long long base = (long long)tile * kTile + warp * 32 * kSortItems;
  uint64_t v[kSortItems];
  unsigned dg[kSortItems], rk[kSortItems];
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const long long i = base + r * 32 + lane;
    const bool ok = i < k;
    v[r] = ok ? s[i] : 0ull;
    dg[r] = ok ? (unsigned)((~v[r]) >> shift) & 255u : 256u;
    const unsigned peers = __match_any_sync(kFull, dg[r]);
    const unsigned old = ok ? wc[warp][dg[r]] : 0u;
    __syncwarp();
    if (ok && (peers & lt) == 0) wc[warp][dg[r]] = old + __popc(peers);
    __syncwarp();
    rk[r] = old + __popc(peers & lt);
  }
  __syncthreads();
  {  // thread t: digit t's offset of each warp within the tile
    unsigned run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const unsigned c = wc[w][threadIdx.x];
      wc[w][threadIdx.x] = run;
      run += c;
    }
  }
  __syncthreads();
  const unsigned* off = counts + row * 256LL * tiles + (long long)tile * 256;
  uint64_t* d = dst + row * k;
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    if (dg[r] < 256u)
      d[(long long)off[dg[r]] + wc[warp][dg[r]] + rk[r]] = v[r];
  }
}

// ---- split route: indices and values from the sorted keys --------------
__global__ void __launch_bounds__(kThreads)
gather(const uint64_t* __restrict__ sorted, float* __restrict__ vals,
       int32_t* __restrict__ idx, long long n, long long k, int b) {
  const long long row = blockIdx.y;
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= k) return;
  const uint64_t c = sorted[row * k + j];
  const uint64_t mask = b ? (~0ull >> (64 - b)) : 0ull;
  idx[row * k + j] = (int32_t)(n - 1 - (long long)((c >> 1) & mask));
  vals[row * k + j] = __uint_as_float(
      (uint32_t)((c >> (b + 1)) & 0x7fffffffu) | ((uint32_t)(c & 1u) << 31));
}

// ---- row route: one block a row of n <= kRowMax -------------------------
__global__ void __launch_bounds__(kThreads)
topk_row(const float* __restrict__ x, float* __restrict__ vals,
         int32_t* __restrict__ idx, int n, int k, int b, int sortn) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* buf = reinterpret_cast<long long*>(smem);        // sortn
  uint32_t* keys = reinterpret_cast<uint32_t*>(buf + sortn);  // n
  unsigned* hist = keys + n;                                  // 256
  __shared__ int s_digit, s_left, s_take, s_n;
  const long long row = blockIdx.x;
  const float* xr = x + row * (long long)n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll 8
  for (int i = tid; i < n; i += kThreads) keys[i] = key_of(xr[i]);
  // radix select over c, kRowBits a pass from the top
  const int total = 31 + b;
  uint64_t prefix = 0;
  int need = k, shift = total;
  while (shift > 0) {
    const int width = min(kRowBits, shift);
    shift -= width;
    const int hi = shift + width;
    hist[tid] = 0u;                      // kThreads == 1 << kRowBits
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) {
      const uint64_t c = composite(keys[i], i, n, b);
      if ((c >> hi) == prefix)
        atomicAdd(&hist[(unsigned)(c >> shift) & ((1u << width) - 1u)], 1u);
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds bins 255 - 8l down to 248 - 8l: counts from the top
      unsigned part = 0;
      for (int j = 0; j < 8; ++j) part += hist[255 - 8 * lane - j];
      unsigned inc = part;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned m = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += m;
      }
      const unsigned hit = __ballot_sync(kFull, inc >= (unsigned)need);
      if (lane == __ffs(hit) - 1) {
        unsigned cum = inc - part;
        int dd = 255 - 8 * lane;
        for (int j = 0; j < 8; ++j, --dd) {
          const unsigned c = hist[dd];
          if (cum + c >= (unsigned)need || j == 7) break;
          cum += c;
        }
        s_digit = dd;
        s_left = need - (int)cum;
        s_take = s_left == (int)hist[dd];
      }
    }
    __syncthreads();
    prefix = (prefix << width) | (uint64_t)s_digit;
    need = s_left;
    const bool take = s_take;
    __syncthreads();
    if (take) break;       // the whole bucket is wanted
  }
  // the k survivors: every c >= prefix << shift
  const uint64_t thr = prefix << shift;
  if (tid == 0) s_n = 0;
  for (int i = k + tid; i < sortn; i += kThreads) buf[i] = -1;
  __syncthreads();
  for (int i = tid; i < n; i += kThreads) {
    const uint64_t c = composite(keys[i], i, n, b);
    if (c >= thr) buf[atomicAdd(&s_n, 1)] = (long long)c;
  }
  __syncthreads();
  // bitonic sort, descending
  for (int size = 2; size <= sortn; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < sortn / 2; t += kThreads) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const long long a = buf[i], c = buf[j];
        if ((a < c) == ((i & size) == 0)) { buf[i] = c; buf[j] = a; }
      }
      __syncthreads();
    }
  }
  const uint64_t mask = b ? (~0ull >> (64 - b)) : 0ull;
  for (int j = tid; j < k; j += kThreads) {
    const int i = n - 1 - (int)((uint64_t)buf[j] & mask);
    idx[row * k + j] = i;
    vals[row * k + j] = xr[i];
  }
}

int bits_for(long long n) {   // ceil(log2 n): n - 1 fits in b bits
  int b = 0;
  while (b < 63 && (1LL << b) < n) ++b;
  return b;
}

}  // namespace

// route 0 = "row", 1 = "split".  Split scratch (the wrapper's): zeroed =
// the select histograms (nb * 2048 uint32), the select state (nb * 8
// int64) and a ticket a row (nb int32), in that order; cand = two
// candidate buffers (2 * nb * cap uint64); wins = two winner buffers (2 *
// nb * k uint64); counts = the sort's digit counts (nb * 256 * tiles
// uint32, tiles = ceil(k / 2048)).
extern "C" int topk_compress(const void* x, void* vals, void* idx,
                             void* zeroed, void* cand, void* wins,
                             void* counts, int nb, long long block, int k,
                             long long cap, int route, void* stream) {
  if (nb <= 0 || block <= 0 || k <= 0 || k > block ||
      block > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int b = bits_for(block);
  const float* xf = (const float*)x;
  if (route == 0) {
    if (block > kRowMax) return (int)cudaErrorInvalidValue;
    int sortn = 1;
    while (sortn < k) sortn <<= 1;
    const size_t smem = (size_t)sortn * 8 + (size_t)block * 4 + 256 * 4;
    static bool attr = false;
    if (!attr) {
      cudaFuncSetAttribute(topk_row,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kRowMax * 8 + kRowMax * 4 + 256 * 4);
      attr = true;
    }
    topk_row<<<nb, kThreads, smem, st>>>(xf, (float*)vals, (int32_t*)idx,
                                         (int)block, k, b, sortn);
    return (int)cudaGetLastError();
  }
  if (cap <= 0 || cap > block) return (int)cudaErrorInvalidValue;
  const long long n = block;
  const int total = 32 + b;     // split_key's bits
  const bool vec = n % 4 == 0 && ((uintptr_t)x & 15) == 0;
  // level 0: about kBlocksPerSm blocks an SM over all rows, each looping
  // over its chunks of x (a block's fixed costs, the histogram's zeroing
  // and flush, amortized over many chunks); later levels: a block per
  // kChunk of cap
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const int chunks = (int)((n + kChunk - 1) / kChunk);
  const int cand_chunks = (int)((cap + kChunk - 1) / kChunk);
  const int tiles = (k + kTile - 1) / kTile;
  unsigned* hist_all = (unsigned*)zeroed;
  long long* state_all = (long long*)(hist_all + (size_t)nb * kSelBins);
  int* ticket_all = (int*)(state_all + (size_t)nb * kStateWords);
  for (int r0 = 0; r0 < nb; r0 += kMaxRows) {
    const int rows = nb - r0 < kMaxRows ? nb - r0 : kMaxRows;
    const float* xr = xf + (size_t)r0 * n;
    unsigned* hist = hist_all + (size_t)r0 * kSelBins;
    long long* state = state_all + (size_t)r0 * kStateWords;
    int* ticket = ticket_all + r0;   // the select's, then the sort's
    uint64_t* c0 = (uint64_t*)cand + (size_t)r0 * cap;
    uint64_t* c1 = (uint64_t*)cand + (size_t)nb * cap + (size_t)r0 * cap;
    uint64_t* w0 = (uint64_t*)wins + (size_t)r0 * k;
    uint64_t* w1 = (uint64_t*)wins + (size_t)nb * k + (size_t)r0 * k;
    unsigned* cnt = (unsigned*)counts + (size_t)r0 * 256 * tiles;
    // the select's digits: 11 bits from the top of the composite key
    // (bits 30..20 of |x| first), above the sign bit
    int shift = total - 1, level = 0;
    while (shift > 0) {
      const int width = level == 0 ? kSelBits
                                   : (shift < kSelBits ? shift : kSelBits);
      shift -= width;
      const uint64_t* src = (level & 1) ? c1 : c0;
      uint64_t* nxt = (level & 1) ? c0 : c1;
      const int per_row = (sms * kBlocksPerSm + rows - 1) / rows;
      const int grid = level == 0 ? (chunks < per_row ? chunks : per_row)
                                  : cand_chunks;
      sel_hist<<<dim3(grid, rows), kThreads, 0, st>>>(
          xr, src, state, hist, ticket, n, b, k, cap, level, shift + 1,
          width, vec);
      sel_filter<<<dim3(grid, rows), kThreads, 0, st>>>(
          xr, src, nxt, state, w0, n, b, k, cap, level, shift + 1, width,
          vec);
      ++level;
    }
    uint64_t* s = w0;
    uint64_t* d = w1;
    for (int sh = 0; sh < total; sh += 8) {
      sort_up<<<dim3(tiles, rows), kThreads, 0, st>>>(s, cnt, ticket, k,
                                                      tiles, sh);
      sort_down<<<dim3(tiles, rows), kThreads, 0, st>>>(s, d, cnt, k, tiles,
                                                        sh);
      uint64_t* t = s; s = d; d = t;
    }
    gather<<<dim3((k + kThreads - 1) / kThreads, rows), kThreads, 0, st>>>(
        s, (float*)vals + (size_t)r0 * k, (int32_t*)idx + (size_t)r0 * k, n,
        k, b);
  }
  return (int)cudaGetLastError();
}
