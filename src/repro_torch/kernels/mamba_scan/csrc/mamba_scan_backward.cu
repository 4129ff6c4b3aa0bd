// Mamba-1 selective scan, float32: the backward.
//
// Replaces no Pallas kernel: the reference differentiates its jnp scan
// with jax.grad (src/repro/models/ssm.py:mamba_forward), and its Pallas
// kernel src/repro/kernels/mamba_scan/kernel.py:_mamba_kernel has no
// backward.  This is the gradient of mamba_scan_ref (and of the forward
// kernels in mamba_scan.cu).  Plain version: ops.mamba_scan_backward_torch.
// Inputs x, dt, dy (Bb, S, di), B, C (Bb, S, N), A (di, N), dh_final (Bb,
// di, N) or null (zero), and the forward's saved states hbound (Bb,
// ceil(S / 16) - 1, di, N): h after every 16 steps but the last chunk's
// (mamba_scan.cu writes them when asked; the wrapper runs the forward for
// them when the caller has none).  Outputs dx, ddt (Bb, S, di), dB, dC
// (Bb, S, N), dA (di, N), all float32, contiguous.  With a_t = exp(dt_t A)
// and the state gradient g_t = dy_t C_t + a_{t+1} g_{t+1} (the last step's
// second term is dh_final):
//
//   dC_t[n]  = sum_d dy_t[d] h_t[d, n]
//   dB_t[n]  = sum_d g_t[d, n] dt_t[d] x_t[d]
//   dx_t[d]  = sum_n g_t[d, n] B_t[n] dt_t[d]
//   ddt_t[d] = sum_n g_t[d, n] h_{t-1}[d, n] a_t[d, n] A[d, n]
//              + (sum_n g_t[d, n] B_t[n]) x_t[d]
//   dA[d, n] = sum_{b, t} g_t[d, n] h_{t-1}[d, n] a_t[d, n] dt_t[d]
//
// What bounds it on Hopper: bytes at best.  At jamba's training shape (4,
// 2048, 8192, 16) it must read x, dt and dy and write dx and ddt (5 x 268
// MB; B, C, A and their gradients are small): 1.34 GB, 0.40 ms at 3.35
// TB/s.  Besides it reads the saved states (268 MB) and writes and reads
// the dB / dC partials (67 MB each way).  Its arithmetic per (b, t, d, n)
// is one expf (a_t, recomputed once from the saved states), about 20 FMA-
// pipe operations and 2.25 shuffles (at N = 16).
//
// Design:
//   * Four states a lane: a channel's N states lie on N / 4 neighbouring
//     lanes of a warp; a block owns 128 channels (64 at N = 32) of one
//     batch row, 512 threads at N = 16, and walks the sequence in chunks of
//     kL = 16 steps from the last.  grid (ceil(di / channels), Bb).
//   * A chunk's x, dt, dy, B and C are staged in shared memory; the next
//     chunk's (and its saved state) are loaded into registers while this
//     one runs, and stored to shared memory when it is done.
//   * The chunk is recomputed forward once from its saved state: a_t
//     (expf, not __expf: the plain version's exp is the accurate one) stays
//     in registers (16 x 4 a thread), the start state and h_t go to shared
//     memory (17 x 128 x 16 floats, 136 KB), each thread's four states one
//     float4.  Then the walk back reads them: g, dA, and the sums below.
//   * sum_n (dx, ddt): each lane sums its four states in registers; gB and
//     gA are reduced over the channel's lanes together (the first round
//     exchanges one value each way, lanes keep gB or gA): 2 shuffles at
//     N = 16.  The lanes holding gB and gA put them in shared memory; after
//     the walk the block writes dx and ddt, coalesced.
//   * sum_d (dB, dC): a lane's 8 values (g dt x and dy h of its 4 states)
//     are reduce-scattered over the warp's channels, halving the values
//     kept each round (7 shuffles at N = 16, one value left a lane); the
//     warps' sums go to shared memory, and after the walk the block adds
//     its 16 warps in order into a partial (Bb, blocks, S, N): 64 blocks a
//     batch row at di 8192.  dA's
//     sum over t stays in registers; its sum over b is a partial (Bb, di,
//     N).  A second kernel adds the partials in a fixed order.  No atomics:
//     two runs on the same inputs give bitwise the same gradients.
//   * S and di are free (channels past di run on zeros, which give zero
//     gradients, and write nothing; steps past S in the last chunk are
//     staged as zeros, keep h, and are skipped by the walk); N is a
//     template parameter (4, 8, 16 or 32).
//
// Ablation builds only (python -m repro_torch.kernels.ablation stages
// --only scan_bwd): -DSCAN_BWD_CUT=1 puts 1 + dt A in expf's place (the
// special-function share); =2 drops the dB / dC sums over d (the
// reduce-scatter, the warps' sums and the partial writes); both outputs
// are wrong.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#ifndef SCAN_BWD_CUT
#define SCAN_BWD_CUT 0
#endif

namespace {

constexpr int kL = 16;    // steps a chunk: the forward's saved-state spacing
constexpr int kSPL = 4;   // states a lane
constexpr unsigned kFull = 0xffffffffu;

template <int N> struct Geo {
  static constexpr int kLanes = N / kSPL;            // lanes a channel
  static constexpr int kCh = N <= 16 ? 128 : 64;     // channels a block
  static constexpr int kThreads = kCh * kLanes;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kCPW = 32 / kLanes;           // channels a warp
  // reduce-scatter rounds over the warp's channels that halve the values a
  // lane keeps (8 -> 8 >> kHalve); the rest add a single value
  static constexpr int kRounds = kCPW == 32 ? 5 : kCPW == 16 ? 4
                                 : kCPW == 8 ? 3 : 2;
  static constexpr int kHalve = kRounds < 3 ? kRounds : 3;
  static constexpr int kKeep = 8 >> kHalve;          // values a lane keeps
  static constexpr int kLog2Lanes = kLanes == 1 ? 0 : kLanes == 2 ? 1
                                    : kLanes == 4 ? 2 : 3;
  // shared memory, floats: h [kL + 1][kCh][N] (the start state, then after
  // each step); x, dt, dy [kL][kCh]; B, C [kL][N]; the warps' dB / dC sums
  // [kL][kWarps][2 N]; gB, gA [kL][kCh]
  static constexpr int kH = 0;
  static constexpr int kX = kH + (kL + 1) * kCh * N;
  static constexpr int kDt = kX + kL * kCh;
  static constexpr int kDy = kDt + kL * kCh;
  static constexpr int kB = kDy + kL * kCh;
  static constexpr int kC = kB + kL * N;
  static constexpr int kRed = kC + kL * N;
  static constexpr int kGB = kRed + kL * kWarps * 2 * N;
  static constexpr int kGA = kGB + kL * kCh;
  static constexpr int kFloats = kGA + kL * kCh;
  // the chunk's x, dt, dy a thread loads ahead (each of the three), and
  // its B and C values
  static constexpr int kAhead = kL * kCh / kThreads;
  static constexpr int kAheadBC = (2 * kL * N + kThreads - 1) / kThreads;
  static_assert(kL * kCh % kThreads == 0, "whole rows a thread");
};
static_assert(Geo<16>::kThreads == 512 && Geo<16>::kFloats * 4 <= 227 * 1024,
              "one block of 512 threads an SM at N = 16");

__device__ __forceinline__ float decay(float dtt, float an) {
#if SCAN_BWD_CUT == 1
  return fmaf(dtt, an, 1.f);
#else
  return expf(dtt * an);
#endif
}

// The next chunk's inputs, held in registers while the current one runs:
// for each of its kAhead slots a thread loads x, dt, dy at (step i,
// channel c) = slot / kCh, slot % kCh; B and C values (B's kL N, then C's,
// kThreads apart); and the saved start state of its four states
template <int N> struct Ahead {
  float x[Geo<N>::kAhead], dt[Geo<N>::kAhead], dy[Geo<N>::kAhead];
  float bc[Geo<N>::kAheadBC];
  float4 h0;
};

template <int N>
__device__ __forceinline__ void load_ahead(
    Ahead<N>& r, const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ dy, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ hbound, int b,
    int ch, int S, int di, int d0, int d, int p) {
  using G = Geo<N>;
  const int t0 = ch * kL, len = min(kL, S - t0);
#pragma unroll
  for (int j = 0; j < G::kAhead; ++j) {
    const int e = threadIdx.x + j * G::kThreads;
    const int i = e / G::kCh, c = e % G::kCh;
    const bool in = i < len && d0 + c < di;
    const size_t off = ((size_t)b * S + t0 + i) * di + d0 + c;
    r.x[j] = in ? x[off] : 0.f;
    r.dt[j] = in ? dt[off] : 0.f;
    r.dy[j] = in ? dy[off] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < G::kAheadBC; ++j) {
    const int e = threadIdx.x + j * G::kThreads, r0 = e % (kL * N);
    const int i = r0 / N, m = r0 % N;
    const float* src = e < kL * N ? Bm : Cm;
    r.bc[j] = (e < 2 * kL * N && i < len)
                  ? src[((size_t)b * S + t0 + i) * N + m] : 0.f;
  }
  r.h0 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ch > 0 && d < di) {
    const int nb = (S + kL - 1) / kL - 1;
    r.h0 = *reinterpret_cast<const float4*>(
        hbound + (((size_t)b * nb + ch - 1) * di + d) * N + kSPL * p);
  }
}

template <int N>
__device__ __forceinline__ void store_ahead(const Ahead<N>& r, float* sm) {
  using G = Geo<N>;
#pragma unroll
  for (int j = 0; j < G::kAhead; ++j) {
    const int e = threadIdx.x + j * G::kThreads;
    sm[G::kX + e] = r.x[j];
    sm[G::kDt + e] = r.dt[j];
    sm[G::kDy + e] = r.dy[j];
  }
#pragma unroll
  for (int j = 0; j < G::kAheadBC; ++j) {
    const int e = threadIdx.x + j * G::kThreads;
    if (e < 2 * kL * N) sm[G::kB + e] = r.bc[j];  // B then C
  }
  // the start state: row 0 of h, this thread's own float4
  reinterpret_cast<float4*>(sm + G::kH)[threadIdx.x] = r.h0;
}

// one reduce-scatter round: of the W values in v, a lane whose partner bit
// (lane & off) is set keeps the upper half and sends the lower, the other
// the reverse; each adds what it receives to what it keeps
template <int W>
__device__ __forceinline__ void scatter_round(float (&v)[8], int off,
                                              bool upper) {
#pragma unroll
  for (int j = 0; j < W / 2; ++j) {
    const float send = upper ? v[j] : v[j + W / 2];
    const float keep = upper ? v[j + W / 2] : v[j];
    v[j] = keep + __shfl_xor_sync(kFull, send, off);
  }
}

template <int N>
__global__ void __launch_bounds__(Geo<N>::kThreads, 1)
scan_backward(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ Bm, const float* __restrict__ Cm,
              const float* __restrict__ A, const float* __restrict__ dy,
              const float* __restrict__ dh_final,
              const float* __restrict__ hbound, float* __restrict__ dx,
              float* __restrict__ ddt, float* __restrict__ part_dB,
              float* __restrict__ part_dC, float* __restrict__ part_dA,
              int S, int di) {
  using G = Geo<N>;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid / G::kLanes, p = tid % G::kLanes;  // channel, lane in it
  const int d0 = blockIdx.x * G::kCh, d = d0 + c;
  const int b = blockIdx.y;
  const bool live = d < di;
  const int nC = (S + kL - 1) / kL;
  float an[kSPL], g[kSPL], dA[kSPL];
#pragma unroll
  for (int s = 0; s < kSPL; ++s) {
    const size_t state = (size_t)d * N + kSPL * p + s;
    an[s] = live ? A[state] : 0.f;
    g[s] = (live && dh_final != nullptr) ? dh_final[(size_t)b * di * N + state]
                                         : 0.f;
    dA[s] = 0.f;
  }

  // h [kL + 1][kCh][kLanes] float4s: row i + 1 after step i, row 0 the start
  float4* hsm = reinterpret_cast<float4*>(sm + G::kH);
  // where this lane's sums go: gB or gA (lanes 0 and 1 of a channel), and
  // the dB / dC values it holds after the reduce-scatter (value base + j,
  // base from its lane bits: kind (0 dB, 1 dC) = index / 4, state kSPL p
  // + index % 4; lanes past the halving rounds hold copies and write none)
  float* gsum = sm + (p == 0 ? G::kGB : G::kGA) + c;
  int base = 0;
#pragma unroll
  for (int r = 0; r < G::kHalve; ++r)
    base += (lane & (G::kLanes << r)) ? (8 >> (r + 1)) : 0;
  const bool writer =
      G::kRounds <= 3 || (lane >> (G::kHalve + G::kLog2Lanes)) == 0;
  float* red_lane = sm + G::kRed + warp * 2 * N + (base >> 2) * N +
                    kSPL * p + (base & 3);
  Ahead<N> nxt;
  load_ahead<N>(nxt, x, dt, dy, Bm, Cm, hbound, b, nC - 1, S, di, d0, d, p);
  for (int ch = nC - 1; ch >= 0; --ch) {
    const int t0 = ch * kL, len = min(kL, S - t0);
    __syncthreads();   // the last chunk's staging and sums are consumed
    store_ahead<N>(nxt, sm);
    __syncthreads();
    if (ch > 0)
      load_ahead<N>(nxt, x, dt, dy, Bm, Cm, hbound, b, ch - 1, S, di, d0, d,
                    p);

    // the chunk forward from its saved state: a_t in registers, h_t in
    // shared memory
    float as[kL][kSPL];
    float h[kSPL];
    {
      const float4 v = hsm[tid];
      h[0] = v.x; h[1] = v.y; h[2] = v.z; h[3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < kL; ++i) {
      const float dtt = sm[G::kDt + i * G::kCh + c];
      const float dtx = dtt * sm[G::kX + i * G::kCh + c];
      const float4 B4 =
          *reinterpret_cast<const float4*>(sm + G::kB + i * N + kSPL * p);
      const float Bv[kSPL] = {B4.x, B4.y, B4.z, B4.w};
#pragma unroll
      for (int s = 0; s < kSPL; ++s) {
        as[i][s] = decay(dtt, an[s]);
        h[s] = as[i][s] * h[s] + dtx * Bv[s];
      }
      hsm[(i + 1) * G::kThreads + tid] = make_float4(h[0], h[1], h[2], h[3]);
    }

    // the walk back; hc = h_t (after step t; the padding steps past S keep
    // h, so the last computed state is h after the chunk's last real step)
    float hc[kSPL] = {h[0], h[1], h[2], h[3]};
#pragma unroll
    for (int i = kL - 1; i >= 0; --i) {
      float hp[kSPL];   // h_{t-1}
      {
        const float4 v = hsm[i * G::kThreads + tid];
        hp[0] = v.x; hp[1] = v.y; hp[2] = v.z; hp[3] = v.w;
      }
      if (i < len) {
        const float dtt = sm[G::kDt + i * G::kCh + c];
        const float xt = sm[G::kX + i * G::kCh + c];
        const float dyt = sm[G::kDy + i * G::kCh + c];
        const float4 B4 =
            *reinterpret_cast<const float4*>(sm + G::kB + i * N + kSPL * p);
        const float4 C4 =
            *reinterpret_cast<const float4*>(sm + G::kC + i * N + kSPL * p);
        const float Bv[kSPL] = {B4.x, B4.y, B4.z, B4.w};
        const float Cv[kSPL] = {C4.x, C4.y, C4.z, C4.w};
        const float dtx = dtt * xt;
        float gB = 0.f, gA = 0.f;
        float v[8];
#pragma unroll
        for (int s = 0; s < kSPL; ++s) {
          g[s] = dyt * Cv[s] + g[s];
          const float gha = g[s] * hp[s] * as[i][s];
          dA[s] += gha * dtt;
          gB += g[s] * Bv[s];
          gA += gha * an[s];
          v[s] = g[s] * dtx;          // dB's term
          v[kSPL + s] = dyt * hc[s];  // dC's term
          g[s] = as[i][s] * g[s];
        }
        // sum_n over the channel's lanes: the first round sends gA from
        // even lanes and gB from odd ones, so even lanes keep gB, odd gA
        float gv = gB;
        if constexpr (G::kLanes > 1) {
          const bool odd = p & 1;
          gv = (odd ? gA : gB) + __shfl_xor_sync(kFull, odd ? gB : gA, 1);
#pragma unroll
          for (int off = 2; off < G::kLanes; off <<= 1)
            gv += __shfl_xor_sync(kFull, gv, off);
          if (p < 2) gsum[i * G::kCh] = gv;
        } else {
          sm[G::kGB + i * G::kCh + c] = gB;
          sm[G::kGA + i * G::kCh + c] = gA;
        }
#if SCAN_BWD_CUT != 2
        // sum_d over the warp's channels: reduce-scatter, then add
#pragma unroll
        for (int r = 0; r < G::kRounds; ++r) {
          const int off = G::kLanes << r;
          const bool upper = (lane & off) != 0;
          if (r == 0) scatter_round<8>(v, off, upper);
          if (r == 1 && G::kHalve > 1) scatter_round<4>(v, off, upper);
          if (r == 2 && G::kHalve > 2) scatter_round<2>(v, off, upper);
          if (r >= G::kHalve) v[0] += __shfl_xor_sync(kFull, v[0], off);
        }
        // v[j] is value base + j (kKeep values: consecutive states)
        if (writer) {
#pragma unroll
          for (int j = 0; j < G::kKeep; ++j)
            red_lane[i * G::kWarps * 2 * N + j] = v[j];
        }
#endif
      }
#pragma unroll
      for (int s = 0; s < kSPL; ++s) hc[s] = hp[s];
    }
    __syncthreads();

    // dx, ddt of the chunk, coalesced; the block's dB, dC sums over its
    // warps, in order
    for (int e = tid; e < len * G::kCh; e += G::kThreads) {
      const int i = e / G::kCh, cc = e % G::kCh;
      if (d0 + cc >= di) continue;
      const float gBv = sm[G::kGB + e], gAv = sm[G::kGA + e];
      const size_t off = ((size_t)b * S + t0 + i) * di + d0 + cc;
      dx[off] = gBv * sm[G::kDt + e];
      ddt[off] = gAv + gBv * sm[G::kX + e];
    }
#if SCAN_BWD_CUT != 2
    for (int e = tid; e < len * 2 * N; e += G::kThreads) {
      const int i = e / (2 * N), kn = e % (2 * N);
      const float* red = sm + G::kRed + i * G::kWarps * 2 * N + kn;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < G::kWarps; ++w) sum += red[w * 2 * N];
      float* part = kn < N ? part_dB : part_dC;
      part[(((size_t)b * gridDim.x + blockIdx.x) * S + t0 + i) * N +
           kn % N] = sum;
    }
#endif
  }
  if (live)
    *reinterpret_cast<float4*>(part_dA + ((size_t)b * di + d) * N +
                               kSPL * p) = make_float4(dA[0], dA[1], dA[2],
                                                       dA[3]);
}

// dB, dC (Bb, S, N): the partials summed over the channel blocks in order;
// dA (di, N): summed over the batch in order
__global__ void __launch_bounds__(256)
reduce_partials(const float* __restrict__ part_dB,
                const float* __restrict__ part_dC,
                const float* __restrict__ part_dA, float* __restrict__ dB,
                float* __restrict__ dC, float* __restrict__ dA, int Bb,
                int S, int N, int blocks, int di) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t per_b = (size_t)S * N;
  if (e < (size_t)Bb * per_b) {
    const size_t b = e / per_b, r = e % per_b;
    const float* pb = part_dB + b * blocks * per_b + r;
    const float* pc = part_dC + b * blocks * per_b + r;
    float vb = 0.f, vc = 0.f;
    for (int k = 0; k < blocks; ++k) {
      vb += pb[(size_t)k * per_b];
      vc += pc[(size_t)k * per_b];
    }
    dB[e] = vb;
    dC[e] = vc;
  }
  const size_t per_a = (size_t)di * N;
  if (e < per_a) {
    float va = 0.f;
    for (int b = 0; b < Bb; ++b) va += part_dA[(size_t)b * per_a + e];
    dA[e] = va;
  }
}

template <int N>
int launch(const float* x, const float* dt, const float* Bm, const float* Cm,
           const float* A, const float* dy, const float* dh,
           const float* hbound, float* dx, float* ddt, float* dB, float* dC,
           float* dA, float* part_dB, float* part_dC, float* part_dA, int Bb,
           int S, int di, cudaStream_t stream) {
  using G = Geo<N>;
  const int blocks = (di + G::kCh - 1) / G::kCh;
  const int smem = G::kFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      scan_backward<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  scan_backward<N><<<dim3(blocks, Bb), G::kThreads, smem, stream>>>(
      x, dt, Bm, Cm, A, dy, dh, hbound, dx, ddt, part_dB, part_dC, part_dA,
      S, di);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t work = (size_t)Bb * S * N > (size_t)di * N
                          ? (size_t)Bb * S * N : (size_t)di * N;
  reduce_partials<<<(unsigned)((work + 255) / 256), 256, 0, stream>>>(
      part_dB, part_dC, part_dA, dB, dC, dA, Bb, S, N, blocks, di);
  return (int)cudaGetLastError();
}

template <class F>
int with_state_size(int N, F f) {
  switch (N) {
    case 4: return f(std::integral_constant<int, 4>());
    case 8: return f(std::integral_constant<int, 8>());
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// the scratch the wrapper allocates: steps between saved states and
// channels a block at state size N (-1 for an N the kernel is not
// instantiated for)
extern "C" int mamba_scan_backward_geometry(int N, int* chunk,
                                            int* channels) {
  *chunk = kL;
  *channels = -1;
  return with_state_size(N, [&](auto n) {
    *channels = Geo<decltype(n)::value>::kCh;
    return 0;
  });
}

extern "C" int mamba_scan_backward_f32(
    const void* x, const void* dt, const void* Bm, const void* Cm,
    const void* A, const void* dy, const void* dh_final, const void* hbound,
    void* dx, void* ddt, void* dB, void* dC, void* dA, void* part_dB,
    void* part_dC, void* part_dA, int Bb, int S, int di, int N,
    void* stream) {
  if (Bb <= 0 || Bb > 65535 || S <= 0 || di <= 0 ||
      (hbound == nullptr && S > kL))
    return (int)cudaErrorInvalidValue;
  return with_state_size(N, [&](auto n) {
    return launch<decltype(n)::value>(
        (const float*)x, (const float*)dt, (const float*)Bm,
        (const float*)Cm, (const float*)A, (const float*)dy,
        (const float*)dh_final, (const float*)hbound, (float*)dx,
        (float*)ddt, (float*)dB, (float*)dC, (float*)dA, (float*)part_dB,
        (float*)part_dC, (float*)part_dA, Bb, S, di, (cudaStream_t)stream);
  });
}
