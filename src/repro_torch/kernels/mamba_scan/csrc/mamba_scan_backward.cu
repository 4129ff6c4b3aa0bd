// Mamba-1 selective scan, float32: the backward.
//
// Replaces no Pallas kernel: the reference differentiates its jnp scan
// with jax.grad (src/repro/models/ssm.py:mamba_forward), and its Pallas
// kernel src/repro/kernels/mamba_scan/kernel.py:_mamba_kernel has no
// backward.  This is the gradient of mamba_scan_ref (and of the forward
// kernels in mamba_scan.cu).  Plain version: ops.mamba_scan_backward_torch.
// Inputs x, dt, dy (Bb, S, di), B, C (Bb, S, N), A (di, N), dh_final (Bb,
// di, N) or null (zero); outputs dx, ddt (Bb, S, di), dB, dC (Bb, S, N),
// dA (di, N), all float32, contiguous.  With a_t = exp(dt_t A) and the
// state gradient g_t = dy_t C_t + a_{t+1} g_{t+1} (the last step's second
// term is dh_final):
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
// TB/s.  It does more work than the forward: each (b, t, d, n) recomputes
// a_t twice (an expf in each of the two passes below), and the sums over n
// and over d are shuffles.
//
// Design (simple first; no TMA, no overlap):
//   * A thread owns one (b, channel d, state n): N lanes a channel, 256 / N
//     channels a block (16 at N = 16), grid (ceil(di / (256 / N)), Bb).
//     sum_n is a shuffle over the channel's N lanes; a sum over the warp's
//     channels a shuffle over the rest of the warp.
//   * A chunk's x, dt, dy, B and C are staged in shared memory by the whole
//     block before its steps run, every load issued at once: a step that
//     waited on its own loads would be bound by their latency.
//   * The reverse pass needs h_{t-1} backwards in time.  Inverting the
//     recurrence, h_{t-1} = (h_t - b_t) / a_t, is unstable where a_t is
//     small, so h is recomputed in chunks of kL = 16 steps: pass 1 runs the
//     recurrence forward and writes h at each chunk's end to a scratch
//     tensor (Bb, ceil(S / kL), di, N); pass 2 walks the chunks from the
//     last, recomputes the chunk's h_t and a_t from its boundary into
//     registers (2 x kL a thread), then walks the chunk back.  Each thread
//     reads back only what it wrote itself, so one kernel runs both passes.
//   * dx and ddt are written by each channel's lane 0.  dB and dC are sums
//     over d across blocks: each warp's sum goes to shared memory, the
//     block's sum over its 8 warps to a partial (Bb, blocks, S, N) once a
//     chunk; dA's sum over b is a partial (Bb, di, N).  A second kernel adds
//     the partials in a fixed order.  No atomics: two runs on the same
//     inputs give bitwise the same gradients.
//   * expf, not __expf: the plain version's exp is the accurate one.  S and
//     di are free (channels past di run on zeros, which give zero
//     gradients, and write nothing); N is a template parameter (4, 8, 16
//     or 32).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kL = 16;  // steps of a chunk, h and a_t held in registers

// sum over the N lanes of one channel (lanes [N c, N c + N) of the warp)
template <int N>
__device__ __forceinline__ float sum_states(float v) {
#pragma unroll
  for (int off = 1; off < N; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// sum over the 32 / N channels of the warp, state by state
template <int N>
__device__ __forceinline__ float sum_channels(float v) {
#pragma unroll
  for (int off = N; off < 32; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// stage steps [t0, t0 + len) of the block's channels into shared memory:
// x, dt (and dy when with_dy) as [step][channel], B (and C) as [step][n];
// every load of the chunk is issued before any is waited for
template <int N, bool with_dy>
__device__ __forceinline__ void stage(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ dy, const float* __restrict__ Bm,
    const float* __restrict__ Cm, float (*sx)[kThreads / N],
    float (*sdt)[kThreads / N], float (*sdy)[kThreads / N], float (*sBt)[N],
    float (*sCt)[N], int b, int S, int di, int t0, int len) {
  constexpr int kCh = kThreads / N;
  const int d0 = blockIdx.x * kCh;
  for (int e = threadIdx.x; e < kL * kCh; e += kThreads) {
    const int i = e / kCh, c = e % kCh;
    const bool in = i < len && d0 + c < di;
    const size_t off = ((size_t)b * S + t0 + i) * di + d0 + c;
    sx[i][c] = in ? x[off] : 0.f;
    sdt[i][c] = in ? dt[off] : 0.f;
    if (with_dy) sdy[i][c] = in ? dy[off] : 0.f;
  }
  for (int e = threadIdx.x; e < kL * N; e += kThreads) {
    const int i = e / N, m = e % N;
    const size_t off = ((size_t)b * S + t0 + i) * N + m;
    sBt[i][m] = i < len ? Bm[off] : 0.f;
    if (with_dy) sCt[i][m] = i < len ? Cm[off] : 0.f;
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
scan_backward(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ Bm, const float* __restrict__ Cm,
              const float* __restrict__ A, const float* __restrict__ dy,
              const float* __restrict__ dh_final, float* __restrict__ dx,
              float* __restrict__ ddt, float* __restrict__ hbound,
              float* __restrict__ part_dB, float* __restrict__ part_dC,
              float* __restrict__ part_dA, int S, int di) {
  constexpr int kCh = kThreads / N;  // channels a block
  __shared__ float sx[kL][kCh], sdt[kL][kCh], sdy[kL][kCh];
  __shared__ float sBt[kL][N], sCt[kL][N];
  __shared__ float pB[kL][kWarps][N], pC[kL][kWarps][N];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = tid % N, c = tid / N;
  const int d = blockIdx.x * kCh + c;
  const int b = blockIdx.y;
  const bool live = d < di;
  const int nC = (S + kL - 1) / kL;
  const float an = live ? A[(size_t)d * N + n] : 0.f;
  const size_t row = (size_t)b * S * di + d;       // (b, 0, d)
  // (b, c, d, n) of the boundary scratch (Bb, nC, di, N), c = 0
  float* hb = hbound + ((size_t)b * nC * di + d) * N + n;
  const size_t hstride = (size_t)di * N;

  // pass 1: h at the end of every chunk but the last
  float h = 0.f;
  for (int ch = 0; ch + 1 < nC; ++ch) {
    __syncthreads();   // the previous chunk's stage is consumed
    stage<N, false>(x, dt, dy, Bm, Cm, sx, sdt, sdy, sBt, sCt, b, S, di,
                    ch * kL, kL);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kL; ++i)
      h = expf(sdt[i][c] * an) * h + (sdt[i][c] * sx[i][c]) * sBt[i][n];
    if (live) hb[ch * hstride] = h;
  }

  // pass 2: the chunks from the last, each recomputed from its boundary
  const size_t state = ((size_t)b * di + d) * N + n;  // (b, d, n)
  float g = (live && dh_final != nullptr) ? dh_final[state] : 0.f;
  float dA_acc = 0.f;
  for (int ch = nC - 1; ch >= 0; --ch) {
    const int t0 = ch * kL, len = min(kL, S - t0);
    __syncthreads();   // the previous chunk's stage and partials are consumed
    stage<N, true>(x, dt, dy, Bm, Cm, sx, sdt, sdy, sBt, sCt, b, S, di, t0,
                   len);
    const float hp = (ch == 0 || !live) ? 0.f : hb[(ch - 1) * hstride];
    __syncthreads();
    float hs[kL], as[kL];
    float hc = hp;
#pragma unroll
    for (int i = 0; i < kL; ++i) {
      const float at = expf(sdt[i][c] * an);
      hc = at * hc + (sdt[i][c] * sx[i][c]) * sBt[i][n];
      hs[i] = hc;
      as[i] = at;
    }
#pragma unroll
    for (int i = kL - 1; i >= 0; --i) {
      if (i < len) {
        const size_t t = (size_t)(t0 + i);
        const float xt = sx[i][c], dtt = sdt[i][c], dyt = sdy[i][c];
        const float Bt = sBt[i][n];
        g = dyt * sCt[i][n] + g;
        const float hprev = i > 0 ? hs[i - 1] : hp;
        const float gha = g * hprev * as[i];
        dA_acc += gha * dtt;
        const float gB = sum_states<N>(g * Bt);
        const float gA = sum_states<N>(gha * an);
        if (live && n == 0) {
          dx[row + t * di] = gB * dtt;
          ddt[row + t * di] = gA + gB * xt;
        }
        const float cB = sum_channels<N>(g * (dtt * xt));
        const float cC = sum_channels<N>(dyt * hs[i]);
        if (lane < N) {
          pB[i][warp][n] = cB;
          pC[i][warp][n] = cC;
        }
        g = as[i] * g;
      }
    }
    __syncthreads();
    for (int e = tid; e < len * N; e += kThreads) {
      const int i = e / N, m = e % N;
      float vb = 0.f, vc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        vb += pB[i][w][m];
        vc += pC[i][w][m];
      }
      const size_t off =
          (((size_t)b * gridDim.x + blockIdx.x) * S + t0 + i) * N + m;
      part_dB[off] = vb;
      part_dC[off] = vc;
    }
  }
  if (live) part_dA[state] = dA_acc;
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
           const float* A, const float* dy, const float* dh, float* dx,
           float* ddt, float* dB, float* dC, float* dA, float* hbound,
           float* part_dB, float* part_dC, float* part_dA, int Bb, int S,
           int di, cudaStream_t stream) {
  constexpr int kCh = kThreads / N;
  const int blocks = (di + kCh - 1) / kCh;
  scan_backward<N><<<dim3(blocks, Bb), kThreads, 0, stream>>>(
      x, dt, Bm, Cm, A, dy, dh, dx, ddt, hbound, part_dB, part_dC, part_dA,
      S, di);
  cudaError_t err = cudaGetLastError();
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

// the scratch the wrapper allocates: chunk steps and channels a block at
// state size N (-1 for an N the kernel is not instantiated for)
extern "C" int mamba_scan_backward_geometry(int N, int* chunk,
                                            int* channels) {
  *chunk = kL;
  *channels = -1;
  return with_state_size(N, [&](auto n) {
    *channels = kThreads / decltype(n)::value;
    return 0;
  });
}

extern "C" int mamba_scan_backward_f32(
    const void* x, const void* dt, const void* Bm, const void* Cm,
    const void* A, const void* dy, const void* dh_final, void* dx, void* ddt,
    void* dB, void* dC, void* dA, void* hbound, void* part_dB, void* part_dC,
    void* part_dA, int Bb, int S, int di, int N, void* stream) {
  if (Bb <= 0 || Bb > 65535 || S <= 0 || di <= 0)
    return (int)cudaErrorInvalidValue;
  return with_state_size(N, [&](auto n) {
    return launch<decltype(n)::value>(
        (const float*)x, (const float*)dt, (const float*)Bm,
        (const float*)Cm, (const float*)A, (const float*)dy,
        (const float*)dh_final, (float*)dx, (float*)ddt, (float*)dB,
        (float*)dC, (float*)dA, (float*)hbound, (float*)part_dB,
        (float*)part_dC, (float*)part_dA, Bb, S, di, (cudaStream_t)stream);
  });
}
