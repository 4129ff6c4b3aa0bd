// Superstep ring commit: fold each ring's compact pushbuf into its tail.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/duct_exchange/kernel.py:_commit_kernel
// (launched by duct_commit_kernel), once per W-window superstep.  Plain
// version: ops.duct_commit_torch.
//
// What bounds it on Hopper: bytes.  Every ring slot is read and written
// once ((4 + 4 + 4L) bytes each way per slot over R rings of C slots) plus
// the (R, W) pushbuf read once; the per-slot work is one floor-mod and a
// compare.
//
// Design (simple first): one thread per (ring r, slot c).  The slot's
// pushbuf index is j = (c - head[r] - size0[r]) mod C (a floor-mod: C++
// `%` truncates toward zero); slots with j < pb_cnt[r] take pushbuf entry
// j, every other slot keeps its value bit for bit.  pb_cnt <= W holds on
// the engine's path; j is clamped to W - 1 like the plain version's
// gather, so both agree on any input.  Payloads are copied, int32 (graph
// coloring, duct_commit_i32) or float32 (evo, duct_commit_f32).  At evo's
// torus-1024 shape (R = 4096, C = 64, W = 8, L = 60) the rings and the
// pushbuf are ~138 MB read and written together, ~41 us at 3.35 TB/s.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int floor_mod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

template <typename P>
__global__ void duct_commit_kernel(
    const float* __restrict__ q_avail, const int* __restrict__ q_touch,
    const P* __restrict__ q_pay, const int* __restrict__ head,
    const int* __restrict__ size0, const int* __restrict__ pb_cnt,
    const float* __restrict__ pb_avail, const int* __restrict__ pb_touch,
    const P* __restrict__ pb_pay, float* __restrict__ qa_out,
    int* __restrict__ qt_out, P* __restrict__ qp_out,
    long long R, int C, int W, int L) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= R * C) return;
  const long long r = idx / C;
  const int c = (int)(idx - r * C);
  const int j = floor_mod(c - head[r] - size0[r], C);
  if (j < pb_cnt[r]) {
    const long long src = r * W + (j < W ? j : W - 1);
    qa_out[idx] = pb_avail[src];
    qt_out[idx] = pb_touch[src];
    for (int l = 0; l < L; ++l) qp_out[idx * L + l] = pb_pay[src * L + l];
  } else {
    qa_out[idx] = q_avail[idx];
    qt_out[idx] = q_touch[idx];
    for (int l = 0; l < L; ++l) qp_out[idx * L + l] = q_pay[idx * L + l];
  }
}

template <typename P>
int launch(const void* q_avail, const void* q_touch, const void* q_pay,
           const void* head, const void* size0, const void* pb_cnt,
           const void* pb_avail, const void* pb_touch, const void* pb_pay,
           void* qa_out, void* qt_out, void* qp_out, long long R, int C,
           int W, int L, void* stream) {
  if (R <= 0 || C <= 0 || W <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (R * C + threads - 1) / threads;
  duct_commit_kernel<P><<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      (const float*)q_avail, (const int*)q_touch, (const P*)q_pay,
      (const int*)head, (const int*)size0, (const int*)pb_cnt,
      (const float*)pb_avail, (const int*)pb_touch, (const P*)pb_pay,
      (float*)qa_out, (int*)qt_out, (P*)qp_out, R, C, W, L);
  return (int)cudaGetLastError();
}

}  // namespace

// int32 payloads (graph coloring).
extern "C" int duct_commit_i32(
    const void* q_avail, const void* q_touch, const void* q_pay,
    const void* head, const void* size0, const void* pb_cnt,
    const void* pb_avail, const void* pb_touch, const void* pb_pay,
    void* qa_out, void* qt_out, void* qp_out, long long R, int C, int W,
    int L, void* stream) {
  return launch<int>(q_avail, q_touch, q_pay, head, size0, pb_cnt, pb_avail,
                     pb_touch, pb_pay, qa_out, qt_out, qp_out, R, C, W, L,
                     stream);
}

// float32 payloads (evo).
extern "C" int duct_commit_f32(
    const void* q_avail, const void* q_touch, const void* q_pay,
    const void* head, const void* size0, const void* pb_cnt,
    const void* pb_avail, const void* pb_touch, const void* pb_pay,
    void* qa_out, void* qt_out, void* qp_out, long long R, int C, int W,
    int L, void* stream) {
  return launch<float>(q_avail, q_touch, q_pay, head, size0, pb_cnt,
                       pb_avail, pb_touch, pb_pay, qa_out, qt_out, qp_out, R,
                       C, W, L, stream);
}
