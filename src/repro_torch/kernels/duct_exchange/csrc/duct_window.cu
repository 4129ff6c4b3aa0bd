// Fused dense-layout duct window: push-apply -> drain -> halo select.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/duct_exchange/kernel.py:_window_kernel
// (launched by duct_window_kernel), which sweeps a block of receivers'
// (d, C) ring tiles in VMEM.  Plain version: ops.duct_window_torch.
//
// What bounds it on Hopper: bytes.  The work is integer compares and
// copies, a handful of operations per ring slot, so the least time is the
// ring state read once and written once: (4 + 4 + 4L) bytes per slot each
// way over R = n*d rings of C slots, plus the (n, d) and (n, 4, L) side
// arrays.  At the 4096-process torus (R = 16384, C = 64, L = 1) that is
// about 12.6 MB each way.
//
// Design (simple first; making it fast is later work):
//   * one block holds whole receivers: per_block = max(1, 256 / d)
//     receivers, one thread per ring row (receiver i, in-edge j);
//   * phase 1, per row: copy the ring row to the outputs, apply the staged
//     (already accepted) push at push_pos, pop the longest available FIFO
//     prefix (head-blocking, capped at max_pops, only if the receiver is
//     active), write +inf into popped slots, advance head and size, and
//     record the pop count and the freshest popped slot in shared memory;
//   * __syncthreads(), then phase 2, one thread per (receiver, halo slot
//     s): the highest delivering row j with j % 4 == s wins; its freshest
//     payload (read back from this block's own output ring) goes to
//     halo_pay, else zeros and halo_win = false.  The winner's payload is
//     copied: the Pallas kernel sums a one-hot over the ring slots, which
//     agrees bit for bit except that it turns a float -0.0 into +0.0; the
//     copy keeps -0.0.
// Payloads are int32 (graph coloring, duct_window_i32) or float32 (evo,
// duct_window_f32).  At evo's torus-1024 shape (n = 1024, d = 4, C = 64,
// L = 60) the float32 ring payload alone is 62.9 MB, and with avail/touch
// about 65 MB each way, ~130 MB: ~39 us at 3.35 TB/s.
// The slot arithmetic is a floor-mod, as in JAX and torch: C++ `%`
// truncates toward zero, so every ring index goes through floor_mod.
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ int floor_mod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

template <typename P>
__global__ void duct_window_kernel(
    const float* __restrict__ q_avail, const int* __restrict__ q_touch,
    const P* __restrict__ q_pay, const int* __restrict__ head,
    const int* __restrict__ size, const int* __restrict__ push_pos,
    const bool* __restrict__ push_acc, const float* __restrict__ push_avail,
    const int* __restrict__ push_touch, const P* __restrict__ push_pay,
    const float* __restrict__ recv_now, const bool* __restrict__ recv_active,
    float* __restrict__ qa_out, int* __restrict__ qt_out,
    P* __restrict__ qp_out, int* __restrict__ head_out,
    int* __restrict__ size_out, int* __restrict__ drained_out,
    int* __restrict__ rtouch_out, P* __restrict__ hpay_out,
    bool* __restrict__ hwin_out,
    int n, int d, int C, int L, int max_pops, int per_block) {
  extern __shared__ int smem[];
  const int rows_blk = per_block * d;
  int* s_dr = smem;                 // pops per row of this block
  int* s_fresh = smem + rows_blk;   // freshest popped slot per row
  const int i0 = blockIdx.x * per_block;
  const int t = threadIdx.x;

  // ---- phase 1: one thread per ring row ---------------------------------
  if (t < rows_blk && i0 + t / d < n) {
    const int i = i0 + t / d;
    const long long row = (long long)i0 * d + t;
    const float* a_in = q_avail + row * C;
    const int* t_in = q_touch + row * C;
    const P* p_in = q_pay + row * C * L;
    float* a = qa_out + row * C;
    int* tc = qt_out + row * C;
    P* p = qp_out + row * C * L;
    for (int c = 0; c < C; ++c) {
      a[c] = a_in[c];
      tc[c] = t_in[c];
    }
    for (long long k = 0; k < (long long)C * L; ++k) p[k] = p_in[k];
    // push: the send was accepted at stage time and size already counts it
    const int pp = push_pos[row];
    if (push_acc[row] && pp >= 0 && pp < C) {
      a[pp] = push_avail[row];
      tc[pp] = push_touch[row];
      for (int l = 0; l < L; ++l) p[(long long)pp * L + l] = push_pay[row * L + l];
    }
    // drain: longest available FIFO prefix, head-blocking, bounded
    const int h = head[row];
    const int sz = size[row];
    int dr = 0;
    if (recv_active[i]) {
      const float now = recv_now[i];
      const int lim = min(sz, max_pops);
      while (dr < lim && !(a[floor_mod(h + dr, C)] > now)) ++dr;
    }
    const int fresh = floor_mod(h + dr - 1, C);
    rtouch_out[row] = dr > 0 ? tc[fresh] : 0;
    for (int k = 0; k < dr; ++k) a[floor_mod(h + k, C)] = INFINITY;
    head_out[row] = floor_mod(h + dr, C);
    size_out[row] = sz - dr;
    drained_out[row] = dr;
    s_dr[t] = dr;
    s_fresh[t] = fresh;
  }
  __syncthreads();

  // ---- phase 2: one thread per (receiver, halo slot) --------------------
  for (int u = t; u < per_block * 4; u += blockDim.x) {
    const int li = u / 4;
    const int s = u % 4;
    const int i = i0 + li;
    if (i >= n) continue;
    int win = -1;
    for (int j = s; j < d; j += 4)
      if (s_dr[li * d + j] > 0) win = j;
    P* hp = hpay_out + ((long long)i * 4 + s) * L;
    if (win >= 0) {
      const long long row = (long long)i * d + win;
      const P* src = qp_out + (row * C + s_fresh[li * d + win]) * L;
      for (int l = 0; l < L; ++l) hp[l] = src[l];
    } else {
      for (int l = 0; l < L; ++l) hp[l] = P(0);
    }
    hwin_out[(long long)i * 4 + s] = win >= 0;
  }
}

template <typename P>
int launch(const void* q_avail, const void* q_touch, const void* q_pay,
           const void* head, const void* size, const void* push_pos,
           const void* push_acc, const void* push_avail,
           const void* push_touch, const void* push_pay,
           const void* recv_now, const void* recv_active,
           void* qa_out, void* qt_out, void* qp_out, void* head_out,
           void* size_out, void* drained_out, void* rtouch_out,
           void* hpay_out, void* hwin_out,
           int n, int d, int C, int L, int max_pops, void* stream) {
  if (n <= 0 || d <= 0 || d > 1024 || C <= 0 || L <= 0)
    return (int)cudaErrorInvalidValue;
  int per_block = 256 / d;
  if (per_block < 1) per_block = 1;
  if (per_block > n) per_block = n;
  const int grid = (n + per_block - 1) / per_block;
  const int threads = per_block * d;
  const size_t smem = 2 * sizeof(int) * (size_t)threads;
  duct_window_kernel<P><<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)q_avail, (const int*)q_touch, (const P*)q_pay,
      (const int*)head, (const int*)size, (const int*)push_pos,
      (const bool*)push_acc, (const float*)push_avail,
      (const int*)push_touch, (const P*)push_pay, (const float*)recv_now,
      (const bool*)recv_active, (float*)qa_out, (int*)qt_out, (P*)qp_out,
      (int*)head_out, (int*)size_out, (int*)drained_out, (int*)rtouch_out,
      (P*)hpay_out, (bool*)hwin_out, n, d, C, L, max_pops, per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// int32 payloads (graph coloring).
extern "C" int duct_window_i32(
    const void* q_avail, const void* q_touch, const void* q_pay,
    const void* head, const void* size, const void* push_pos,
    const void* push_acc, const void* push_avail, const void* push_touch,
    const void* push_pay, const void* recv_now, const void* recv_active,
    void* qa_out, void* qt_out, void* qp_out, void* head_out,
    void* size_out, void* drained_out, void* rtouch_out, void* hpay_out,
    void* hwin_out, int n, int d, int C, int L, int max_pops,
    void* stream) {
  return launch<int>(q_avail, q_touch, q_pay, head, size, push_pos,
                     push_acc, push_avail, push_touch, push_pay, recv_now,
                     recv_active, qa_out, qt_out, qp_out, head_out,
                     size_out, drained_out, rtouch_out, hpay_out, hwin_out,
                     n, d, C, L, max_pops, stream);
}

// float32 payloads (evo).
extern "C" int duct_window_f32(
    const void* q_avail, const void* q_touch, const void* q_pay,
    const void* head, const void* size, const void* push_pos,
    const void* push_acc, const void* push_avail, const void* push_touch,
    const void* push_pay, const void* recv_now, const void* recv_active,
    void* qa_out, void* qt_out, void* qp_out, void* head_out,
    void* size_out, void* drained_out, void* rtouch_out, void* hpay_out,
    void* hwin_out, int n, int d, int C, int L, int max_pops,
    void* stream) {
  return launch<float>(q_avail, q_touch, q_pay, head, size, push_pos,
                       push_acc, push_avail, push_touch, push_pay, recv_now,
                       recv_active, qa_out, qt_out, qp_out, head_out,
                       size_out, drained_out, rtouch_out, hpay_out,
                       hwin_out, n, d, C, L, max_pops, stream);
}
