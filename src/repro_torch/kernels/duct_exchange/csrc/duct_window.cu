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
// about 12.6 MB each way, 7.7 us at 3.35 TB/s; at evo's torus-1024 shape
// (n = 1024, d = 4, C = 64, L = 60) the float32 ring payload alone is 62.9
// MB, with avail/touch about 65 MB each way: 39 us.
//
// Design: a warp per ring row (receiver i, in-edge j), so neighbouring
// lanes touch neighbouring addresses.
//   * a block holds whole receivers: 8 / d receivers and a warp a row for
//     d <= 8; for d > 8 one receiver, min(d, 32) warps, each warp looping
//     over rows j, j + warps, ...  (any d up to 1024);
//   * the drain by ballots: lane l tests "slot (h + j) % C is available
//     and j < min(size, max_pops)" for j = l, l + 32, ...; the pop count
//     dr is the first failure (__ballot_sync, __ffs), one round of 32
//     slots at a time;
//   * every output byte is written once: avail and touch slot by slot
//     (the pushed slot's from push_avail / push_touch, popped slots +inf),
//     the C*L payload as 16-byte vectors when C*L % 4 == 0 and both rings
//     are 16-byte aligned (4-byte words otherwise), the pushed slot's L
//     words taken from push_pay inside the same copy;
//   * each row's dr and freshest popped slot go to shared memory; after
//     one __syncthreads, a warp per (receiver, halo slot s) picks the
//     highest delivering row j with j % 4 == s and copies its freshest
//     payload from the input ring, or from push_pay when that slot is the
//     pushed one (never from this block's own output), else zeros.
// The winner's payload is copied: the Pallas kernel sums a one-hot over the
// ring slots, which agrees bit for bit except that it turns a float -0.0
// into +0.0; the copy keeps -0.0.  Payloads are int32 (graph coloring,
// duct_window_i32) or float32 (evo, duct_window_f32): both are copied as
// 32-bit words, so one kernel serves both.
// The slot arithmetic is a floor-mod, as in JAX and torch: C++ `%`
// truncates toward zero, so every ring index goes through floor_mod.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxD = 1024;
constexpr int kMaxWarps = 32;

__device__ __forceinline__ int floor_mod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

__global__ void __launch_bounds__(kMaxWarps * 32)
duct_window_kernel(
    const float* __restrict__ q_avail, const int* __restrict__ q_touch,
    const int* __restrict__ q_pay, const int* __restrict__ head,
    const int* __restrict__ size, const int* __restrict__ push_pos,
    const bool* __restrict__ push_acc, const float* __restrict__ push_avail,
    const int* __restrict__ push_touch, const int* __restrict__ push_pay,
    const float* __restrict__ recv_now, const bool* __restrict__ recv_active,
    float* __restrict__ qa_out, int* __restrict__ qt_out,
    int* __restrict__ qp_out, int* __restrict__ head_out,
    int* __restrict__ size_out, int* __restrict__ drained_out,
    int* __restrict__ rtouch_out, int* __restrict__ hpay_out,
    bool* __restrict__ hwin_out,
    int n, int d, int C, int L, int max_pops, int per_block, bool vec) {
  __shared__ int s_dr[kMaxD];       // pops per row of this block
  __shared__ int s_fresh[kMaxD];    // freshest popped slot per row
  __shared__ bool s_pushed[kMaxD];  // ... and whether it is the pushed one
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int i0 = blockIdx.x * per_block;
  const int recvs = min(per_block, n - i0);
  const long long CL = (long long)C * L;

  // ---- a warp per ring row ---------------------------------------------
  for (int lr = warp; lr < recvs * d; lr += warps) {
    const int i = i0 + lr / d;
    const long long row = (long long)i0 * d + lr;
    const int h = head[row], sz = size[row], pp = push_pos[row];
    const bool push = push_acc[row] && pp >= 0 && pp < C;
    const float pav = push_avail[row];
    const int ptc = push_touch[row];
    const float* a_in = q_avail + row * C;
    const int* t_in = q_touch + row * C;
    // drain: the longest available FIFO prefix, head-blocking, bounded
    int dr = 0;
    if (recv_active[i]) {
      const float now = recv_now[i];
      const int lim = min(sz, max_pops);
      dr = max(lim, 0);
      for (int base = 0; base < lim; base += 32) {
        const int j = base + lane;
        bool blocked = false;
        if (j < lim) {
          const int s = floor_mod(h + j, C);
          blocked = ((push && s == pp) ? pav : a_in[s]) > now;
        }
        const unsigned m = __ballot_sync(kFull, blocked);
        if (m) {
          dr = base + __ffs(m) - 1;
          break;
        }
      }
    }
    const int fresh = floor_mod(h + dr - 1, C);
    // avail and touch: the push applied, popped slots +inf
    float* a_out = qa_out + row * C;
    int* t_out = qt_out + row * C;
    for (int c = lane; c < C; c += 32) {
      const bool pushed = push && c == pp;
      a_out[c] = floor_mod(c - h, C) < dr ? INFINITY
                                          : (pushed ? pav : a_in[c]);
      t_out[c] = pushed ? ptc : t_in[c];
    }
    // payload: the C*L words, the pushed slot's from push_pay
    const int* p_in = q_pay + row * CL;
    int* p_out = qp_out + row * CL;
    const int* pp_in = push_pay + row * L;
    const long long lo = push ? (long long)pp * L : CL;   // pushed words
    if (vec) {
      const int4* v_in = reinterpret_cast<const int4*>(p_in);
      int4* v_out = reinterpret_cast<int4*>(p_out);
      const long long nv = CL >> 2;
      for (long long v = lane; v < nv; v += 32) {
        int4 w = v_in[v];
        const long long e = 4 * v;
        if (e + 4 > lo && e < lo + L) {   // the vector meets the push
          if ((unsigned long long)(e - lo) < (unsigned long long)L)
            w.x = pp_in[e - lo];
          if ((unsigned long long)(e + 1 - lo) < (unsigned long long)L)
            w.y = pp_in[e + 1 - lo];
          if ((unsigned long long)(e + 2 - lo) < (unsigned long long)L)
            w.z = pp_in[e + 2 - lo];
          if ((unsigned long long)(e + 3 - lo) < (unsigned long long)L)
            w.w = pp_in[e + 3 - lo];
        }
        v_out[v] = w;
      }
    } else {
      for (long long e = lane; e < CL; e += 32)
        p_out[e] = (unsigned long long)(e - lo) < (unsigned long long)L
                       ? pp_in[e - lo] : p_in[e];
    }
    if (lane == 0) {
      const bool fp = push && fresh == pp;
      rtouch_out[row] = dr > 0 ? (fp ? ptc : t_in[fresh]) : 0;
      head_out[row] = floor_mod(h + dr, C);
      size_out[row] = sz - dr;
      drained_out[row] = dr;
      s_dr[lr] = dr;
      s_fresh[lr] = fresh;
      s_pushed[lr] = fp;
    }
  }
  __syncthreads();

  // ---- a warp per (receiver, halo slot) ----------------------------------
  for (int u = warp; u < recvs * 4; u += warps) {
    const int li = u >> 2, s = u & 3;
    const int i = i0 + li;
    int win = -1;
    for (int j = s + 4 * lane; j < d; j += 128)
      if (s_dr[li * d + j] > 0) win = j;
    win = __reduce_max_sync(kFull, win);
    int* hp = hpay_out + ((long long)i * 4 + s) * L;
    if (win >= 0) {
      const int lr = li * d + win;
      const long long row = (long long)i0 * d + lr;
      const int* src = s_pushed[lr] ? push_pay + row * L
                                    : q_pay + (row * C + s_fresh[lr]) * L;
      for (int l = lane; l < L; l += 32) hp[l] = src[l];
    } else {
      for (int l = lane; l < L; l += 32) hp[l] = 0;
    }
    if (lane == 0) hwin_out[(long long)i * 4 + s] = win >= 0;
  }
}

int launch(const void* q_avail, const void* q_touch, const void* q_pay,
           const void* head, const void* size, const void* push_pos,
           const void* push_acc, const void* push_avail,
           const void* push_touch, const void* push_pay,
           const void* recv_now, const void* recv_active,
           void* qa_out, void* qt_out, void* qp_out, void* head_out,
           void* size_out, void* drained_out, void* rtouch_out,
           void* hpay_out, void* hwin_out,
           int n, int d, int C, int L, int max_pops, void* stream) {
  if (n <= 0 || d <= 0 || d > kMaxD || C <= 0 || L <= 0)
    return (int)cudaErrorInvalidValue;
  const int per_block = d <= 8 ? 8 / d : 1;
  const int warps = d <= 8 ? per_block * d : (d < kMaxWarps ? d : kMaxWarps);
  const int grid = (n + per_block - 1) / per_block;
  const bool vec = ((long long)C * L) % 4 == 0 &&
                   ((uintptr_t)q_pay & 15) == 0 &&
                   ((uintptr_t)qp_out & 15) == 0;
  duct_window_kernel<<<grid, warps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)q_avail, (const int*)q_touch, (const int*)q_pay,
      (const int*)head, (const int*)size, (const int*)push_pos,
      (const bool*)push_acc, (const float*)push_avail,
      (const int*)push_touch, (const int*)push_pay, (const float*)recv_now,
      (const bool*)recv_active, (float*)qa_out, (int*)qt_out, (int*)qp_out,
      (int*)head_out, (int*)size_out, (int*)drained_out, (int*)rtouch_out,
      (int*)hpay_out, (bool*)hwin_out, n, d, C, L, max_pops, per_block,
      vec);
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
  return launch(q_avail, q_touch, q_pay, head, size, push_pos, push_acc,
                push_avail, push_touch, push_pay, recv_now, recv_active,
                qa_out, qt_out, qp_out, head_out, size_out, drained_out,
                rtouch_out, hpay_out, hwin_out, n, d, C, L, max_pops,
                stream);
}

// float32 payloads (evo): the same 32-bit words.
extern "C" int duct_window_f32(
    const void* q_avail, const void* q_touch, const void* q_pay,
    const void* head, const void* size, const void* push_pos,
    const void* push_acc, const void* push_avail, const void* push_touch,
    const void* push_pay, const void* recv_now, const void* recv_active,
    void* qa_out, void* qt_out, void* qp_out, void* head_out,
    void* size_out, void* drained_out, void* rtouch_out, void* hpay_out,
    void* hwin_out, int n, int d, int C, int L, int max_pops,
    void* stream) {
  return launch(q_avail, q_touch, q_pay, head, size, push_pos, push_acc,
                push_avail, push_touch, push_pay, recv_now, recv_active,
                qa_out, qt_out, qp_out, head_out, size_out, drained_out,
                rtouch_out, hpay_out, hwin_out, n, d, C, L, max_pops,
                stream);
}
