// Fused edge-major duct exchange: drain -> send over per-edge rings.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/duct_exchange/kernel.py:_duct_kernel
// (launched by duct_exchange_kernel).  Plain version:
// ops.duct_exchange_torch.  The engine's edge-major window launches it
// twice: as the drain (every sender inactive) before the application step
// and as the send (every receiver inactive) after it; payloads ride
// outside the kernel, moved by the caller with pop_pos / push_pos.
//
// What bounds it on Hopper: bytes.  Each ring slot is read and written
// once, (4 + 4) bytes each way (float32 availability, int32 touch), plus
// eight per-edge inputs and seven per-edge outputs.  The per-slot work is a
// floor-mod, two compares and a warp reduction, far below the integer
// rate.  At the torus-4096 edge layout (E = 16384, C = 64) that is
// (4 + 4) B x 64 x 16384 = 8.4 MB of ring state each way plus about 1 MB
// of per-edge vectors: ~17.8 MB, 5.3 us at 3.35 TB/s.
//
// Design (simple first):
//   * one warp per ring row, so lane l owns slots l, l + 32, ... and a
//     warp's loads and stores of a row are contiguous (C = 64 is two
//     slots per lane);
//   * drain: each lane finds the smallest FIFO offset among its live
//     slots that is not yet available; one __reduce_min_sync gives the
//     row's blocked offset, and the pop count is min(blocked, size,
//     max_pops), or 0 where the receiver is inactive;
//   * popped slots get +inf; the touch of the freshest popped slot comes
//     from a __reduce_add_sync over the one lane that holds it;
//   * send: accept iff the sender is active and the post-drain size is
//     below capacity, and write send_now + send_lat and send_touch at
//     (head2 + size2) mod C;
//   * lane 0 writes the seven per-edge outputs.
// Index arithmetic is 32-bit (the wrapper refuses E * C >= 2^31), and every
// ring index goes through floor_mod: C++ `%` truncates toward zero.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ int floor_mod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

__global__ void duct_exchange_kernel(
    const float* __restrict__ q_avail, const int* __restrict__ q_touch,
    const int* __restrict__ head, const int* __restrict__ size,
    const float* __restrict__ recv_now, const bool* __restrict__ recv_active,
    const float* __restrict__ send_now, const bool* __restrict__ send_active,
    const float* __restrict__ send_lat, const int* __restrict__ send_touch,
    float* __restrict__ qa_out, int* __restrict__ qt_out,
    int* __restrict__ head_out, int* __restrict__ size_out,
    int* __restrict__ drained_out, int* __restrict__ rtouch_out,
    int* __restrict__ pop_pos_out, bool* __restrict__ accepted_out,
    int* __restrict__ push_pos_out,
    int E, int C, int capacity, int max_pops) {
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (e >= E) return;  // whole warps leave together: e is warp-uniform
  const int base = e * C;
  const int h = head[e];
  const int sz = size[e];
  const float now = recv_now[e];

  // ---- drain: longest available FIFO prefix, head-blocking, bounded ----
  int blocked = C;
  for (int c = lane; c < C; c += 32) {
    const int off = floor_mod(c - h, C);
    if (off < sz && q_avail[base + c] > now) blocked = min(blocked, off);
  }
  blocked = __reduce_min_sync(0xffffffffu, blocked);
  int d = min(min(blocked, sz), max_pops);
  if (!recv_active[e]) d = 0;

  const int h2 = floor_mod(h + d, C);
  const int sz2 = sz - d;
  // ---- send: drop iff full after the drain, stamp the tail slot ---------
  const bool acc = send_active[e] && sz2 < capacity;
  const int slot = floor_mod(h2 + sz2, C);
  const float stamp = send_now[e] + send_lat[e];
  const int stouch = send_touch[e];

  int fresh_touch = 0;
  for (int c = lane; c < C; c += 32) {
    const int off = floor_mod(c - h, C);
    float a = q_avail[base + c];
    int t = q_touch[base + c];
    if (off < sz && off < d) {
      if (off == d - 1) fresh_touch = t;
      a = INFINITY;
    }
    if (acc && c == slot) {
      a = stamp;
      t = stouch;
    }
    qa_out[base + c] = a;
    qt_out[base + c] = t;
  }
  fresh_touch = __reduce_add_sync(0xffffffffu, fresh_touch);

  if (lane == 0) {
    head_out[e] = h2;
    size_out[e] = sz2 + (acc ? 1 : 0);
    drained_out[e] = d;
    rtouch_out[e] = fresh_touch;
    pop_pos_out[e] = d > 0 ? floor_mod(h + d - 1, C) : h;
    accepted_out[e] = acc;
    push_pos_out[e] = acc ? slot : 0;
  }
}

}  // namespace

extern "C" int duct_exchange(
    const void* q_avail, const void* q_touch, const void* head,
    const void* size, const void* recv_now, const void* recv_active,
    const void* send_now, const void* send_active, const void* send_lat,
    const void* send_touch, void* qa_out, void* qt_out, void* head_out,
    void* size_out, void* drained_out, void* rtouch_out, void* pop_pos_out,
    void* accepted_out, void* push_pos_out, int E, int C, int capacity,
    int max_pops, void* stream) {
  if (E <= 0 || C <= 0 || (long long)E * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int threads = 32 * kWarpsPerBlock;
  const int blocks = (E + kWarpsPerBlock - 1) / kWarpsPerBlock;
  duct_exchange_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)q_avail, (const int*)q_touch, (const int*)head,
      (const int*)size, (const float*)recv_now, (const bool*)recv_active,
      (const float*)send_now, (const bool*)send_active,
      (const float*)send_lat, (const int*)send_touch, (float*)qa_out,
      (int*)qt_out, (int*)head_out, (int*)size_out, (int*)drained_out,
      (int*)rtouch_out, (int*)pop_pos_out, (bool*)accepted_out,
      (int*)push_pos_out, E, C, capacity, max_pops);
  return (int)cudaGetLastError();
}
