// Edge-major duct exchange over per-edge rings: drain, send, and the two
// fused (drain -> send), three entry points of one templated kernel.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/duct_exchange/kernel.py:_duct_kernel
// (launched by duct_exchange_kernel).  Plain versions:
// ops.duct_drain_torch, ops.duct_send_torch and ops.duct_exchange_torch.
// The engine's edge-major window launches the drain before the
// application step and the send after it (entry points duct_drain and
// duct_send); the fused form (duct_exchange) serves ops.duct_exchange.
// Payloads ride outside the kernel, moved by the caller with pop_pos /
// push_pos.
//
// What bounds it on Hopper: bytes.  At the torus-4096 edge layout (E =
// 16384, C = 64), per ring row of 64 float32 availabilities and 64 int32
// touches:
//   * drain: q_avail read and written (8.4 MB), one q_touch slot a row
//     (the freshest popped one's touch), and the per-edge vectors (head,
//     size, recv_now, recv_active in; head, size, drained, recv_touch,
//     pop_pos out: 0.5 MB); the drain returns its input q_touch, which it
//     never changes: ~8.9 MB, 2.7 us at 3.35 TB/s;
//   * send: both rings read and written (16.8 MB) and the per-edge vectors
//     (0.5 MB): ~17.3 MB, 5.2 us;
//   * full: both rings and every per-edge vector: ~17.8 MB, 5.3 us.
// The per-slot work (a floor-mod, two compares, a warp reduction) is far
// below the integer rate.  At these sizes the launch ramp (~1-2 us) is a
// real share of a call.
//
// Design:
//   * a block covers kRows = 32 consecutive ring rows; the per-edge inputs
//     of those rows are loaded once, coalesced, by the block's first 32
//     threads into shared memory, and the per-edge outputs are written
//     back the same way, instead of a broadcast load (and a lone store)
//     per warp and row;
//   * drain and full: a warp per ring row, four rows a warp, their ring
//     loads issued before anything waits.  A row's q_avail is read once,
//     into registers, where C is even and at most 64 (the path's C = 64:
//     two adjacent slots a lane, one float2, a 256-byte row in one warp
//     load) and the rings are 8-byte aligned; any other C (or a ring that
//     starts inside its buffer) is walked a slot at a time, q_avail read
//     again in the write pass.  Each lane finds the smallest FIFO offset
//     among its live slots that is not yet available; one
//     __reduce_min_sync gives the row's blocked offset, and the pop count
//     is min(blocked, size, max_pops), or 0 where the receiver is
//     inactive.  Popped slots are written as +inf.  The drain then reads
//     the one q_touch slot of each row's freshest pop (recv_touch), the
//     four rows' gathers in flight together; the full form carries q_touch
//     through registers beside q_avail and stamps the send;
//   * send: no scan.  The block's 32 rows are one contiguous run of each
//     ring, copied with 16-byte vectors where C % 4 == 0 and the rings are
//     16-byte aligned (a 256-byte row is 16 lanes, so a warp takes two
//     rows), one slot a lane otherwise; after a __syncthreads the accepted
//     rows' tail slots are stamped by the per-edge threads (send_now +
//     send_lat, send_touch at (head + size) mod C), over the copied value.
//     Accept iff the sender is active and size < capacity.  Out of place,
//     as the plain version.
// Index arithmetic is 32-bit (the wrappers refuse E * C >= 2^31), and every
// ring index goes through floor_mod: C++ `%` truncates toward zero.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // 8 warps
constexpr int kRows = 32;               // ring rows a block
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kFullMode = 0, kDrainMode = 1, kSendMode = 2 };

struct Args {
  const float* q_avail;
  const int* q_touch;
  const int* head;
  const int* size;
  const float* recv_now;
  const bool* recv_active;
  const float* send_now;
  const bool* send_active;
  const float* send_lat;
  const int* send_touch;
  float* qa_out;
  int* qt_out;
  int* head_out;
  int* size_out;
  int* drained_out;
  int* rtouch_out;
  int* pop_pos_out;
  bool* accepted_out;
  int* push_pos_out;
  int E, C, capacity, max_pops;
};

__device__ __forceinline__ int floor_mod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

// W adjacent slots of a ring row as one load
template <int W> struct Vec;
template <> struct Vec<1> {
  using F = float;
  using I = int;
};
template <> struct Vec<4> {
  using F = float4;
  using I = int4;
};

// slot k (0 or 1) of a two-slot vector
template <class T>
__device__ __forceinline__ auto get2(const T& v, int k) {
  return k ? v.y : v.x;
}
template <class T, class X>
__device__ __forceinline__ void set2(T& v, int k, X x) {
  if (k) v.y = x; else v.x = x;
}

// per-edge inputs and outputs of a block's rows, in shared memory
struct Edge {
  int head[kRows], size[kRows];
  float rnow[kRows];
  bool ract[kRows];
  int d[kRows], rtouch[kRows], pop_pos[kRows];
  // send side (full form)
  float stamp[kRows];
  int stouch[kRows], slot[kRows];
  bool sact[kRows], acc[kRows];
};

// ---------------------------------------------------------------------------
// send: a flat vector copy of the block's rows, then the tail stamps
// ---------------------------------------------------------------------------
template <int W>
__device__ __forceinline__ void send_block(const Args& a, int e0, int rows) {
  using F = typename Vec<W>::F;
  using I = typename Vec<W>::I;
  __shared__ int s_slot[kRows];
  __shared__ float s_stamp[kRows];
  __shared__ int s_stouch[kRows];
  __shared__ bool s_acc[kRows];
  const int C = a.C;
  const int tid = threadIdx.x;
  // per-edge inputs: one coalesced load each, by the first `rows` threads
  if (tid < rows) {
    const int e = e0 + tid;
    const int sz = a.size[e];
    const bool acc = a.send_active[e] && sz < a.capacity;
    const int slot = floor_mod(a.head[e] + sz, C);
    s_slot[tid] = slot;
    s_acc[tid] = acc;
    s_stamp[tid] = a.send_now[e] + a.send_lat[e];
    s_stouch[tid] = a.send_touch[e];
    a.size_out[e] = sz + (acc ? 1 : 0);
    a.accepted_out[e] = acc;
    a.push_pos_out[e] = acc ? slot : 0;
  }
  // both rings: the block's rows are one contiguous run of rows * C slots
  const int base = e0 * C / W;                 // in vectors
  const int n = rows * C / W;
  const F* qa = reinterpret_cast<const F*>(a.q_avail) + base;
  const I* qt = reinterpret_cast<const I*>(a.q_touch) + base;
  F* qa_o = reinterpret_cast<F*>(a.qa_out) + base;
  I* qt_o = reinterpret_cast<I*>(a.qt_out) + base;
  int i = tid;
  for (; i + kThreads < n; i += 2 * kThreads) {   // two vectors in flight
    const F x0 = qa[i], x1 = qa[i + kThreads];
    const I t0 = qt[i], t1 = qt[i + kThreads];
    qa_o[i] = x0;
    qa_o[i + kThreads] = x1;
    qt_o[i] = t0;
    qt_o[i + kThreads] = t1;
  }
  if (i < n) {
    qa_o[i] = qa[i];
    qt_o[i] = qt[i];
  }
  // the stamps land over the copied tail slots: the block's copy stores
  // are ordered before them by the barrier
  __syncthreads();
  if (tid < rows && s_acc[tid]) {
    const int at = (e0 + tid) * C + s_slot[tid];
    a.qa_out[at] = s_stamp[tid];
    a.qt_out[at] = s_stouch[tid];
  }
}

// ---------------------------------------------------------------------------
// drain and full: a warp per ring row, kRowsPerWarp rows a warp
// ---------------------------------------------------------------------------
// kRegs (C even, C <= 64, the rings 8-byte aligned): lane l holds slots
// 2l and 2l + 1 in registers as one float2 (and int2); otherwise any C,
// one slot at a time, q_avail read again in the write pass
template <int M, bool kRegs>
__device__ __forceinline__ void row_block(const Args& a, int e0, int rows) {
  constexpr bool kFused = M == kFullMode;
  const int C = a.C;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nvec = C / 2;
  __shared__ Edge sh;

  // the rows' ring loads first: nothing they need is waited for
  float2 v[kRowsPerWarp];
  int2 t[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    if (kRegs && r < rows && lane < nvec) {
      const int at = (e0 + r) * nvec + lane;
      v[i] = reinterpret_cast<const float2*>(a.q_avail)[at];
      if (kFused) t[i] = reinterpret_cast<const int2*>(a.q_touch)[at];
    }
  }
  if (tid < rows) {
    const int e = e0 + tid;
    sh.head[tid] = a.head[e];
    sh.size[tid] = a.size[e];
    sh.rnow[tid] = a.recv_now[e];
    sh.ract[tid] = a.recv_active[e];
    if (kFused) {
      sh.stamp[tid] = a.send_now[e] + a.send_lat[e];
      sh.stouch[tid] = a.send_touch[e];
      sh.sact[tid] = a.send_active[e];
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    if (r >= rows) break;                 // warp-uniform
    const int e = e0 + r;
    const int h = sh.head[r], sz = sh.size[r];
    const float now = sh.rnow[r];
    // ---- drain: longest available FIFO prefix, head-blocking, bounded --
    int blocked = C;
    if (kRegs) {
      if (lane < nvec) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int off = floor_mod(2 * lane + k - h, C);
          if (off < sz && get2(v[i], k) > now) blocked = min(blocked, off);
        }
      }
    } else {
      for (int c = lane; c < C; c += 32) {
        const int off = floor_mod(c - h, C);
        if (off < sz && a.q_avail[e * C + c] > now)
          blocked = min(blocked, off);
      }
    }
    blocked = __reduce_min_sync(kFull, blocked);
    int d = min(min(blocked, sz), a.max_pops);
    if (!sh.ract[r]) d = 0;
    // ---- send (full form): drop iff full after the drain -----------------
    const int h2 = floor_mod(h + d, C);
    const int sz2 = sz - d;
    const bool acc = kFused && sh.sact[r] && sz2 < a.capacity;
    const int slot = floor_mod(h2 + sz2, C);
    const float stamp = kFused ? sh.stamp[r] : 0.f;
    const int stouch = kFused ? sh.stouch[r] : 0;
    // ---- write the row: popped slots +inf, the stamp -----------------------
    int fresh_touch = 0;
    if (kRegs) {
      if (lane < nvec) {
        float2 x = v[i];
        int2 tt;
        if (kFused) tt = t[i];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int c = 2 * lane + k;
          const int off = floor_mod(c - h, C);
          if (off < sz && off < d) {
            if (kFused && off == d - 1) fresh_touch = get2(tt, k);
            set2(x, k, INFINITY);
          }
          if (acc && c == slot) {
            set2(x, k, stamp);
            if (kFused) set2(tt, k, stouch);
          }
        }
        reinterpret_cast<float2*>(a.qa_out)[e * nvec + lane] = x;
        if (kFused) reinterpret_cast<int2*>(a.qt_out)[e * nvec + lane] = tt;
      }
    } else {
      for (int c = lane; c < C; c += 32) {
        const int off = floor_mod(c - h, C);
        float x = a.q_avail[e * C + c];
        int tt = kFused ? a.q_touch[e * C + c] : 0;
        if (off < sz && off < d) {
          if (off == d - 1) fresh_touch = tt;
          x = INFINITY;
        }
        if (acc && c == slot) {
          x = stamp;
          tt = stouch;
        }
        a.qa_out[e * C + c] = x;
        if (kFused) a.qt_out[e * C + c] = tt;
      }
    }
    if (lane == 0) {
      sh.d[r] = d;
      sh.pop_pos[r] = d > 0 ? floor_mod(h + d - 1, C) : h;
      if (kFused) {
        sh.acc[r] = acc;
        sh.slot[r] = slot;
      }
    }
    if (kFused) {
      fresh_touch = __reduce_add_sync(kFull, fresh_touch);
      if (lane == 0) sh.rtouch[r] = fresh_touch;
    }
  }
  if (!kFused) {
    // the drain's recv_touch: the touch of each row's freshest popped slot,
    // lane i of the warp gathering row i's, all in flight together
    __syncwarp();
    if (lane < kRowsPerWarp) {
      const int r = warp + kWarps * lane;
      if (r < rows)
        sh.rtouch[r] = sh.d[r] > 0
            ? a.q_touch[(e0 + r) * C + sh.pop_pos[r]] : 0;
    }
  }
  __syncthreads();
  if (tid < rows) {
    const int e = e0 + tid;
    const int d = sh.d[tid];
    a.head_out[e] = floor_mod(sh.head[tid] + d, C);
    a.drained_out[e] = d;
    a.rtouch_out[e] = sh.rtouch[tid];
    a.pop_pos_out[e] = sh.pop_pos[tid];
    if (kFused) {
      const bool acc = sh.acc[tid];
      a.size_out[e] = sh.size[tid] - d + (acc ? 1 : 0);
      a.accepted_out[e] = acc;
      a.push_pos_out[e] = acc ? sh.slot[tid] : 0;
    } else {
      a.size_out[e] = sh.size[tid] - d;
    }
  }
}

// send: W slots a vector; drain and full: kRegs as row_block's
template <int M, int W, bool kRegs>
__global__ void __launch_bounds__(kThreads) duct_exchange_kernel(Args a) {
  const int e0 = blockIdx.x * kRows;
  const int rows = min(kRows, a.E - e0);
  if constexpr (M == kSendMode)
    send_block<W>(a, e0, rows);
  else
    row_block<M, kRegs>(a, e0, rows);
}

// a vector of `bytes` needs every ring pointer aligned to it (a row is C
// slots, so C a multiple of the vector keeps every row aligned); a ring
// view that starts inside its buffer takes the slot-at-a-time path
bool rings_aligned(const Args& a, uintptr_t bytes) {
  const uintptr_t any = (uintptr_t)a.q_avail | (uintptr_t)a.q_touch |
                        (uintptr_t)a.qa_out | (uintptr_t)a.qt_out;
  return (any & (bytes - 1)) == 0;
}

template <int M>
int launch(const Args& a, cudaStream_t stream) {
  if (a.E <= 0 || a.C <= 0 || (long long)a.E * a.C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int blocks = (a.E + kRows - 1) / kRows;
  if constexpr (M == kSendMode) {
    if (a.C % 4 == 0 && rings_aligned(a, 16))
      duct_exchange_kernel<M, 4, false><<<blocks, kThreads, 0, stream>>>(a);
    else
      duct_exchange_kernel<M, 1, false><<<blocks, kThreads, 0, stream>>>(a);
  } else {
    if (a.C % 2 == 0 && a.C <= 64 && rings_aligned(a, 8))
      duct_exchange_kernel<M, 1, true><<<blocks, kThreads, 0, stream>>>(a);
    else
      duct_exchange_kernel<M, 1, false><<<blocks, kThreads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
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
  const Args a{(const float*)q_avail, (const int*)q_touch, (const int*)head,
               (const int*)size, (const float*)recv_now,
               (const bool*)recv_active, (const float*)send_now,
               (const bool*)send_active, (const float*)send_lat,
               (const int*)send_touch, (float*)qa_out, (int*)qt_out,
               (int*)head_out, (int*)size_out, (int*)drained_out,
               (int*)rtouch_out, (int*)pop_pos_out, (bool*)accepted_out,
               (int*)push_pos_out, E, C, capacity, max_pops};
  return launch<kFullMode>(a, (cudaStream_t)stream);
}

extern "C" int duct_drain(const void* q_avail, const void* q_touch,
                          const void* head, const void* size,
                          const void* recv_now, const void* recv_active,
                          void* qa_out, void* head_out, void* size_out,
                          void* drained_out, void* rtouch_out,
                          void* pop_pos_out, int E, int C, int max_pops,
                          void* stream) {
  const Args a{(const float*)q_avail, (const int*)q_touch, (const int*)head,
               (const int*)size, (const float*)recv_now,
               (const bool*)recv_active, nullptr, nullptr, nullptr, nullptr,
               (float*)qa_out, nullptr, (int*)head_out, (int*)size_out,
               (int*)drained_out, (int*)rtouch_out, (int*)pop_pos_out,
               nullptr, nullptr, E, C, C, max_pops};
  return launch<kDrainMode>(a, (cudaStream_t)stream);
}

extern "C" int duct_send(const void* q_avail, const void* q_touch,
                         const void* head, const void* size,
                         const void* send_now, const void* send_active,
                         const void* send_lat, const void* send_touch,
                         void* qa_out, void* qt_out, void* size_out,
                         void* accepted_out, void* push_pos_out, int E, int C,
                         int capacity, void* stream) {
  const Args a{(const float*)q_avail, (const int*)q_touch, (const int*)head,
               (const int*)size, nullptr, nullptr, (const float*)send_now,
               (const bool*)send_active, (const float*)send_lat,
               (const int*)send_touch, (float*)qa_out, (int*)qt_out,
               nullptr, (int*)size_out, nullptr, nullptr, nullptr,
               (bool*)accepted_out, (int*)push_pos_out, E, C, capacity, 0};
  return launch<kSendMode>(a, (cudaStream_t)stream);
}
