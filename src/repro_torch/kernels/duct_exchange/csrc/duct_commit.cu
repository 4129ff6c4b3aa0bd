// Superstep ring commit: fold each ring's compact pushbuf into its tail.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/duct_exchange/kernel.py:197 (_commit_kernel,
//   launched by duct_commit_kernel), once per W-window superstep.  Plain
// version: ops.duct_commit_torch.
//
// What bounds it on Hopper: bytes.  Every ring slot is read and written
// once ((4 + 4 + 4L) bytes each way per slot over R rings of C slots) plus
// the (R, W) pushbuf read once; the per-slot work is one floor-mod and a
// compare.  At evo's torus-1024 shape (R = 4096, C = 64, W = 8, L = 60)
// the rings and the pushbuf are ~138 MB read and written together, ~41 us
// at 3.35 TB/s; at graph coloring's torus-4096 (R = 16384, L = 1) ~27 MB,
// ~8 us.
//
// Design: a warp per ring row r, so neighbouring lanes touch neighbouring
// addresses (a thread a slot would put neighbouring lanes 240 bytes apart
// at L = 60).
//   * The slot's pushbuf index is j = (c - head[r] - size0[r]) mod C (a
//     floor-mod: C++ `%` truncates toward zero).  Slots with j < pb_cnt[r]
//     take pushbuf entry min(j, W - 1), as the plain version's clamped
//     gather does (pb_cnt <= W holds on the engine's path); every other
//     slot keeps its value bit for bit.
//   * avail and touch: lane-strided over the C slots.
//   * payload: the row's C * L words as 16-byte chunks, lane-strided, four
//     chunks in flight a lane (loads first, then stores); each chunk lies
//     in one slot (L % 4 == 0) and takes its source from that slot's j.
//     At L = 1 (graph coloring) the slot's one word is copied beside its
//     avail and touch; at any other L % 4 != 0, or where a payload array
//     is not 16-byte aligned, the walk runs over 4-byte words.
//   * Payloads are copied, never summed, as 32-bit words: int32 (graph
//     coloring, duct_commit_i32) and float32 (evo, duct_commit_f32) share
//     the kernel, and a float -0.0 stays -0.0, as in the Pallas kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // ring rows a block
constexpr int kUnroll = 4; // 16-byte chunks in flight a lane

__device__ __forceinline__ int floor_mod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

// the source row of slot c: the pushbuf entry, or -1 for the ring itself
__device__ __forceinline__ int push_src(int c, int base, int cnt, int C,
                                        int W) {
  const int j = floor_mod(c - base, C);
  return j < cnt ? (j < W ? j : W - 1) : -1;
}

// how the payload is copied: 16-byte chunks, one word beside each slot's
// avail and touch (L = 1), or 4-byte words
enum Walk { kChunks, kSlotWord, kWords };

template <Walk WALK>
__global__ void __launch_bounds__(kWarps * 32)
duct_commit_kernel(
    const float* __restrict__ q_avail, const int* __restrict__ q_touch,
    const int* __restrict__ q_pay, const int* __restrict__ head,
    const int* __restrict__ size0, const int* __restrict__ pb_cnt,
    const float* __restrict__ pb_avail, const int* __restrict__ pb_touch,
    const int* __restrict__ pb_pay, float* __restrict__ qa_out,
    int* __restrict__ qt_out, int* __restrict__ qp_out, long long R, int C,
    int W, int L) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;
  const int base = head[r] + size0[r];
  const int cnt = pb_cnt[r];
  const long long rc = r * C, rw = r * W;

#pragma unroll 2
  for (int c = lane; c < C; c += 32) {
    const int j = push_src(c, base, cnt, C, W);
    qa_out[rc + c] = j >= 0 ? pb_avail[rw + j] : q_avail[rc + c];
    qt_out[rc + c] = j >= 0 ? pb_touch[rw + j] : q_touch[rc + c];
    if (WALK == kSlotWord)
      qp_out[rc + c] = j >= 0 ? pb_pay[rw + j] : q_pay[rc + c];
  }

  const int CL = C * L;  // < 2^31, checked by the launcher
  const int* ring = q_pay + r * CL;
  const int* push = pb_pay + rw * L;
  int* out = qp_out + r * CL;
  if (WALK == kChunks) {
    // chunk v holds words 4v .. 4v + 3 of slot c = 4v / L
    const int nv = CL >> 2, lv = L >> 2;
    for (int v0 = lane; v0 < nv; v0 += 32 * kUnroll) {
      int4 w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = v0 + 32 * u;
        if (v < nv) {
          const int c = v / lv, l4 = v - c * lv;
          const int j = push_src(c, base, cnt, C, W);
          const int4* src = reinterpret_cast<const int4*>(
              j >= 0 ? push + (long long)j * L : ring + (long long)c * L);
          w[u] = src[l4];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = v0 + 32 * u;
        if (v < nv) reinterpret_cast<int4*>(out)[v] = w[u];
      }
    }
  } else if (WALK == kWords) {
    for (int e = lane; e < CL; e += 32) {
      const int c = e / L, l = e - c * L;
      const int j = push_src(c, base, cnt, C, W);
      out[e] = j >= 0 ? push[j * L + l] : ring[e];
    }
  }
}

int launch(const void* q_avail, const void* q_touch, const void* q_pay,
           const void* head, const void* size0, const void* pb_cnt,
           const void* pb_avail, const void* pb_touch, const void* pb_pay,
           void* qa_out, void* qt_out, void* qp_out, long long R, int C,
           int W, int L, void* stream) {
  if (R <= 0 || C <= 0 || W <= 0 || L <= 0 ||
      (long long)C * L >= (1LL << 31) ||
      (R + kWarps - 1) / kWarps >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const bool vec = L % 4 == 0 && ((uintptr_t)q_pay & 15) == 0 &&
                   ((uintptr_t)pb_pay & 15) == 0 &&
                   ((uintptr_t)qp_out & 15) == 0;
  const Walk walk = vec ? kChunks : L == 1 ? kSlotWord : kWords;
  const unsigned grid = (unsigned)((R + kWarps - 1) / kWarps);
  const cudaStream_t st = (cudaStream_t)stream;
  const float* qa = (const float*)q_avail;
  const int* qt = (const int*)q_touch;
  const int* qp = (const int*)q_pay;
  const int* hd = (const int*)head;
  const int* s0 = (const int*)size0;
  const int* pc = (const int*)pb_cnt;
  const float* pa = (const float*)pb_avail;
  const int* pt = (const int*)pb_touch;
  const int* pp = (const int*)pb_pay;
#define DUCT_COMMIT_LAUNCH(w)                                              \
  duct_commit_kernel<w><<<grid, kWarps * 32, 0, st>>>(                     \
      qa, qt, qp, hd, s0, pc, pa, pt, pp, (float*)qa_out, (int*)qt_out,    \
      (int*)qp_out, R, C, W, L)
  if (walk == kChunks)
    DUCT_COMMIT_LAUNCH(kChunks);
  else if (walk == kSlotWord)
    DUCT_COMMIT_LAUNCH(kSlotWord);
  else
    DUCT_COMMIT_LAUNCH(kWords);
#undef DUCT_COMMIT_LAUNCH
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
  return launch(q_avail, q_touch, q_pay, head, size0, pb_cnt, pb_avail,
                pb_touch, pb_pay, qa_out, qt_out, qp_out, R, C, W, L,
                stream);
}

// float32 payloads (evo): the same 32-bit words.
extern "C" int duct_commit_f32(
    const void* q_avail, const void* q_touch, const void* q_pay,
    const void* head, const void* size0, const void* pb_cnt,
    const void* pb_avail, const void* pb_touch, const void* pb_pay,
    void* qa_out, void* qt_out, void* qp_out, long long R, int C, int W,
    int L, void* stream) {
  return launch(q_avail, q_touch, q_pay, head, size0, pb_cnt, pb_avail,
                pb_touch, pb_pay, qa_out, qt_out, qp_out, R, C, W, L,
                stream);
}
