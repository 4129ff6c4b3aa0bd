// Blockwise symmetric int8 quantize and dequantize.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/quantize/kernel.py:_quant_kernel   (quantize_kernel)
//   src/repro/kernels/quantize/kernel.py:_dequant_kernel (dequantize_kernel)
// Plain versions: ops.quantize_torch and ops.dequantize_torch.  x is
// (nb, block) float32 (the compressors cast every gradient leaf to float32
// first, as the reference's do); one scale per block (row):
//
//   scale = fma(max|x|, fl(1/127), 1e-12)            float32
//   q     = clip(rint(x / scale), -127, 127)          int8, IEEE division
//   residual (optional) = fma(-q, scale, x)           float32
//   dequantize: out = q * scale, or with accumulate out = fma(q, scale, out)
//
// Every rounding is written out on purpose: under jit, XLA:CPU computes
// the reference's `max|x| / 127.0 + 1e-12` as one fused multiply-add with
// the float32 reciprocal, its compressor's `x - q * scale` as one fma, and
// its pod sum of `q * scale` (Int8Compressor.decode_sum) as an fma chain
// over the pods in order.  nvcc would contract some of these by itself, so
// the code names each rounding (__fmaf_rn, __fmul_rn, __fdiv_rn).
//
// What bounds it on Hopper: bytes.  Quantize reads 4 bytes and writes 1
// (+ 4 with the residual) per element; at the qwen2-1.5b gradient leaves
// (1.54 G elements per pod) that is 13.9 GB, 4.1 ms at 3.35 TB/s, against
// a handful of flops per element.
//
// Design (simple first): one block of 256 threads per row.  Pass 1 reduces
// max|x| (warp shuffles, then one value per warp in shared memory); pass 2
// reads the row again (from L1/L2: a row on the path is at most 8960
// floats) and writes q and the residual.  Dequantize is one block per row
// too, elementwise.  Loads are scalar and coalesced; vector loads and
// several rows per block are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
quantize_rows(const float* __restrict__ x, int8_t* __restrict__ q,
              float* __restrict__ scale, float* __restrict__ residual,
              long long block) {
  __shared__ float warp_max[kThreads / 32];
  const long long row = blockIdx.x;
  const float* xr = x + row * block;
  float m = 0.f;
  for (long long i = threadIdx.x; i < block; i += kThreads)
    m = fmaxf(m, fabsf(xr[i]));
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = warp_max[0];
  for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
  // 1.0f / 127.0f is folded in single precision: fl(1/127)
  const float s = __fmaf_rn(m, 1.0f / 127.0f, 1e-12f);
  if (threadIdx.x == 0) scale[row] = s;
  int8_t* qr = q + row * block;
  float* rr = residual ? residual + row * block : nullptr;
  for (long long i = threadIdx.x; i < block; i += kThreads) {
    const float v = xr[i];
    const float t = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
    qr[i] = (int8_t)t;
    if (rr) rr[i] = __fmaf_rn(-t, s, v);
  }
}

__global__ void __launch_bounds__(kThreads)
dequantize_rows(const int8_t* __restrict__ q, const float* __restrict__ scale,
                float* __restrict__ out, long long block, int accumulate) {
  const long long row = blockIdx.x;
  const float s = scale[row];
  const int8_t* qr = q + row * block;
  float* orow = out + row * block;
  for (long long i = threadIdx.x; i < block; i += kThreads) {
    const float v = (float)qr[i];
    orow[i] = accumulate ? __fmaf_rn(v, s, orow[i]) : __fmul_rn(v, s);
  }
}

}  // namespace

extern "C" int quantize(const void* x, void* q, void* scale, void* residual,
                        int nb, long long block, void* stream) {
  if (nb <= 0 || block <= 0) return (int)cudaErrorInvalidValue;
  quantize_rows<<<nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (int8_t*)q, (float*)scale, (float*)residual, block);
  return (int)cudaGetLastError();
}

extern "C" int dequantize(const void* q, const void* scale, void* out,
                          int nb, long long block, int accumulate,
                          void* stream) {
  if (nb <= 0 || block <= 0) return (int)cudaErrorInvalidValue;
  dequantize_rows<<<nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const float*)scale, (float*)out, block, accumulate);
  return (int)cudaGetLastError();
}
