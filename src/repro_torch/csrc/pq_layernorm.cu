// Post-quantized LayerNorm (paper §IV-C), for Hopper (sm_90a).
//
// pq_layernorm_kernel replaces the Pallas TPU kernel
//   src/repro/kernels/pq_layernorm.py::pq_layernorm (_pqln_kernel):
//   f32 LayerNorm (or RMS with rms_only) -> gamma/beta -> divide by delta
//   -> round half to even -> clip to the signed b-bit grid, int8 out.  The
//   normalized activations never reach device memory in float.
//
// One warp per row.  Each lane sums its strided elements (lane, lane + 32,
// ...) in element order, then a __shfl_down_sync tree (16, 8, 4, 2, 1)
// adds the lanes; the plain version (kernels/ref.py::pq_layernorm_ref)
// takes the same sums in the same order, so the codes agree exactly:
//   mean = sum(x) / d, var = sum((x - mean)^2) / d (RMS: sum(x*x) / d),
//   inv = 1 / sqrt(var + eps), each correctly rounded (no rsqrtf),
//   y = (x - mean) * inv * gamma + beta, each step rounded on its own,
//   code = clip(rint(y / delta)).
// The row is read three times (sums, squares, codes); the second and
// third reads hit L1/L2.  Bound: bytes (the input once, one byte a code
// out).  bf16 inputs are read as they are and widened in registers.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int NTL = 256;            // 8 warps, one row each

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Lane 0 ends with the sum of the 32 lanes' values, added as the plain
// version's five halving adds.
__device__ __forceinline__ float tree_sum(float s) {
  for (int o = 16; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, o));
  return __shfl_sync(0xffffffffu, s, 0);
}

template <typename T>
__global__ void __launch_bounds__(NTL)
pq_layernorm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, int8_t* __restrict__ out,
                    int rows, int d, float eps, float delta, float qmin,
                    float qmax, int rms_only) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (NTL / 32) + threadIdx.x / 32;
  if (row >= rows) return;                 // the whole warp leaves together
  const T* xr = x + (size_t)row * d;
  const float fd = static_cast<float>(d);
  float mu = 0.0f, s = 0.0f;
  if (!rms_only) {
    for (int c = lane; c < d; c += 32) s = __fadd_rn(s, widen(xr[c]));
    mu = __fdiv_rn(tree_sum(s), fd);
    s = 0.0f;
  }
  for (int c = lane; c < d; c += 32) {
    const float t = rms_only ? widen(xr[c]) : __fsub_rn(widen(xr[c]), mu);
    s = __fadd_rn(s, __fmul_rn(t, t));
  }
  const float var = __fdiv_rn(tree_sum(s), fd);
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  int8_t* orow = out + (size_t)row * d;
  for (int c = lane; c < d; c += 32) {
    const float t = rms_only ? widen(xr[c]) : __fsub_rn(widen(xr[c]), mu);
    const float y =
        __fadd_rn(__fmul_rn(__fmul_rn(t, inv), gamma[c]), beta[c]);
    const float q = fminf(fmaxf(rintf(__fdiv_rn(y, delta)), qmin), qmax);
    orow[c] = static_cast<int8_t>(q);
  }
}

}  // namespace

// x (rows, d) f32 (bf16 when is_bf16); gamma, beta (d,) f32; out
// (rows, d) int8.  No limit on rows or d beyond the grid's.
extern "C" int pq_layernorm_launch(const void* x, const void* gamma,
                                   const void* beta, void* out, int rows,
                                   int d, int is_bf16, float eps, float delta,
                                   float qmin, float qmax, int rms_only,
                                   void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + NTL / 32 - 1) / (NTL / 32);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  int8_t* o = static_cast<int8_t*>(out);
  if (is_bf16)
    pq_layernorm_kernel<__nv_bfloat16><<<blocks, NTL, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), g, b, o, rows, d, eps, delta,
        qmin, qmax, rms_only);
  else
    pq_layernorm_kernel<float><<<blocks, NTL, 0, st>>>(
        static_cast<const float*>(x), g, b, o, rows, d, eps, delta, qmin,
        qmax, rms_only);
  return static_cast<int>(cudaGetLastError());
}
