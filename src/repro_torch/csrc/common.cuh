// Shared device helpers for the hand-written Hopper kernels.
//
// Bitwise rules every kernel here keeps, so its integer codes equal the
// plain PyTorch versions' codes exactly (see kernels/ref.py):
//  - every float product and sum that a plain version rounds twice is
//    written __fmul_rn / __fadd_rn (and the build passes -fmad=false);
//  - round half to even is rintf (CUDA roundf rounds half away from zero);
//  - powers of two come from ldexpf, never exp2f on a fractional input;
//  - no fast math: x / delta stays correctly rounded, denormals are kept;
//  - no atomics in any compared sum.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#define NEG_BIG (-1e30f)

// Unsigned-by-signed 4-way byte dot product: prob codes are unsigned (up
// to 255 for 8-bit grids), value codes signed; no -128 bias is needed.
__device__ __forceinline__ int dp4a_us(unsigned a, int b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ int ld32(const int8_t* p) {
  return *reinterpret_cast<const int*>(p);
}

// Sign-extend the 4-bit two's complement value in the low nibble.
__device__ __forceinline__ int sx4(unsigned v) {
  return static_cast<int>(v << 28) >> 28;
}

// Two packed bytes (k, k+1 | k+2, k+3; low nibble = even k) -> one word of
// four int8 codes in k order, ready for dp4a.
__device__ __forceinline__ int unpack4(unsigned b2) {
  const unsigned c0 = sx4(b2) & 0xFF, c1 = sx4(b2 >> 4) & 0xFF;
  const unsigned c2 = sx4(b2 >> 8) & 0xFF, c3 = sx4(b2 >> 12) & 0xFF;
  return static_cast<int>(c0 | (c1 << 8) | (c2 << 16) | (c3 << 24));
}

// (1 + r) * 2^floor(x): the paper's shift exponential, as
// repro_torch.core.softmax2.exp2_shift builds it.  A normal result is the
// exponent field of 1 + r moved by floor(x), which is what ldexpf returns;
// below 2^-126 ldexpf itself gives the exact denormal (or 0).
__device__ __forceinline__ float exp2_shift(float x) {
  const float f = floorf(x);
  const float m = __fadd_rn(1.0f, __fsub_rn(x, f));
  const int fi = static_cast<int>(f);
  return fi >= -126 && fi <= 126
             ? __int_as_float(__float_as_int(m) + fi * (1 << 23))
             : ldexpf(m, fi);
}

// Exact 2^(m_old - m_new) carry rescale; 0 before the first live block.
__device__ __forceinline__ float carry_scale(float m_old, float m_new) {
  return m_old <= NEG_BIG ? 0.0f
                          : ldexpf(1.0f, static_cast<int>(m_old - m_new));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
