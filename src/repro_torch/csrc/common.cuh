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

// Tensor-core and asynchronous-copy helpers (PTX), shared by the kernels
// that stage tiles through shared memory.

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// The same copy, or 16 zero bytes when !full (the source is not read): the
// ragged edges of a tile.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices (rows of 16 bytes) from shared memory.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16x32 s8, row-major) * b (32x8 s8, col-major), exact int32.
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same with unsigned codes (0..255) in a.
__device__ __forceinline__ void mma_u8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Raise a kernel's dynamic shared memory limit to bytes, once per device
// (cudaFuncSetAttribute costs host time on every launch; done[] keeps the
// limit set so far on each of the first 16 devices).
inline cudaError_t allow_smem(const void* kernel, size_t bytes,
                              size_t (&done)[16]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 16 && done[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess && dev < 16) done[dev] = bytes;
  return err;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
