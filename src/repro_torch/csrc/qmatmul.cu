// Operand-reordered integer matmul (paper Eq. 2) for Hopper (sm_90a).
//
//   out[m, n] = f32(sum_k x[m, k] * w[n, k]) * (scale[n] * row_scale[m]) + bias[n]
//
// Replaces the Pallas TPU kernel src/repro/kernels/qmatmul.py::qmatmul
// (bodies _qmatmul_kernel and _qmatmul_packed_kernel, _unpack_nibbles).
//
// Design: one block per (BM x BN) output tile, 256 threads, each holding a
// (BM/16 x BN/16) int32 accumulator tile in registers while the block
// walks K in 64-byte slabs staged through shared memory; the contraction
// is dp4a (four int8 MACs per instruction, exact int32).  Packed weights
// ((N, K/2) uint8, low nibble = even k) are unpacked to sign-extended int8
// words on their way into shared memory, so device-memory reads of W stay
// halved.  The epilogue applies the f32 scales in the reference's order,
// each product and sum rounded on its own (no FMA).
//
// What bounds it: decode has M = batch rows (4), so every weight byte is
// read once for 2*M operations — device-memory bandwidth.  Prefill
// (M = 256) is operation-bound; dp4a runs on the CUDA cores, well below
// the int8 tensor-core rate (mma / wgmma is later work).
#include "common.cuh"

namespace {

constexpr int BK = 64;          // k bytes per slab
constexpr int KW = BK / 4;      // 32-bit words per slab row
constexpr int NT = 256;

template <int BM, int BN, bool PACKED>
__global__ void __launch_bounds__(NT)
qmatmul_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ bias,
               const float* __restrict__ row_scale, float* __restrict__ out,
               int M, int N, int K) {
  constexpr int TM = BM / 16, TN = BN / 16;
  __shared__ int As[BM][KW + 1];
  __shared__ int Bs[BN][KW + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * KW; i += NT) {
      const int r = i / KW, c = i % KW;
      const int gm = m0 + r, gk = k0 + 4 * c;
      As[r][c] = (gm < M && gk < K) ? ld32(x + (size_t)gm * K + gk) : 0;
    }
    for (int i = tid; i < BN * KW; i += NT) {
      const int r = i / KW, c = i % KW;
      const int gn = n0 + r, gk = k0 + 4 * c;
      int v = 0;
      if (gn < N && gk < K) {
        if (PACKED) {
          const unsigned b2 = *reinterpret_cast<const unsigned short*>(
              w + (size_t)gn * (K / 2) + gk / 2);
          v = unpack4(b2);
        } else {
          v = ld32(reinterpret_cast<const int8_t*>(w) + (size_t)gn * K + gk);
        }
      }
      Bs[r][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < KW; ++c) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[ty + 16 * i][c];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[tx + 16 * j][c];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      const float s = row_scale ? __fmul_rn(scale[gn], row_scale[gm])
                                : scale[gn];
      float o = __fmul_rn(__int2float_rn(acc[i][j]), s);
      if (bias) o = __fadd_rn(o, bias[gn]);
      out[(size_t)gm * N + gn] = o;
    }
  }
}

template <int BM, int BN>
void launch(const void* x, const void* w, const void* scale, const void* bias,
            const void* row_scale, void* out, int M, int N, int K, int packed,
            cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  auto args = [&](auto kern) {
    kern<<<grid, NT, 0, stream>>>(
        static_cast<const int8_t*>(x), static_cast<const uint8_t*>(w),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<const float*>(row_scale), static_cast<float*>(out), M, N,
        K);
  };
  if (packed)
    args(qmatmul_kernel<BM, BN, true>);
  else
    args(qmatmul_kernel<BM, BN, false>);
}

}  // namespace

// x (M, K) int8; w (N, K) int8 or (N, K/2) uint8 nibbles; scale (N,) f32;
// bias (N,) f32 or null; row_scale (M,) f32 or null; out (M, N) f32.
// K % 4 == 0 and 4-byte aligned rows (checked by the Python wrapper).
// (bm, bn) is dispatch.qmatmul_blocks' choice: (16, 64) or (64, 128).
extern "C" int qmatmul_launch(const void* x, const void* w, const void* scale,
                              const void* bias, const void* row_scale,
                              void* out, int M, int N, int K, int packed,
                              int bm, int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 16 && bn == 64)
    launch<16, 64>(x, w, scale, bias, row_scale, out, M, N, K, packed, s);
  else if (bm == 64 && bn == 128)
    launch<64, 128>(x, w, scale, bias, row_scale, out, M, N, K, packed, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
