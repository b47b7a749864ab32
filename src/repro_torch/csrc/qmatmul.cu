// Operand-reordered integer matmul (paper Eq. 2) for Hopper (sm_90a).
//
//   out[m, n] = f32(sum_k x[m, k] * w[n, k]) * (scale[n] * row_scale[m]) + bias[n]
//
// Replaces the Pallas TPU kernel src/repro/kernels/qmatmul.py::qmatmul
// (bodies _qmatmul_kernel and _qmatmul_packed_kernel, _unpack_nibbles).
// Two bodies; kernels/qmatmul.py::plan picks one from the shape, and
// qmatmul_launch refuses any plan it was not built for.
//
// Decode, M <= 16 rows (qmatmul_kernel<16, 64, *>): every weight byte is
// read once for 2*M operations, so the bytes of W bound it.  One block per
// 16 x 64 output tile, 256 threads, dp4a (four int8 MACs an instruction,
// exact int32) over 64-byte K slabs staged through shared memory, so many
// blocks stream W at once.  Packed weights ((N, K/2) uint8, low nibble =
// even k) are unpacked to int8 words on their way into shared memory, so
// device-memory reads of W stay halved.
//
// Prefill and DeiT-S, M > 16 (qmatmul_mma_kernel<BM, BN, *>): the int8
// tensor cores, mma.sync m16n8k32 s8.s8 with exact int32 accumulators in
// registers.  x (M, K) is the row-major A operand and w (N, K) already the
// col-major B operand, so both come from shared memory by ldmatrix on rows
// skewed by 16 bytes (the eight rows of an ldmatrix phase hit eight bank
// groups).  K streams through a ring of STAGES slabs of MK bytes with
// 16-byte cp.async, so the next slabs land under the current one's
// products; the ragged edges of M, N and K are zero-filled by the copies
// (a source size of 0).  Packed weights are copied as nibbles (half the
// bytes) and unpacked to sign-extended int8 in shared memory once a slab,
// for all eight warps.  A block of 8 warps (2 x 4) owns a BM x BN tile
// (128 x 128, or 64 x 128 where plan wants more blocks); the grid walks
// M tiles fastest, so the blocks that share a column slab of W run
// together and W comes from device memory about once.
//
// What bounds each regime: at M = 256 the bytes of W (a 27648 x 5120 W is
// 141.6 MB against a 50 MB L2), hence W read once; at DeiT-S's shapes the
// f32 output (77.9 of 83 MB at 12672 x 1536 x 384), so the epilogue
// stages the tile through shared memory and each warp writes 16-byte
// runs.  Where the output tiles cannot fill the 132 SMs, plan splits K:
// each split writes its int32 partial sums to scratch and
// qmatmul_splitk_kernel adds them in split order (exact, no atomics)
// before the epilogue.
//
// Both bodies apply the f32 epilogue in the reference's order, each
// product and sum rounded on its own (no FMA).
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

constexpr int MK = 128;         // mma body: k bytes per slab
constexpr int STAGES = 3;       // slabs in the cp.async ring
constexpr int RS = MK + 16;     // skewed int8 slab row
constexpr int PRS = MK / 2 + 16;  // skewed nibble slab row
constexpr int CPAD = 8;         // int32 pad of an epilogue tile row

// Dynamic shared memory of qmatmul_mma_kernel: STAGES (x, w) slabs, the
// unpacked w slab of the packed body, and the int32 output tile of the
// epilogue laid over them.
template <int BM, int BN, bool PACKED>
struct MmaLayout {
  static constexpr int A = BM * RS;
  static constexpr int B = BN * (PACKED ? PRS : RS);
  static constexpr int U = PACKED ? BN * RS : 0;
  static constexpr int PIPE = STAGES * (A + B) + U;
  static constexpr int C = 4 * BM * (BN + CPAD);
  static constexpr int TOTAL = PIPE > C ? PIPE : C;
  // Two blocks an SM: 228 KB of shared memory, 1 KB of it reserved a block.
  static_assert(2 * (TOTAL + 1024) <= 228 * 1024, "two blocks an SM");
};

// Four packed bytes (eight nibbles, low nibble = even k) -> two words of
// four sign-extended int8 codes in k order.
__device__ __forceinline__ void unpack8(unsigned p, unsigned& w0,
                                        unsigned& w1) {
  const unsigned lo = p & 0x0F0F0F0Fu, hi = (p >> 4) & 0x0F0F0F0Fu;
  w0 = __byte_perm(lo, hi, 0x5140);
  w1 = __byte_perm(lo, hi, 0x7362);
  w0 |= ((w0 >> 3) & 0x01010101u) * 0xF0u;
  w1 |= ((w1 >> 3) & 0x01010101u) * 0xF0u;
}

// The reference's epilogue for one element, rounded op by op.
__device__ __forceinline__ float epilogue(int acc, const float* scale,
                                          const float* bias,
                                          const float* row_scale, int m,
                                          int n) {
  const float s = row_scale ? __fmul_rn(scale[n], row_scale[m]) : scale[n];
  const float o = __fmul_rn(__int2float_rn(acc), s);
  return bias ? __fadd_rn(o, bias[n]) : o;
}

// Output tile (blockIdx.x, blockIdx.y) over the slabs of split blockIdx.z
// of gridDim.z (as even a cut of the slabs as whole slabs allow; none is
// empty, as the launcher takes no more splits than slabs).  part == null:
// the epilogue into out; else the int32 sums into part[blockIdx.z] (M, N).
template <int BM, int BN, bool PACKED>
__global__ void __launch_bounds__(NT, 2)
qmatmul_mma_kernel(const int8_t* __restrict__ x,
                   const uint8_t* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias,
                   const float* __restrict__ row_scale,
                   float* __restrict__ out, int* __restrict__ part, int M,
                   int N, int K) {
  using L = MmaLayout<BM, BN, PACKED>;
  constexpr int WM = BM / 2, WN = BN / 4;    // warp tile, 2 x 4 warps
  constexpr int MT = WM / 16, NP = WN / 16;  // m16 tiles, n16 pairs
  constexpr int WB = PACKED ? MK / 2 : MK;   // w bytes of a row a slab
  constexpr int WRS = PACKED ? PRS : RS;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int KB = PACKED ? K / 2 : K;         // w bytes of a row
  const int slabs = (K + MK - 1) / MK;
  const int s0 = blockIdx.z * slabs / gridDim.z;
  const int nit = (blockIdx.z + 1) * slabs / gridDim.z - s0;

  auto load = [&](int it) {
    const int k0 = (s0 + it) * MK;
    uint8_t* as = smem + (it % STAGES) * (L::A + L::B);
    uint8_t* bs = as + L::A;
    for (int i = tid; i < BM * (MK / 16); i += NT) {
      const int r = i / (MK / 16), c = i % (MK / 16);
      const int gm = m0 + r, gk = k0 + 16 * c;
      const bool ok = gm < M && gk < K;
      cp_async16_zfill(as + r * RS + 16 * c,
                       ok ? x + (size_t)gm * K + gk : x, ok);
    }
    for (int i = tid; i < BN * (WB / 16); i += NT) {
      const int r = i / (WB / 16), c = i % (WB / 16);
      const int gn = n0 + r, gb = k0 * WB / MK + 16 * c;
      const bool ok = gn < N && gb < KB;
      cp_async16_zfill(bs + r * WRS + 16 * c,
                       ok ? w + (size_t)gn * KB + gb : w, ok);
    }
  };

  int acc[MT][2 * NP][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) {
    if (it < nit) load(it);
    cp_commit();
  }
  for (int it = 0; it < nit; ++it) {
    cp_wait<STAGES - 2>();      // slab it has landed
    __syncthreads();            // ... for every thread; slab it-1 is free
    if (it + STAGES - 1 < nit) load(it + STAGES - 1);
    cp_commit();
    const uint8_t* as = smem + (it % STAGES) * (L::A + L::B);
    const uint8_t* bs = as + L::A;
    if (PACKED) {
      uint8_t* us = smem + STAGES * (L::A + L::B);
      for (int i = tid; i < BN * (WB / 16); i += NT) {
        const int r = i / (WB / 16), c = i % (WB / 16);
        const uint4 p = *reinterpret_cast<const uint4*>(bs + r * PRS + 16 * c);
        uint4 lo, hi;
        unpack8(p.x, lo.x, lo.y);
        unpack8(p.y, lo.z, lo.w);
        unpack8(p.z, hi.x, hi.y);
        unpack8(p.w, hi.z, hi.w);
        uint4* d = reinterpret_cast<uint4*>(us + r * RS + 32 * c);
        d[0] = lo;
        d[1] = hi;
      }
      __syncthreads();
      bs = us;
    }
#pragma unroll
    for (int ks = 0; ks < MK / 32; ++ks) {
      unsigned a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(a[i], as + (wm * WM + 16 * i + (lane % 8) +
                            ((lane / 8) % 2) * 8) * RS +
                          ks * 32 + (lane / 16) * 16);
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        unsigned b[4];
        ldsm_x4(b, bs + (wn * WN + 16 * j + (lane % 8) + (lane / 16) * 8) *
                            RS +
                       ks * 32 + ((lane / 8) % 2) * 16);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_s8(acc[i][2 * j], a[i], b[0], b[1]);
          mma_s8(acc[i][2 * j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();              // the slabs are dead: the tile goes over them

  constexpr int CS = BN + CPAD;
  int* cs = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j) {
      const int r = wm * WM + 16 * i + lane / 4;
      const int c = wn * WN + 8 * j + 2 * (lane % 4);
      *reinterpret_cast<int2*>(cs + r * CS + c) =
          make_int2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<int2*>(cs + (r + 8) * CS + c) =
          make_int2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();

  // Row by row, four columns a thread: 16-byte stores where N keeps them
  // aligned, element stores at the ragged edge.
  constexpr int TPR = BN / 4, RPP = NT / TPR;
  const int c = 4 * (tid % TPR), gn = n0 + c;
  const bool vec = N % 4 == 0 && gn + 4 <= N;
  for (int r = tid / TPR; r < BM && m0 + r < M; r += RPP) {
    const int gm = m0 + r;
    const int4 v = *reinterpret_cast<const int4*>(cs + r * CS + c);
    const int vs[4] = {v.x, v.y, v.z, v.w};
    if (part) {
      int* o = part + ((size_t)blockIdx.z * M + gm) * N + gn;
      if (vec) {
        *reinterpret_cast<int4*>(o) = v;
      } else {
        for (int e = 0; e < 4 && gn + e < N; ++e) o[e] = vs[e];
      }
    } else {
      float* o = out + (size_t)gm * N + gn;
      if (vec) {
        float4 f;
        f.x = epilogue(vs[0], scale, bias, row_scale, gm, gn);
        f.y = epilogue(vs[1], scale, bias, row_scale, gm, gn + 1);
        f.z = epilogue(vs[2], scale, bias, row_scale, gm, gn + 2);
        f.w = epilogue(vs[3], scale, bias, row_scale, gm, gn + 3);
        *reinterpret_cast<float4*>(o) = f;
      } else {
        for (int e = 0; e < 4 && gn + e < N; ++e)
          o[e] = epilogue(vs[e], scale, bias, row_scale, gm, gn + e);
      }
    }
  }
}

// Split-K's second launch: one element a thread, the splits' int32 sums
// added in split order, then the epilogue.
__global__ void __launch_bounds__(NT)
qmatmul_splitk_kernel(const int* __restrict__ part,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias,
                        const float* __restrict__ row_scale,
                        float* __restrict__ out, int M, int N, int splits) {
  const size_t mn = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * NT + threadIdx.x;
  if (i >= mn) return;
  int acc = 0;
  for (int z = 0; z < splits; ++z) acc += part[z * mn + i];
  out[i] = epilogue(acc, scale, bias, row_scale, static_cast<int>(i / N),
                    static_cast<int>(i % N));
}

struct Args {
  const int8_t* x;
  const uint8_t* w;
  const float *scale, *bias, *row_scale;
  float* out;
  int* part;
  int M, N, K;
  cudaStream_t stream;
};

cudaError_t launch_dp4a(const Args& a, bool packed) {
  const dim3 grid((a.N + 63) / 64, (a.M + 15) / 16);
  if (packed)
    qmatmul_kernel<16, 64, true><<<grid, NT, 0, a.stream>>>(
        a.x, a.w, a.scale, a.bias, a.row_scale, a.out, a.M, a.N, a.K);
  else
    qmatmul_kernel<16, 64, false><<<grid, NT, 0, a.stream>>>(
        a.x, a.w, a.scale, a.bias, a.row_scale, a.out, a.M, a.N, a.K);
  return cudaGetLastError();
}

template <int BM, int BN, bool PACKED>
cudaError_t mma_body(const Args& a, int splits) {
  constexpr int smem = MmaLayout<BM, BN, PACKED>::TOTAL;
  static size_t done[16];
  const auto kern = qmatmul_mma_kernel<BM, BN, PACKED>;
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(kern), smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.M + BM - 1) / BM, (a.N + BN - 1) / BN, splits);
  kern<<<grid, NT, smem, a.stream>>>(a.x, a.w, a.scale, a.bias, a.row_scale,
                                     a.out, splits > 1 ? a.part : nullptr,
                                     a.M, a.N, a.K);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = (size_t)a.M * a.N;
  qmatmul_splitk_kernel<<<(unsigned)((mn + NT - 1) / NT), NT, 0,
                            a.stream>>>(a.part, a.scale, a.bias, a.row_scale,
                                        a.out, a.M, a.N, splits);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_mma(const Args& a, bool packed, int splits) {
  return packed ? mma_body<BM, BN, true>(a, splits)
                : mma_body<BM, BN, false>(a, splits);
}

}  // namespace

// x (M, K) int8; w (N, K) int8 or (N, K/2) uint8 nibbles; scale (N,) f32;
// bias (N,) f32 or null; row_scale (M,) f32 or null; out (M, N) f32; rows
// 16-byte aligned.  (body, bm, bn, splits) is kernels/qmatmul.py::plan:
// body 0 is dp4a with (16, 64, 1) and K % 4 == 0; body 1 is mma with
// (128, 128) or (64, 128), K % 16 == 0 (K % 32 packed), splits no more
// than K's slabs and, for splits > 1, part: (splits, M, N) int32 scratch.
// Anything else returns cudaErrorInvalidValue and launches nothing.
extern "C" int qmatmul_launch(const void* x, const void* w, const void* scale,
                              const void* bias, const void* row_scale,
                              void* out, void* part, int M, int N, int K,
                              int packed, int body, int bm, int bn,
                              int splits, void* stream) {
  const Args a{static_cast<const int8_t*>(x), static_cast<const uint8_t*>(w),
               static_cast<const float*>(scale),
               static_cast<const float*>(bias),
               static_cast<const float*>(row_scale), static_cast<float*>(out),
               static_cast<int*>(part), M, N, K,
               static_cast<cudaStream_t>(stream)};
  const cudaError_t bad = cudaErrorInvalidValue;
  cudaError_t err = bad;
  if (body == 0 && bm == 16 && bn == 64 && splits == 1 && K % 4 == 0)
    err = launch_dp4a(a, packed);
  else if (body == 1 && splits >= 1 && splits <= (K + MK - 1) / MK &&
           K % (packed ? 32 : 16) == 0 && (splits == 1 || part)) {
    if (bm == 128 && bn == 128)
      err = launch_mma<128, 128>(a, packed, splits);
    else if (bm == 64 && bn == 128)
      err = launch_mma<64, 128>(a, packed, splits);
  }
  return static_cast<int>(err);
}
