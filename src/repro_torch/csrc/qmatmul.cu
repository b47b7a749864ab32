// Operand-reordered integer matmul (paper Eq. 2) for Hopper (sm_90a).
//
//   out[m, n] = f32(sum_k x[m, k] * w[n, k]) * (scale[n] * row_scale[m]) + bias[n]
//
// Replaces the Pallas TPU kernel src/repro/kernels/qmatmul.py::qmatmul
// (bodies _qmatmul_kernel and _qmatmul_packed_kernel, _unpack_nibbles).
// Two bodies; kernels/qmatmul.py::plan picks one from the shape, and
// qmatmul_launch refuses any plan it was not built for.
//
// Decode, M <= 16 rows (qmatmul_stream_kernel<R, T8, *>): every weight
// byte is read once for 2*M operations, so the bytes of W bound it, and
// the body streams W from device memory straight into the tensor cores'
// registers.  The operands are swapped: W is the m16 side of
// mma.sync.m16n8k32 s8.s8 and x^T the n8 side (T8 = 1 n8 tile for M <= 8,
// 2 for M <= 16), so no product row multiplies padding beyond the n8
// tile.  An int32 dot product is exact in any order of k, so the fragment's
// logical k may be any bijection onto the bytes of a chunk, applied alike
// to W and x: lane (g, t) loads 16 bytes of W rows g and g + 8 at byte 16t
// of a 64-byte chunk, words 0-1 feeding the a0/a2 (a1/a3) words of one mma
// and words 2-3 those of the next, and 16 bytes of x row g at the same
// offset as the matching b0/b1 words.  W thus goes from 128-bit
// ld.global.nc (no L1 allocation) to registers, with no shared memory and
// no ldmatrix; each lane keeps SLOADS such loads in flight.  A block's
// eight warps take contiguous K ranges of the same 16R rows of W (R row
// groups share each x chunk in registers) and add their int32 partials in
// warp order through shared memory (StreamLayout) before the epilogue:
// one launch, no atomics.  Packed weights load 16 bytes of nibbles (32
// codes) and unpack them in registers (unpack8); x then comes as 32
// contiguous bytes a lane, in the same k order.  Ragged N and K are
// predicated (zero-filled) loads; the output is stored element by element.
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
// What bounds each regime: at M <= 16 and at M = 256 the bytes of W (a 27648 x 5120 W is
// 141.6 MB against a 50 MB L2), hence W read once; at DeiT-S's shapes the
// f32 output (77.9 of 83 MB at 12672 x 1536 x 384), so the epilogue
// stages the tile through shared memory and each warp writes 16-byte
// runs.  Where the output tiles cannot fill the 132 SMs, plan splits K:
// each split writes its int32 partial sums to scratch and
// qmatmul_splitk_kernel adds them in split order (exact, no atomics)
// before the epilogue.
//
// Both bodies apply the f32 epilogue in the reference's order, each
// product and sum rounded on its own (no FMA).  In accumulator mode (acc
// given) they skip it and write the exact int32 sums as the result, for
// callers that add the sums of several K slices before one epilogue (a
// row-parallel linear over the ranks of a mesh).
#include "common.cuh"

namespace {

constexpr int NT = 256;

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
// added in split order, then the epilogue into out, or the sum into acc.
__global__ void __launch_bounds__(NT)
qmatmul_splitk_kernel(const int* __restrict__ part,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias,
                        const float* __restrict__ row_scale,
                        float* __restrict__ out, int* __restrict__ acc,
                        int M, int N, int splits) {
  const size_t mn = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * NT + threadIdx.x;
  if (i >= mn) return;
  int sum = 0;
  for (int z = 0; z < splits; ++z) sum += part[z * mn + i];
  if (acc)
    acc[i] = sum;
  else
    out[i] = epilogue(sum, scale, bias, row_scale, static_cast<int>(i / N),
                      static_cast<int>(i % N));
}

constexpr int SK = 64;           // stream body: bytes of a W row a chunk
constexpr int SWARPS = NT / 32;  // its warps, each over its own K range
constexpr int SLOADS = 8;        // 16-byte loads of W a lane has in flight

// Static shared memory of qmatmul_stream_kernel: each warp's int32
// partial sums of the block's (8 T8) x (16 R) output tile, an x row padded
// by 4 words so a fragment's stores (x rows 2t apart, W rows g) hit 32
// distinct banks.
template <int R, int T8>
struct StreamLayout {
  static constexpr int ROWS = 16 * R;        // W rows (output columns)
  static constexpr int CS = ROWS + 4;        // int32 stride of an x row
  static constexpr int PART = 8 * T8 * CS;   // one warp's partials
  static constexpr int TOTAL = 4 * SWARPS * PART;
  // Static shared memory, so two blocks an SM fit as well.
  static_assert(TOTAL <= 48 * 1024, "static shared memory");
};

// 16 bytes of W, or zeros when !ok (nothing is read): the non-coherent
// path without allocating in L1 (each byte is read once), with a 128-byte
// L2 prefetch, so a row's two 64-byte chunks come from device memory as
// one line.
__device__ __forceinline__ uint4 ld_w16(const void* p, bool ok) {
  uint4 v;
  asm("{\n .reg .pred q;\n setp.ne.b32 q, %5, 0;\n"
      " mov.b32 %0, 0;\n mov.b32 %1, 0;\n mov.b32 %2, 0;\n mov.b32 %3, 0;\n"
      " @q ld.global.nc.L1::no_allocate.L2::128B.v4.u32 {%0, %1, %2, %3}, "
      "[%4];\n}\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "r"(static_cast<int>(ok)));
  return v;
}

// 16 bytes of x, or zeros when !ok: cached in L1, where the blocks on an
// SM read the same x chunks.
__device__ __forceinline__ uint4 ld_x16(const void* p, bool ok) {
  uint4 v;
  asm("{\n .reg .pred q;\n setp.ne.b32 q, %5, 0;\n"
      " mov.b32 %0, 0;\n mov.b32 %1, 0;\n mov.b32 %2, 0;\n mov.b32 %3, 0;\n"
      " @q ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n}\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "r"(static_cast<int>(ok)));
  return v;
}

// A lane's 16 bytes of W as the words of its fragments in k order: four
// int8 words, or eight words of codes unpacked from 32 nibbles.
template <bool PACKED>
__device__ __forceinline__ void w_words(const uint4& v,
                                        unsigned (&o)[PACKED ? 8 : 4]) {
  if constexpr (PACKED) {
    unpack8(v.x, o[0], o[1]);
    unpack8(v.y, o[2], o[3]);
    unpack8(v.z, o[4], o[5]);
    unpack8(v.w, o[6], o[7]);
  } else {
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  }
}

// Output columns n0 .. n0 + 16R of every row m < M <= 8 T8: the 16R rows
// of W of block blockIdx.x, each warp over its contiguous share of the
// K chunks (none when the chunks are fewer than the warps); the epilogue
// into out, or the int32 sums into acc.
template <int R, int T8, bool PACKED>
__global__ void __launch_bounds__(NT, 2)
qmatmul_stream_kernel(const int8_t* __restrict__ x,
                      const uint8_t* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      const float* __restrict__ row_scale,
                      float* __restrict__ out, int* __restrict__ acc_out,
                      int M, int N, int K) {
  using L = StreamLayout<R, T8>;
  constexpr int U = SLOADS / (2 * R);  // chunks a step
  constexpr int XL = PACKED ? 2 : 1;   // 16-byte x loads a chunk and row
  constexpr int S = 2 * XL;            // mma (k32 steps) a chunk
  __shared__ int red[SWARPS][L::PART];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * L::ROWS;
  const int KB = PACKED ? K / 2 : K;   // bytes of a W row
  const int chunks = (KB + SK - 1) / SK;
  const int c0 = warp * chunks / SWARPS;
  const int c1 = (warp + 1) * chunks / SWARPS;

  // This lane's rows: W rows n0 + 16i + 8h + g at byte 16t of a chunk, x
  // rows 8j + g at the same k (byte 16t, or 32t beside nibbles).
  const uint8_t* wr[R][2];
  bool wok[R][2];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 16 * i + 8 * h + g;
      wok[i][h] = n < N;
      wr[i][h] = w + (size_t)(wok[i][h] ? n : 0) * KB + 16 * t;
    }
  const int8_t* xr[T8];
  bool xok[T8];
#pragma unroll
  for (int j = 0; j < T8; ++j) {
    const int m = 8 * j + g;
    xok[j] = m < M;
    xr[j] = x + (size_t)(xok[j] ? m : 0) * K + 16 * XL * t;
  }

  int acc[R][T8][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < T8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int c = c0; c < c1; c += U) {
    uint4 wv[U][R][2], xv[U][T8][XL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int cc = c + u;
      const bool ok = cc < c1 && cc * SK + 16 * t < KB;
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wv[u][i][h] = ld_w16(wr[i][h] + (size_t)cc * SK, ok && wok[i][h]);
#pragma unroll
      for (int j = 0; j < T8; ++j)
#pragma unroll
        for (int p = 0; p < XL; ++p)
          xv[u][j][p] = ld_x16(xr[j] + (size_t)cc * XL * SK + 16 * p,
                               ok && xok[j]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      unsigned b[T8][2 * S];           // x words in the same k order
#pragma unroll
      for (int j = 0; j < T8; ++j)
#pragma unroll
        for (int p = 0; p < XL; ++p) {
          b[j][4 * p] = xv[u][j][p].x, b[j][4 * p + 1] = xv[u][j][p].y;
          b[j][4 * p + 2] = xv[u][j][p].z, b[j][4 * p + 3] = xv[u][j][p].w;
        }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        unsigned lo[2 * S], hi[2 * S];  // W rows g and g + 8
        w_words<PACKED>(wv[u][i][0], lo);
        w_words<PACKED>(wv[u][i][1], hi);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const unsigned a[4] = {lo[2 * s], hi[2 * s], lo[2 * s + 1],
                                 hi[2 * s + 1]};
#pragma unroll
          for (int j = 0; j < T8; ++j)
            mma_s8(acc[i][j], a, b[j][2 * s], b[j][2 * s + 1]);
        }
      }
    }
  }

  // D rows are W rows, D columns x rows: c0, c1 at (g, 2t), (g, 2t + 1),
  // c2, c3 eight W rows on.
  int* part = red[warp];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < T8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          part[(8 * j + 2 * t + e) * L::CS + 16 * i + 8 * h + g] =
              acc[i][j][2 * h + e];
  __syncthreads();
  for (int e = threadIdx.x; e < 8 * T8 * L::ROWS; e += NT) {
    const int m = e / L::ROWS, r = e % L::ROWS, n = n0 + r;
    if (m >= M || n >= N) continue;
    int sum = 0;
    for (int v = 0; v < SWARPS; ++v) sum += red[v][m * L::CS + r];
    if (acc_out)
      acc_out[(size_t)m * N + n] = sum;
    else
      out[(size_t)m * N + n] = epilogue(sum, scale, bias, row_scale, m, n);
  }
}

struct Args {
  const int8_t* x;
  const uint8_t* w;
  const float *scale, *bias, *row_scale;
  float* out;
  int* part;
  int* acc;
  int M, N, K;
  cudaStream_t stream;
};

template <int R, int T8>
cudaError_t stream_body(const Args& a, bool packed) {
  const dim3 grid((a.N + 16 * R - 1) / (16 * R));
  if (packed)
    qmatmul_stream_kernel<R, T8, true><<<grid, NT, 0, a.stream>>>(
        a.x, a.w, a.scale, a.bias, a.row_scale, a.out, a.acc, a.M, a.N, a.K);
  else
    qmatmul_stream_kernel<R, T8, false><<<grid, NT, 0, a.stream>>>(
        a.x, a.w, a.scale, a.bias, a.row_scale, a.out, a.acc, a.M, a.N, a.K);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_stream(const Args& a, bool packed, int bm) {
  return bm == 8 ? stream_body<R, 1>(a, packed) : stream_body<R, 2>(a, packed);
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
  // One split in accumulator mode: its int32 sums are the result.
  kern<<<grid, NT, smem, a.stream>>>(a.x, a.w, a.scale, a.bias, a.row_scale,
                                     a.out, splits > 1 ? a.part : a.acc,
                                     a.M, a.N, a.K);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = (size_t)a.M * a.N;
  qmatmul_splitk_kernel<<<(unsigned)((mn + NT - 1) / NT), NT, 0,
                            a.stream>>>(a.part, a.scale, a.bias, a.row_scale,
                                        a.out, a.acc, a.M, a.N, splits);
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
// 16-byte aligned; K % 16 == 0 (K % 32 packed).  (body, bm, bn, splits)
// is kernels/qmatmul.py::plan: body 0 is the stream body with M <= 16, bm
// 8 (M <= 8) or 16, bn 16 or 32 and one split; body 1 is mma with
// (128, 128) or (64, 128), splits no more than K's slabs and, for
// splits > 1, part: (splits, M, N) int32 scratch.  acc (M, N) int32 or
// null: when given, the exact sums go there, the epilogue is skipped and
// scale, bias, row_scale and out are not read (they may be null).
// Anything else returns cudaErrorInvalidValue and launches nothing.
extern "C" int qmatmul_launch(const void* x, const void* w, const void* scale,
                              const void* bias, const void* row_scale,
                              void* out, void* part, void* acc, int M, int N,
                              int K, int packed, int body, int bm, int bn,
                              int splits, void* stream) {
  const Args a{static_cast<const int8_t*>(x), static_cast<const uint8_t*>(w),
               static_cast<const float*>(scale),
               static_cast<const float*>(bias),
               static_cast<const float*>(row_scale), static_cast<float*>(out),
               static_cast<int*>(part), static_cast<int*>(acc), M, N, K,
               static_cast<cudaStream_t>(stream)};
  const cudaError_t bad = cudaErrorInvalidValue;
  cudaError_t err = bad;
  if (K % (packed ? 32 : 16) != 0) return static_cast<int>(bad);
  if (!acc && (!out || !scale)) return static_cast<int>(bad);
  if (body == 0 && M >= 1 && M <= 16 && bm == (M <= 8 ? 8 : 16) &&
      splits == 1) {
    if (bn == 16)
      err = launch_stream<1>(a, packed, bm);
    else if (bn == 32)
      err = launch_stream<2>(a, packed, bm);
  } else if (body == 1 && splits >= 1 && splits <= (K + MK - 1) / MK &&
             (splits == 1 || part)) {
    if (bm == 128 && bn == 128)
      err = launch_mma<128, 128>(a, packed, splits);
    else if (bm == 64 && bn == 128)
      err = launch_mma<64, 128>(a, packed, splits);
  }
  return static_cast<int>(err);
}
