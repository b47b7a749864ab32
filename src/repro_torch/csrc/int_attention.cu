// Integer attention with the embedded base-2 softmax, for Hopper (sm_90a).
//
// Every kernel here shares one online quantizer (kernels/ref.py):
//   x = acc * sc (masked -> -1e30, clamped at -120); running integer
//   m = floor(max); e = (1 + r) * 2^(x - m); codes p = clip(rint(e*qmax/2),
//   0, qmax); int32 PV; the f32 carries (Sigma, PV) rescaled by the exact
//   2^(m_old - m_new); out = acc * ((2/qmax) / Sigma * dv).
//
// attention_kernel<FUSED> replaces the Pallas TPU kernel
//   src/repro/kernels/int_attention.py::int_attention_fused
//   (_fused_kernel, _live_kblock_meta, _tile_logits, _online_update,
//   _pv_dot, _grid_scales): prompt-prefill attention.
//   One block of 256 threads per (head-fold h, tile of BM query rows) walks
//   its live bk key blocks in order (the TPU's sequential key grid axis
//   becomes this loop; a block no (row, key) pair of the tile can see is
//   skipped, which is bit-exact).  BM (64, 32 or 16) is the kernel's own
//   tile, chosen by the wrapper to fit shared memory: each row takes its
//   scale from sc[h, row / bq] and its position from row % sq_mod, so the
//   dispatch's bq is not the kernel's.  QK^T and PV run on the int8 tensor
//   cores: mma.sync m16n8k32 s8.s8 (q tile row-major, k tile row-major =
//   col-major K^T) and u8.s8 (the code tile, unsigned so 8-bit grids reach
//   code 255 without a -128 bias, against the transposed v tile).  Both
//   products are exact int32.  The key block streams through shared memory
//   as sub-tiles of KT keys (K sub-tiles, then V sub-tiles) in a two-deep
//   cp.async ring, so the next sub-tile lands under the current one's
//   products and softmax; V is transposed in shared memory with byte
//   permutes.  The block's f32 logits stay in shared memory until its
//   floor(max) is known; row max, codes and Sigma then run one warp per
//   row, lane-strided with a __shfl tree, as the plain version's order is
//   held to a tolerance and the two-pass kernel's bit for bit.  Bound: int8
//   operations (Sq*Sk*D*2 per head-fold, halved by causality) or, at
//   DeiT-S's shapes, the bytes.
//
// The two-pass kernel replaces
//   src/repro/kernels/int_attention.py::int_attention (_stats_kernel,
//   _pv_kernel), the reference's baseline: the same device code as the
//   fused kernel (attention_kernel<MODE>), run as a Sigma pass (STATS:
//   no V, no PV, no codes; writes max(Sigma, 1e-30) per row) and a PV pass
//   (PV: recomputes QK^T and the same running-m codes, reads Sigma).  Both
//   passes keep the fused kernel's order of every sum, so the two-pass
//   output equals the fused output bit for bit.  Bound: int8 operations,
//   QK^T twice.
//
// paged_decode_kernel replaces
//   src/repro/kernels/int_attention.py::int_paged_decode_attention
//   (_paged_decode_kernel, _paged_meta): every engine decode step.
//   One block per (kv head h, sequence b) loads its own pos and page ids
//   (the TPU's scalar prefetch) and walks its live pages in logical order.
//   A row's pages are never split across blocks: a split would quantize
//   against a partial running max and emit different codes.  int4 pools
//   are unpacked in shared memory.  The f32 output carries sit in
//   registers up to G * D = 2048 and in shared memory above.  Bound: the
//   live KV bytes.
//
// The ring decode kernels replace
//   src/repro/kernels/int_attention.py::int_decode_attention
//   (_decode_kernel, _decode_meta): every decode step over the KV ring
//   cache of models/lm.py.  Each head-fold's ring is split into chunks of
//   C keys (C divides bk), one block per (chunk, head-fold), in three
//   launches on the stream with scratch from the wrapper: a sequence of
//   launches rather than a thread-block cluster, because a cluster holds
//   at most 8 blocks and the split wants every chunk of a long ring in
//   flight at once.
//   1. ring_logits_kernel: a chunk none of whose slots holds a live key
//      (k_positions negative, after pos, or outside the window; pos read on
//      the device) marks itself dead and reads nothing more.  Otherwise
//      its key rows come in as coalesced 16-byte loads (lanes across D;
//      byte loads where D or the ring's rows are not 16-byte aligned, and
//      int4 nibbles unpacked in shared memory), each thread takes one key
//      against all G query rows with dp4a, and the chunk writes its logits
//      and, per query row, the chunk maximum.
//   2. ring_pv_kernel: the bk block's running m_t = floor(max over the
//      chunks up to the block's end) (a maximum is order-free, so chunk
//      maxima reduce exactly), then the chunk's codes, its f32 Sigma and
//      its int32 PV, written as partials.
//   3. ring_merge_kernel: per (row, column), the blocks in slot order:
//      the block's int32 PV summed over its chunks before the one float
//      conversion (exact), Sigma over its chunks in chunk order, and the
//      f32 carries rescaled by 2^(m_{t-1} - m_t) in block order.
//   Only Sigma, an f32 sum, changes order against the plain version; codes
//   and the int32 partials are exact.  No atomics.  Shared memory holds
//   one chunk's logits and one D-slice of its keys or values, so any G and
//   D the dispatch accepts fit (G * C and the slice are the only terms
//   that grow).  Bound: the live KV bytes.
//
// Sigma is an f32 sum over a tile taken in another order than the plain
// versions take it, so outputs agree within a tolerance; codes, m and the
// int32 partials agree exactly.
#include "common.cuh"

namespace {

constexpr int NTA = 256;     // prefill block: 8 warps
constexpr int MAXNP = 8;     // prefill: PV column pairs (16 columns) a warp
constexpr int NTP = 128;     // paged decode block
constexpr int MAXJP = 16;    // paged: register carries a thread (G*D <= 2048)
constexpr int NTM = 256;     // ring merge block

enum { FUSED = 0, STATS = 1, PV = 2 };

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared-memory layout of attention_kernel for a tile of bm rows, key
// sub-tiles of kt keys, key block bk and head dim d (a multiple of 16).
struct AttnLayout {
  int dp, bkp, qks, vts, xs, pcs;
  size_t q, tb, vt, x, pc, rows, total;
  __host__ __device__ AttnLayout(int bm, int kt, int bk, int d) {
    dp = round_up(d, 32);           // mma depth: q's tail columns are zero
    bkp = round_up(bk, 32);         // keys past bk are masked, codes 0
    qks = dp + 16;                  // row strides: 16 bytes off 128 so the
    vts = kt + 16;                  // eight rows of an ldmatrix phase hit
    pcs = bkp + 16;                 // eight bank groups
    xs = bkp + 8;                   // f32 row stride of the logits
    q = 0;                                        // bm x qks int8
    tb = q + (size_t)bm * qks;                    // 2 x kt x qks int8
    vt = tb + 2 * (size_t)kt * qks;               // dp x vts: vT[d][key]
    x = vt + (size_t)dp * vts;                    // bm x xs f32
    pc = x + 4 * (size_t)bm * xs;                 // bm x pcs u8 codes
    rows = pc + (size_t)bm * pcs;                 // 4 f32 + 1 int per row
    total = rows + 20 * (size_t)bm;
  }
};

// Query rows m0 .. m0+BM-1 of head-fold h against the key blocks of one
// row; MODE FUSED does everything in one sweep, STATS only Sigma (into
// sums), PV only the codes and PV (Sigma from sums).  The validity of a
// (row, key) pair is the reference's _mask: key < SK, key <= row position
// when causal, key > row position - window; a block where no pair is
// valid is skipped, which is bit-exact (e = 0, the carries keep their
// values).  NP is the largest number of 16-column PV pairs a warp holds.
template <int MODE, int NP>
__global__ void __launch_bounds__(NTA)
attention_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                 const int8_t* __restrict__ v, const float* __restrict__ sc,
                 const float* __restrict__ vs, float* __restrict__ out,
                 uint8_t* __restrict__ codes, float* __restrict__ sums,
                 int SQ, int SK, int D, int bq, int bk, int nq, int sq_mod,
                 int causal, int window, int BM, int KT, float qmax,
                 float two_over_qmax) {
  extern __shared__ __align__(16) uint8_t smem[];
  const AttnLayout L(BM, KT, bk, D);
  uint8_t* qs = smem + L.q;
  uint8_t* tb = smem + L.tb;
  uint8_t* vt = smem + L.vt;
  float* xs = reinterpret_cast<float*>(smem + L.x);
  uint8_t* pc = smem + L.pc;
  float* mrow = reinterpret_cast<float*>(smem + L.rows);
  float* srow = mrow + BM;
  float* arow = srow + BM;
  float* rsc = arow + BM;
  int* rpos = reinterpret_cast<int*>(rsc + BM);

  const int h = blockIdx.y, m0 = blockIdx.x * BM, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g8 = lane / 4, t4 = lane % 4;
  const int RW = BM / 16, CWN = (NTA / 32) / RW;
  const int rg = warp % RW, cw = warp / RW;
  const int DC = D / 16, DPC = L.dp / 16, npair = L.dp / 16;
  const int ppw = (npair + CWN - 1) / CWN;
  const int nk = (SK + bk - 1) / bk, nsub = (L.bkp + KT - 1) / KT;
  const int nitems = MODE == STATS ? nsub : 2 * nsub;
  const int rows = min(BM, SQ - m0);     // rows past SQ do no work
  const bool warp_rows = 16 * rg < rows;
  const float qmax_half = qmax * 0.5f;

  for (int r = tid; r < BM; r += NTA) {
    const int gr = m0 + r;
    mrow[r] = NEG_BIG;
    srow[r] = 0.0f;
    arow[r] = 0.0f;
    rpos[r] = gr % sq_mod;
    rsc[r] = gr < SQ ? sc[h * nq + gr / bq] : 0.0f;
  }
  for (int idx = tid; idx < BM * DPC; idx += NTA) {
    const int r = idx / DPC, c = idx % DPC, gr = m0 + r;
    uint8_t* dst = qs + r * L.qks + 16 * c;
    if (gr < SQ && c < DC)
      cp_async16(dst, q + ((size_t)h * SQ + gr) * D + 16 * c);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
  if (MODE != STATS) {          // codes past bk stay 0 for the PV products
    const int tail = L.bkp - bk;
    for (int idx = tid; idx < BM * tail; idx += NTA)
      pc[(idx / tail) * L.pcs + bk + idx % tail] = 0;
  }
  __syncthreads();

  auto block_live = [&](int kb) -> bool {
    const int k0 = kb * bk;
    int live = 0;
    for (int r = tid; r < BM; r += NTA) {
      if (m0 + r >= SQ) continue;
      const int qp = rpos[r];
      const int lo = window >= 0 ? max(qp - (window - 1), 0) : 0;
      const int hi = causal ? min(qp, SK - 1) : SK - 1;
      live |= (lo <= hi && lo <= k0 + bk - 1 && hi >= k0);
    }
    return __syncthreads_or(live);
  };
  auto next_live = [&](int kb) {
    while (kb < nk && !block_live(kb)) ++kb;
    return kb;
  };
  // Stream item it of block kb: K sub-tile it (it < nsub), else V sub-tile
  // it - nsub; keys past bk or SK are not loaded (their codes are 0 and
  // their logits masked, so what the buffer holds there is never used).
  auto load = [&](int kb, int it, int buf) {
    const int s = it % nsub, c0 = s * KT;
    const int len = min(KT, L.bkp - c0);
    const int8_t* src = it < nsub ? k : v;
    uint8_t* dst = tb + (size_t)buf * KT * L.qks;
    for (int idx = tid; idx < len * DC; idx += NTA) {
      const int r = idx / DC, c = idx % DC, kp = kb * bk + c0 + r;
      if (c0 + r < bk && kp < SK)
        cp_async16(dst + r * L.qks + 16 * c,
                   src + ((size_t)h * SK + kp) * D + 16 * c);
    }
  };

  float acc[NP][2][4];
  int ia[NP][2][4];
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][n][e] = 0.0f, ia[j][n][e] = 0;

  int kb = next_live(0), it = 0, buf = 0;
  if (kb < nk) load(kb, 0, 0);
  cp_commit();
  while (kb < nk) {
    int nkb = kb, nit = it + 1;
    if (nit == nitems) {
      nkb = next_live(kb + 1);
      nit = 0;
    }
    if (nkb < nk) load(nkb, nit, buf ^ 1);
    cp_commit();
    cp_wait<1>();               // everything but the prefetch has landed
    __syncthreads();
    const uint8_t* tile = tb + (size_t)buf * KT * L.qks;
    const int s = it % nsub, c0 = s * KT, len = min(KT, L.bkp - c0);
    const int k0 = kb * bk;

    if (it < nsub) {
      // QK^T of the sub-tile: warp (rg, cw) takes 16-key groups cw, cw+CWN..
      for (int kg = cw; warp_rows && kg < len / 16; kg += CWN) {
        int d[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
        for (int ks = 0; ks < L.dp / 32; ++ks) {
          unsigned a[4], b[4];
          ldsm_x4(a, qs + (16 * rg + (lane % 8) + ((lane / 8) % 2) * 8) *
                              L.qks + ks * 32 + (lane / 16) * 16);
          ldsm_x4(b, tile + (kg * 16 + (lane % 8) + (lane / 16) * 8) * L.qks +
                             ks * 32 + ((lane / 8) % 2) * 16);
          mma_s8(d[0], a, b[0], b[1]);
          mma_s8(d[1], a, b[2], b[3]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = 16 * rg + g8 + 8 * hf;
            const int qp = rpos[r];
            float2 xv;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = c0 + kg * 16 + n * 8 + 2 * t4 + e, kp = k0 + c;
              bool valid = c < bk && kp < SK;
              if (causal) valid &= kp <= qp;
              if (window >= 0) valid &= kp > qp - window;
              const float x =
                  valid ? __fmul_rn(__int2float_rn(d[n][2 * hf + e]), rsc[r])
                        : NEG_BIG;
              (e ? xv.y : xv.x) = fmaxf(x, -120.0f);
            }
            *reinterpret_cast<float2*>(
                xs + r * L.xs + c0 + kg * 16 + n * 8 + 2 * t4) = xv;
          }
      }
      if (it == nsub - 1) {     // the whole block's logits are in: softmax
        __syncthreads();
        // One warp per row: floor(max), then codes and Sigma in the same
        // lane-strided order (lane l takes keys l, l+32, ..., then the
        // __shfl tree), so every mode sums alike.
        for (int r = warp; r < rows; r += NTA / 32) {
          const float* xr = xs + r * L.xs;
          float mx = -INFINITY;
          for (int c = lane; c < bk; c += 32) mx = fmaxf(mx, xr[c]);
          mx = warp_max(mx);
          const float mo = mrow[r];
          const float mn = fmaxf(mo, floorf(mx));
          const float ar = carry_scale(mo, mn);
          float sum = 0.0f;
          uint8_t* gc =
              codes ? codes + ((size_t)h * SQ + m0 + r) * SK + k0 : nullptr;
          for (int c = lane; c < bk; c += 32) {
            const float x = xr[c];
            const float e = x <= -120.0f ? 0.0f : exp2_shift(__fsub_rn(x, mn));
            if (MODE != PV) sum = __fadd_rn(sum, e);
            if (MODE != STATS) {
              const uint8_t p = static_cast<uint8_t>(
                  fminf(fmaxf(rintf(__fmul_rn(e, qmax_half)), 0.0f), qmax));
              pc[r * L.pcs + c] = p;
              if (gc && k0 + c < SK) gc[c] = p;
            }
          }
          if (MODE != PV) sum = warp_sum(sum);
          if (lane == 0) {
            mrow[r] = mn;
            arow[r] = ar;
            if (MODE != PV) srow[r] = __fadd_rn(__fmul_rn(srow[r], ar), sum);
          }
        }
      }
    } else {
      // V sub-tile: transpose 4x4 byte blocks into vT[d][key], then PV.
      const int nkq = len / 4, ndq = D / 4;
      for (int idx = tid; idx < nkq * ndq; idx += NTA) {
        const int dq = idx % ndq, kq = idx / ndq;
        const uint8_t* src = tile + 4 * kq * L.qks + 4 * dq;
        const unsigned r0 = *reinterpret_cast<const unsigned*>(src);
        const unsigned r1 = *reinterpret_cast<const unsigned*>(src + L.qks);
        const unsigned r2 =
            *reinterpret_cast<const unsigned*>(src + 2 * L.qks);
        const unsigned r3 =
            *reinterpret_cast<const unsigned*>(src + 3 * L.qks);
        const unsigned t0 = __byte_perm(r0, r1, 0x5140);
        const unsigned t1 = __byte_perm(r0, r1, 0x7362);
        const unsigned t2 = __byte_perm(r2, r3, 0x5140);
        const unsigned t3 = __byte_perm(r2, r3, 0x7362);
        uint8_t* dst = vt + 4 * dq * L.vts + 4 * kq;
        *reinterpret_cast<unsigned*>(dst) = __byte_perm(t0, t2, 0x5410);
        *reinterpret_cast<unsigned*>(dst + L.vts) = __byte_perm(t0, t2, 0x7632);
        *reinterpret_cast<unsigned*>(dst + 2 * L.vts) =
            __byte_perm(t1, t3, 0x5410);
        *reinterpret_cast<unsigned*>(dst + 3 * L.vts) =
            __byte_perm(t1, t3, 0x7632);
      }
      __syncthreads();
      for (int ks = 0; warp_rows && ks < len / 32; ++ks) {
        unsigned a[4];
        ldsm_x4(a, pc + (16 * rg + (lane % 8) + ((lane / 8) % 2) * 8) * L.pcs +
                       c0 + ks * 32 + (lane / 16) * 16);
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          const int p = cw * ppw + j;
          if (j < ppw && p < npair) {
            unsigned b[4];
            ldsm_x4(b, vt + (p * 16 + (lane % 8) + (lane / 16) * 8) * L.vts +
                           ks * 32 + ((lane / 8) % 2) * 16);
            mma_u8(ia[j][0], a, b[0], b[1]);
            mma_u8(ia[j][1], a, b[2], b[3]);
          }
        }
      }
      if (it == nitems - 1) {   // the block's int32 PV is whole: fold it
#pragma unroll
        for (int j = 0; j < NP; ++j)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float a = arow[16 * rg + g8 + 8 * (e / 2)];
              acc[j][n][e] = __fadd_rn(__fmul_rn(acc[j][n][e], a),
                                       __int2float_rn(ia[j][n][e]));
              ia[j][n][e] = 0;
            }
      }
    }
    __syncthreads();
    kb = nkb;
    it = nit;
    buf ^= 1;
  }
  cp_wait<0>();

  if (MODE == STATS) {
    for (int r = tid; r < BM; r += NTA)
      if (m0 + r < SQ)
        sums[(size_t)h * SQ + m0 + r] = fmaxf(srow[r], 1e-30f);
    return;
  }
  const float dv = vs[h];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = 16 * rg + g8 + 8 * hf, gr = m0 + r;
    if (gr >= SQ) continue;
    const float s = MODE == PV ? sums[(size_t)h * SQ + gr]
                               : fmaxf(srow[r], 1e-30f);
    const float f = __fmul_rn(__fdiv_rn(two_over_qmax, s), dv);
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int p = cw * ppw + j;
      if (j >= ppw || p >= npair) continue;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = p * 16 + n * 8 + 2 * t4;
        if (col < D)
          *reinterpret_cast<float2*>(out + ((size_t)h * SQ + gr) * D + col) =
              make_float2(__fmul_rn(acc[j][n][2 * hf], f),
                          __fmul_rn(acc[j][n][2 * hf + 1], f));
      }
    }
  }
}

// Word w (values 4w .. 4w+3 of a D-slice starting at value d0) of each of
// the first nrows rows of a cache block (a ring chunk, a page, the query
// rows): rows of dk bytes from src, int8 codes or (packed) int4 nibbles,
// values at or past D read as 0.  Calls put(row, word, bits) for every
// word of the slice.  16-byte vector loads, lanes across D, when the rows
// and the slice are 16-byte aligned; byte loads otherwise (a D that is not
// a multiple of 16, or rows that are not aligned: the cache cannot be
// padded per call).
template <class Put>
__device__ __forceinline__ void load_rows(const uint8_t* __restrict__ src,
                                          int dk, int nrows, int d0, int dw,
                                          int D, int packed, int tid, int nt,
                                          Put put) {
  const int boff = packed ? d0 / 2 : d0;           // slice start, bytes
  const int vper = packed ? 32 : 16;               // values a 16-byte load
  const bool vec = (reinterpret_cast<size_t>(src) % 16 == 0) && dk % 16 == 0 &&
                   boff % 16 == 0 && dw % vper == 0;
  if (vec) {
    const int nv = dw / vper;
    for (int idx = tid; idx < nrows * nv; idx += nt) {
      const int r = idx / nv, j = idx % nv;
      const uint4 u = *reinterpret_cast<const uint4*>(
          src + (size_t)r * dk + boff + 16 * j);
      const unsigned wv[4] = {u.x, u.y, u.z, u.w};
      if (packed) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          put(r, 8 * j + 2 * i, unpack4(wv[i] & 0xFFFFu));
          put(r, 8 * j + 2 * i + 1, unpack4(wv[i] >> 16));
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) put(r, 4 * j + i, static_cast<int>(wv[i]));
      }
    }
    return;
  }
  const int nw = (dw + 3) / 4;
  for (int idx = tid; idx < nrows * nw; idx += nt) {
    const int r = idx / nw, w = idx % nw, v0 = d0 + 4 * w;
    const uint8_t* row = src + (size_t)r * dk;
    unsigned word = 0;
    if (packed) {
      const unsigned b0 = v0 < D ? row[v0 / 2] : 0;
      const unsigned b1 = v0 + 2 < D ? row[v0 / 2 + 1] : 0;
      word = static_cast<unsigned>(unpack4(b0 | (b1 << 8)));
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (v0 + b < D) word |= static_cast<unsigned>(row[v0 + b]) << (8 * b);
    }
    put(r, w, static_cast<int>(word));
  }
}

// Integer PV of one (row, column) over a page: unsigned codes by signed
// values, four keys a dp4a.
__device__ __forceinline__ int page_pv(const int* pc, const int* vt, int g,
                                       int col, int KWD, int PS) {
  int a = 0;
  for (int w = 0; w < KWD; ++w)
    a = dp4a_us(static_cast<unsigned>(pc[g * PS + w]), vt[col * PS + w], a);
  return a;
}

// SMEM_ACC: the f32 output carries live in shared memory (G * D > 2048);
// otherwise MAXJP registers a thread.
template <bool SMEM_ACC>
__global__ void __launch_bounds__(NTP)
paged_decode_kernel(const int8_t* __restrict__ q,
                    const uint8_t* __restrict__ kpool,
                    const uint8_t* __restrict__ vpool,
                    const float* __restrict__ sc, const float* __restrict__ vs,
                    const float* __restrict__ kps,
                    const float* __restrict__ vps,
                    const int* __restrict__ page_table,
                    const int* __restrict__ pos, float* __restrict__ out,
                    uint8_t* __restrict__ codes, int HKV, int G, int D, int ps,
                    int maxp, int num_phys, int window, int packed, float qmax,
                    float two_over_qmax) {
  extern __shared__ __align__(16) uint8_t smem[];
  int* const words = reinterpret_cast<int*>(smem);
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = NTP / 32;
  const int DW = (D + 3) / 4, QS = DW + 1, KWD = (ps + 3) / 4, PS = KWD + 1;
  const int dk = packed ? D / 2 : D;
  int* qs = words;                         // G x QS
  int* ks = qs + G * QS;                   // ps x QS
  int* vt = ks + ps * QS;                  // 4*DW x PS: vT[d][key]
  float* xs = reinterpret_cast<float*>(vt + 4 * DW * PS);   // G x ps
  int* pc = reinterpret_cast<int*>(xs + G * ps);         // G x PS
  float* mrow = reinterpret_cast<float*>(pc + G * PS);   // G
  float* srow = mrow + G;
  float* arow = srow + G;
  float* accs = arow + G;                  // G x D when SMEM_ACC
  uint8_t* vtb = reinterpret_cast<uint8_t*>(vt);
  uint8_t* pcb = reinterpret_cast<uint8_t*>(pc);
  const float qmax_half = qmax * 0.5f;
  const bool page_scaled = kps != nullptr;

  const size_t qrow = ((size_t)b * HKV + h) * G;
  load_rows(reinterpret_cast<const uint8_t*>(q) + qrow * D, D, G, 0, D, D, 0,
            tid, NTP, [&](int g, int w, int bits) { qs[g * QS + w] = bits; });
  const int tail = 4 * KWD - ps;           // codes past the page stay 0
  for (int idx = tid; idx < G * tail; idx += NTP)
    pcb[(idx / tail) * PS * 4 + ps + idx % tail] = 0;
  for (int g = tid; g < G; g += NTP) {
    mrow[g] = NEG_BIG;
    srow[g] = 0.0f;
  }
  float acc[SMEM_ACC ? 1 : MAXJP];
  if constexpr (SMEM_ACC) {
    for (int o = tid; o < G * D; o += NTP) accs[o] = 0.0f;
  } else {
#pragma unroll
    for (int j = 0; j < MAXJP; ++j) acc[j] = 0.0f;
  }

  const int pb = pos[b];
  const int hi = pb >= 0 ? pb / ps : -1;
  int lo = 0;
  if (window >= 0 && pb >= 0) {
    const int w0 = pb - window + 1;
    lo = w0 > 0 ? w0 / ps : 0;
  }
  const int n_live = pb >= 0 ? min(max(hi - lo + 1, 0), maxp) : 0;
  const float scb = sc[b], vsb = vs[b];
  __syncthreads();

  for (int t = 0; t < n_live; ++t) {
    const int logical = min(max(min(lo + t, hi), 0), maxp - 1);
    const int raw = page_table[(size_t)b * maxp + logical];
    if (raw < 0) continue;                      // unallocated: all masked
    const int phys = min(raw, num_phys - 1);
    const int first = logical * ps;
    const int wlo = window >= 0 ? max(pb - window + 1, 0) : 0;
    if (max(first, wlo) > min(first + ps - 1, pb)) continue;  // no live key

    const size_t page = ((size_t)phys * HKV + h) * ps * dk;
    load_rows(kpool + page, dk, ps, 0, D, D, packed, tid, NTP,
              [&](int r, int w, int bits) { ks[r * QS + w] = bits; });
    load_rows(vpool + page, dk, ps, 0, D, D, packed, tid, NTP,
              [&](int r, int w, int bits) {
#pragma unroll
                for (int bb = 0; bb < 4; ++bb)
                  vtb[(4 * w + bb) * (PS * 4) + r] = (bits >> (8 * bb)) & 0xFF;
              });
    __syncthreads();

    const float xscale = page_scaled ? __fmul_rn(scb, kps[phys]) : scb;
    for (int idx = tid; idx < G * ps; idx += NTP) {
      const int g = idx / ps, c = idx % ps;
      int a = 0;
      for (int w = 0; w < DW; ++w) a = __dp4a(qs[g * QS + w], ks[c * QS + w], a);
      const int kp = first + c;
      bool valid = kp <= pb;
      if (window >= 0) valid &= kp > pb - window;
      const float x = valid ? __fmul_rn(__int2float_rn(a), xscale) : NEG_BIG;
      xs[idx] = fmaxf(x, -120.0f);
    }
    __syncthreads();

    for (int g = warp; g < G; g += nwarps) {
      float mx = -INFINITY;
      for (int c = lane; c < ps; c += 32) mx = fmaxf(mx, xs[g * ps + c]);
      mx = warp_max(mx);
      if (lane == 0) {
        const float mo = mrow[g];
        const float mn = fmaxf(mo, floorf(mx));
        arow[g] = carry_scale(mo, mn);
        mrow[g] = mn;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < G * ps; idx += NTP) {
      const int g = idx / ps, c = idx % ps;
      const float x = xs[idx];
      const float e = x <= -120.0f ? 0.0f : exp2_shift(__fsub_rn(x, mrow[g]));
      const float p =
          fminf(fmaxf(rintf(__fmul_rn(e, qmax_half)), 0.0f), qmax);
      xs[idx] = e;
      pcb[g * PS * 4 + c] = static_cast<uint8_t>(p);
      if (codes)
        codes[(qrow + g) * ((size_t)maxp * ps) + first + c] =
            static_cast<uint8_t>(p);
    }
    __syncthreads();

    for (int g = warp; g < G; g += nwarps) {
      float sum = 0.0f;
      for (int c = lane; c < ps; c += 32) sum = __fadd_rn(sum, xs[g * ps + c]);
      sum = warp_sum(sum);
      if (lane == 0) srow[g] = __fadd_rn(__fmul_rn(srow[g], arow[g]), sum);
    }
    const float vfac = page_scaled ? __fmul_rn(vsb, vps[phys]) : 1.0f;
    if constexpr (SMEM_ACC) {
      for (int o = tid; o < G * D; o += NTP) {
        const int g = o / D;
        float pv = __int2float_rn(page_pv(pc, vt, g, o % D, KWD, PS));
        if (page_scaled) pv = __fmul_rn(pv, vfac);
        accs[o] = __fadd_rn(__fmul_rn(accs[o], arow[g]), pv);
      }
    } else {
#pragma unroll
      for (int j = 0; j < MAXJP; ++j) {
        const int o = tid + NTP * j;
        if (o < G * D) {
          const int g = o / D;
          float pv = __int2float_rn(page_pv(pc, vt, g, o % D, KWD, PS));
          if (page_scaled) pv = __fmul_rn(pv, vfac);
          acc[j] = __fadd_rn(__fmul_rn(acc[j], arow[g]), pv);
        }
      }
    }
    __syncthreads();
  }

  auto store = [&](int o, float a) {
    const int g = o / D;
    float f = __fdiv_rn(two_over_qmax, fmaxf(srow[g], 1e-30f));
    if (!page_scaled) f = __fmul_rn(f, vsb);
    out[(qrow + g) * D + o % D] = __fmul_rn(a, f);
  };
  if constexpr (SMEM_ACC) {
    for (int o = tid; o < G * D; o += NTP) store(o, accs[o]);
  } else {
#pragma unroll
    for (int j = 0; j < MAXJP; ++j)
      if (tid + NTP * j < G * D) store(tid + NTP * j, acc[j]);
  }
}

__device__ __forceinline__ bool ring_live(const int* __restrict__ kpos,
                                          int j, int span, int pos,
                                          int causal, int window) {
  if (j >= span) return false;
  const int kp = kpos[j];
  bool ok = kp >= 0;
  if (causal) ok &= kp <= pos;
  if (window >= 0) ok &= kp > pos - window;
  return ok;
}

// Shared memory of the ring kernels for chunk c, D-slice ds (a multiple
// of 16) and G query rows: the larger of the logits pass and the PV pass.
__host__ __device__ size_t ring_logits_smem(int G, int c, int ds) {
  const int dsw = ds / 4;
  return 4 * ((size_t)G * dsw + (size_t)c * (dsw + 1) + (size_t)G * c +
              (size_t)(c / 32) * G);
}
__host__ __device__ size_t ring_pv_smem(int G, int c, int ds) {
  const int pw = c / 4 + 1;
  return 4 * ((size_t)G + (size_t)G * pw + (size_t)G * c + (size_t)ds * pw);
}

// Pass 1: the logits of chunk ci (C = blockDim.x keys, one a thread) of
// head-fold h against its G query rows, and each row's chunk maximum
// (NEG_BIG for a chunk with no live key, whose logits are not written).
__global__ void __launch_bounds__(256)
ring_logits_kernel(const int8_t* __restrict__ q,
                   const uint8_t* __restrict__ k,
                   const int* __restrict__ kpos, const int* __restrict__ posp,
                   const float* __restrict__ sc, float* __restrict__ xs,
                   float* __restrict__ cm, int G, int D, int span, int ds,
                   int causal, int window, int packed) {
  extern __shared__ __align__(16) uint8_t smem[];
  int* const words = reinterpret_cast<int*>(smem);
  const int C = blockDim.x, tid = threadIdx.x, ci = blockIdx.x;
  const int h = blockIdx.y, nch = gridDim.x, k0 = ci * C;
  const int warp = tid / 32, lane = tid % 32;
  const int pos = posp[0];
  const bool live = ring_live(kpos, k0 + tid, span, pos, causal, window);
  float* cmh = cm + ((size_t)h * nch + ci) * G;
  if (!__syncthreads_or(live)) {                // dead chunk: bit-exact skip
    for (int g = tid; g < G; g += C) cmh[g] = NEG_BIG;
    return;
  }
  const int dsw = ds / 4, QS = dsw + 1, dk = packed ? D / 2 : D;
  int* qs = words;                              // G x dsw words
  int* ks = qs + G * dsw;                       // C x QS words
  int* ia = ks + C * QS;                        // G x C int32 logits
  float* wm = reinterpret_cast<float*>(ia + G * C);     // C/32 x G
  const int nrows = min(C, span - k0);
  const uint8_t* kc = k + ((size_t)h * span + k0) * dk;
  const uint8_t* qh =
      reinterpret_cast<const uint8_t*>(q) + (size_t)h * G * D;

  for (int d0 = 0; d0 < D; d0 += ds) {
    const int dw = min(ds, D - d0), nw = (dw + 3) / 4;
    load_rows(qh, D, G, d0, dw, D, 0, tid, C,
              [&](int g, int w, int bits) { qs[g * dsw + w] = bits; });
    load_rows(kc, dk, nrows, d0, dw, D, packed, tid, C,
              [&](int r, int w, int bits) { ks[r * QS + w] = bits; });
    __syncthreads();
    if (live) {                                 // dead slots skip the dots
      for (int g0 = 0; g0 < G; g0 += 8) {
        int a[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          a[r] = (d0 > 0 && g0 + r < G) ? ia[(g0 + r) * C + tid] : 0;
        for (int w = 0; w < nw; ++w) {
          const int kw = ks[tid * QS + w];
#pragma unroll
          for (int r = 0; r < 8; ++r)
            if (g0 + r < G) a[r] = __dp4a(qs[(g0 + r) * dsw + w], kw, a[r]);
        }
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if (g0 + r < G) ia[(g0 + r) * C + tid] = a[r];
      }
    }
    __syncthreads();
  }

  const float sct = sc[h];
  float* xh = xs + (size_t)h * G * span + k0;
  for (int g = 0; g < G; ++g) {
    const float x =
        live ? fmaxf(__fmul_rn(__int2float_rn(ia[g * C + tid]), sct), -120.0f)
             : -120.0f;
    if (tid < nrows) xh[(size_t)g * span + tid] = x;
    const float mx = warp_max(tid < nrows ? x : -INFINITY);
    if (lane == 0) wm[warp * G + g] = mx;
  }
  __syncthreads();
  for (int g = tid; g < G; g += C) {
    float mx = -INFINITY;
    for (int w = 0; w < C / 32; ++w) mx = fmaxf(mx, wm[w * G + g]);
    cmh[g] = mx;
  }
}

// Pass 2: the codes, Sigma and int32 PV of a live chunk against its bk
// block's running m_t.
__global__ void __launch_bounds__(256)
ring_pv_kernel(const uint8_t* __restrict__ v, const float* __restrict__ xs,
               const float* __restrict__ cm, uint8_t* __restrict__ codes,
               float* __restrict__ sp, int* __restrict__ pvp, int G, int D,
               int span, int bk, int ds, int packed, float qmax) {
  extern __shared__ __align__(16) uint8_t smem[];
  int* const words = reinterpret_cast<int*>(smem);
  const int C = blockDim.x, tid = threadIdx.x, ci = blockIdx.x;
  const int h = blockIdx.y, nch = gridDim.x, k0 = ci * C;
  const int warp = tid / 32, lane = tid % 32, nwarps = C / 32;
  const float* cmh = cm + (size_t)h * nch * G;
  if (cmh[(size_t)ci * G] <= NEG_BIG) return;   // dead chunk
  const int PW = C / 4 + 1, dk = packed ? D / 2 : D;
  float* mrow = reinterpret_cast<float*>(words);          // G
  int* pc = reinterpret_cast<int*>(mrow + G);             // G x PW words
  float* es = reinterpret_cast<float*>(pc + G * PW);      // G x C
  int* vt = reinterpret_cast<int*>(es + G * C);           // ds x PW: vT[d][key]
  uint8_t* pcb = reinterpret_cast<uint8_t*>(pc);
  uint8_t* vtb = reinterpret_cast<uint8_t*>(vt);
  const float qmax_half = qmax * 0.5f;
  const int nrows = min(C, span - k0);

  // m_t: floor of the maximum over every chunk up to the block's end.
  // (loads unrolled by 8 so they are in flight together, not one by one)
  const int cend = min((k0 / bk + 1) * (bk / C), nch);
  for (int g = tid; g < G; g += C) {
    float mx = NEG_BIG;
#pragma unroll 8
    for (int c = 0; c < cend; ++c) mx = fmaxf(mx, cmh[(size_t)c * G + g]);
    mrow[g] = floorf(mx);
  }
  __syncthreads();
  const float* xh = xs + (size_t)h * G * span + k0;
  for (int g0 = 0; g0 < G; g0 += 8) {
    float xv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      xv[j] = g0 + j < G && tid < nrows ? xh[(size_t)(g0 + j) * span + tid]
                                        : -120.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int g = g0 + j;
      if (g >= G) break;
      const float e =
          xv[j] <= -120.0f ? 0.0f : exp2_shift(__fsub_rn(xv[j], mrow[g]));
      const float p =
          fminf(fmaxf(rintf(__fmul_rn(e, qmax_half)), 0.0f), qmax);
      es[g * C + tid] = e;
      pcb[g * PW * 4 + tid] = static_cast<uint8_t>(p);
      if (codes && tid < nrows)
        codes[((size_t)h * G + g) * span + k0 + tid] = static_cast<uint8_t>(p);
    }
  }
  __syncthreads();
  for (int g = warp; g < G; g += nwarps) {
    float sum = 0.0f;
    for (int c = lane; c < C; c += 32) sum = __fadd_rn(sum, es[g * C + c]);
    sum = warp_sum(sum);
    if (lane == 0) sp[((size_t)h * nch + ci) * G + g] = sum;
  }

  const uint8_t* vc = v + ((size_t)h * span + k0) * dk;
  int* pvh = pvp + ((size_t)h * nch + ci) * G * D;
  for (int d0 = 0; d0 < D; d0 += ds) {
    const int dw = min(ds, D - d0);
    load_rows(vc, dk, nrows, d0, dw, D, packed, tid, C,
              [&](int r, int w, int bits) {
#pragma unroll
                for (int b = 0; b < 4; ++b)
                  vtb[(4 * w + b) * (PW * 4) + r] = (bits >> (8 * b)) & 0xFF;
              });
    __syncthreads();
    for (int o = tid; o < G * dw; o += C) {
      const int g = o / dw, d = o % dw;
      int a = 0;
      for (int w = 0; w < C / 4; ++w)
        a = dp4a_us(static_cast<unsigned>(pc[g * PW + w]), vt[d * PW + w], a);
      pvh[(size_t)g * D + d0 + d] = a;
    }
    __syncthreads();
  }
}

// Pass 3: one thread per (row g, column d) of head-fold h merges the live
// chunks, block by block in slot order.
__global__ void __launch_bounds__(NTM)
ring_merge_kernel(const float* __restrict__ cm, const float* __restrict__ sp,
                  const int* __restrict__ pvp, const float* __restrict__ vs,
                  float* __restrict__ out, int G, int D, int nch, int cpb,
                  float two_over_qmax) {
  const int h = blockIdx.y, o = blockIdx.x * NTM + threadIdx.x;
  if (o >= G * D) return;
  const int g = o / D, d = o % D;
  const float* cmh = cm + (size_t)h * nch * G + g;
  const float* sph = sp + (size_t)h * nch * G + g;
  const int* pvh = pvp + (size_t)h * nch * G * D + (size_t)g * D + d;
  float m = NEG_BIG, s = 0.0f, acc = 0.0f;
  for (int c0 = 0; c0 < nch; c0 += cpb) {
    const int c1 = min(c0 + cpb, nch);
    float bm = NEG_BIG;
#pragma unroll 8
    for (int c = c0; c < c1; ++c) bm = fmaxf(bm, cmh[(size_t)c * G]);
    if (bm <= NEG_BIG) continue;                // no live key: bit-exact skip
    const float mn = fmaxf(m, floorf(bm));
    const float r = carry_scale(m, mn);
    m = mn;
    float st = 0.0f;
    int ip = 0;
    // every load issued, dead chunks' partials (never written) then dropped
#pragma unroll 8
    for (int c = c0; c < c1; ++c) {
      const bool live = cmh[(size_t)c * G] > NEG_BIG;
      const float spc = sph[(size_t)c * G];
      const int pvc = pvh[(size_t)c * G * D];
      if (live) {
        st = __fadd_rn(st, spc);
        ip += pvc;
      }
    }
    s = __fadd_rn(__fmul_rn(s, r), st);
    acc = __fadd_rn(__fmul_rn(acc, r), __int2float_rn(ip));
  }
  const float f =
      __fmul_rn(__fdiv_rn(two_over_qmax, fmaxf(s, 1e-30f)), vs[h]);
  out[((size_t)h * G + g) * D + d] = __fmul_rn(acc, f);
}

template <int MODE, int NP>
cudaError_t launch_mode(const void* q, const void* k, const void* v,
                        const void* sc, const void* vs, void* out,
                        void* codes, void* sums, int H, int SQ, int SK, int D,
                        int bq, int bk, int sq_mod, int causal, int window,
                        int bm, int kt, float qmax, float two_over_qmax,
                        size_t smem, cudaStream_t stream) {
  static size_t done[16];
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(attention_kernel<MODE, NP>), smem, done);
  if (err != cudaSuccess) return err;
  const int nq = (SQ + bq - 1) / bq;
  attention_kernel<MODE, NP><<<dim3((SQ + bm - 1) / bm, H), NTA, smem,
                               stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(sc),
      static_cast<const float*>(vs), static_cast<float*>(out),
      static_cast<uint8_t*>(codes), static_cast<float*>(sums), SQ, SK, D, bq,
      bk, nq, sq_mod, causal, window, bm, kt, qmax, two_over_qmax);
  return cudaGetLastError();
}

// What the prefill kernels take (also stated in kernels/int_attention.py,
// attention_plan): D % 16 == 0 (16-byte rows; the wrapper pads), a tile of
// bm in {16, 32, 64} rows, key sub-tiles kt % 32 == 0, at most MAXNP
// column pairs a warp, and the layout within the card's 227 KB.
int pairs_per_warp(int D, int bm) {
  const int cwn = (NTA / 32) / (bm / 16);
  return (round_up(D, 32) / 16 + cwn - 1) / cwn;
}

template <int MODE>
cudaError_t launch_attention(const void* q, const void* k, const void* v,
                             const void* sc, const void* vs, void* out,
                             void* codes, void* sums, int H, int SQ, int SK,
                             int D, int bq, int bk, int sq_mod, int causal,
                             int window, int bm, int kt, float qmax,
                             float two_over_qmax, cudaStream_t stream) {
  const size_t smem = AttnLayout(bm, kt, bk, D).total;
  const int ppw = pairs_per_warp(D, bm);
  if (D % 16 || D <= 0 || bk <= 0 || kt <= 0 || kt % 32 ||
      (bm != 16 && bm != 32 && bm != 64) || ppw > MAXNP || smem > 232448)
    return cudaErrorInvalidValue;
#define LAUNCH_NP(NP_)                                                     \
  return launch_mode<MODE, NP_>(q, k, v, sc, vs, out, codes, sums, H, SQ, \
                                SK, D, bq, bk, sq_mod, causal, window, bm, \
                                kt, qmax, two_over_qmax, smem, stream)
  if (ppw <= 2) LAUNCH_NP(2);
  if (ppw <= 4) LAUNCH_NP(4);
  LAUNCH_NP(8);
#undef LAUNCH_NP
}

}  // namespace

// q (H, SQ, D) int8 with GQA groups stacked along SQ (row r at position
// r % sq_mod); k, v (H, SK, D) int8, 16-byte aligned; sc (H, nq) f32 per
// (head-fold, query block of bq rows); vs (H,) f32; out (H, SQ, D) f32;
// codes (H, SQ, SK) uint8 or null.  window < 0 means none.  bm, kt: the
// kernel's row tile and key sub-tile (attention_plan).
extern "C" int fused_attention_launch(const void* q, const void* k,
                                      const void* v, const void* sc,
                                      const void* vs, void* out, void* codes,
                                      int H, int SQ, int SK, int D, int bq,
                                      int bk, int sq_mod, int causal,
                                      int window, int bm, int kt, float qmax,
                                      float two_over_qmax, void* stream) {
  return static_cast<int>(launch_attention<FUSED>(
      q, k, v, sc, vs, out, codes, nullptr, H, SQ, SK, D, bq, bk, sq_mod,
      causal, window, bm, kt, qmax, two_over_qmax,
      static_cast<cudaStream_t>(stream)));
}

// The two-pass kernel: same operands as fused_attention_launch, plus sums
// (H, SQ) f32 scratch, written by the Sigma pass and read by the PV pass
// on the same stream.
extern "C" int two_pass_attention_launch(const void* q, const void* k,
                                         const void* v, const void* sc,
                                         const void* vs, void* out,
                                         void* codes, void* sums, int H,
                                         int SQ, int SK, int D, int bq,
                                         int bk, int sq_mod, int causal,
                                         int window, int bm, int kt,
                                         float qmax, float two_over_qmax,
                                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_attention<STATS>(
      q, k, v, sc, vs, out, nullptr, sums, H, SQ, SK, D, bq, bk, sq_mod,
      causal, window, bm, kt, qmax, two_over_qmax, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_attention<PV>(
      q, k, v, sc, vs, out, codes, sums, H, SQ, SK, D, bq, bk, sq_mod,
      causal, window, bm, kt, qmax, two_over_qmax, st));
}

namespace {

size_t paged_smem(int G, int ps, int D) {
  const int DW = (D + 3) / 4, QS = DW + 1, PS = (ps + 3) / 4 + 1;
  const size_t accs = G * D > NTP * MAXJP ? (size_t)G * D : 0;
  return 4 * ((size_t)G * QS + (size_t)ps * QS + (size_t)4 * DW * PS +
              (size_t)G * ps + (size_t)G * PS + 3 * (size_t)G + accs);
}

template <bool SMEM_ACC>
cudaError_t launch_paged(const void* q, const void* kpool, const void* vpool,
                         const void* sc, const void* vs, const void* kps,
                         const void* vps, const void* page_table,
                         const void* pos, void* out, void* codes, int B,
                         int HKV, int G, int D, int ps, int maxp,
                         int num_phys, int window, int packed, float qmax,
                         float two_over_qmax, cudaStream_t stream) {
  const size_t smem = paged_smem(G, ps, D);
  static size_t done[16];
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(paged_decode_kernel<SMEM_ACC>), smem, done);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<SMEM_ACC><<<dim3(HKV, B), NTP, smem, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const uint8_t*>(kpool),
      static_cast<const uint8_t*>(vpool), static_cast<const float*>(sc),
      static_cast<const float*>(vs), static_cast<const float*>(kps),
      static_cast<const float*>(vps), static_cast<const int*>(page_table),
      static_cast<const int*>(pos), static_cast<float*>(out),
      static_cast<uint8_t*>(codes), HKV, G, D, ps, maxp, num_phys, window,
      packed, qmax, two_over_qmax);
  return cudaGetLastError();
}

}  // namespace

// q (B, HKV, G, D) int8; pools (num_phys, HKV, ps, D) int8 or
// (..., D/2) uint8 nibbles (packed); sc, vs (B,) f32; kps, vps
// (num_phys,) f32 per physical page, or both null; page_table
// (B, maxp) int32 (negative = unallocated); pos (B,) int32 (negative =
// inactive row -> zero output); out (B, HKV, G, D) f32; codes
// (B, HKV, G, maxp * ps) uint8 or null.  Takes any D and page size whose
// paged_smem is within 227 KB (also stated in kernels/int_attention.py).
extern "C" int paged_decode_launch(const void* q, const void* kpool,
                                   const void* vpool, const void* sc,
                                   const void* vs, const void* kps,
                                   const void* vps, const void* page_table,
                                   const void* pos, void* out, void* codes,
                                   int B, int HKV, int G, int D, int ps,
                                   int maxp, int num_phys, int window,
                                   int packed, float qmax,
                                   float two_over_qmax, void* stream) {
  if (paged_smem(G, ps, D) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G * D > NTP * MAXJP)
    return static_cast<int>(launch_paged<true>(
        q, kpool, vpool, sc, vs, kps, vps, page_table, pos, out, codes, B,
        HKV, G, D, ps, maxp, num_phys, window, packed, qmax, two_over_qmax,
        st));
  return static_cast<int>(launch_paged<false>(
      q, kpool, vpool, sc, vs, kps, vps, page_table, pos, out, codes, B, HKV,
      G, D, ps, maxp, num_phys, window, packed, qmax, two_over_qmax, st));
}

// q (H, G, D) int8; k, v (H, span, D) int8 or (H, span, D/2) uint8
// nibbles (packed); kpos (span,) int32 slot -> position (negative =
// unwritten); pos (1,) int32 on the device; sc, vs (H,) f32; out
// (H, G, D) f32; codes (H, G, span) uint8 (zero-filled by the caller) or
// null.  Scratch from the caller: xs (H, G, span) f32, cm and sp
// (H, nch, G) f32, pvp (H, nch, G, D) int32, nch = ceil(span / chunk).
// window < 0 means none.  chunk (a multiple of 32, at most 256, dividing
// bk) and ds (a multiple of 16) come from kernels/int_attention.py
// (ring_plan), which also checks the shared memory.
extern "C" int ring_decode_launch(const void* q, const void* k, const void* v,
                                  const void* kpos, const void* pos,
                                  const void* sc, const void* vs, void* out,
                                  void* codes, void* xs, void* cm, void* sp,
                                  void* pvp, int H, int G, int D, int span,
                                  int bk, int chunk, int ds, int causal,
                                  int window, int packed, float qmax,
                                  float two_over_qmax, void* stream) {
  const size_t s1 = ring_logits_smem(G, chunk, ds);
  const size_t s2 = ring_pv_smem(G, chunk, ds);
  if (chunk % 32 || chunk > 256 || bk % chunk || ds % 16 || ds <= 0 ||
      (packed && D % 2) || s1 > 232448 || s2 > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  static size_t done1[16], done2[16];
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(ring_logits_kernel), s1, done1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(reinterpret_cast<const void*>(ring_pv_kernel), s2, done2);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nch = (span + chunk - 1) / chunk;
  ring_logits_kernel<<<dim3(nch, H), chunk, s1, st>>>(
      static_cast<const int8_t*>(q), static_cast<const uint8_t*>(k),
      static_cast<const int*>(kpos), static_cast<const int*>(pos),
      static_cast<const float*>(sc), static_cast<float*>(xs),
      static_cast<float*>(cm), G, D, span, ds, causal, window, packed);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ring_pv_kernel<<<dim3(nch, H), chunk, s2, st>>>(
      static_cast<const uint8_t*>(v), static_cast<const float*>(xs),
      static_cast<const float*>(cm), static_cast<uint8_t*>(codes),
      static_cast<float*>(sp), static_cast<int*>(pvp), G, D, span, bk, ds,
      packed, qmax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ring_merge_kernel<<<dim3((G * D + NTM - 1) / NTM, H), NTM, 0, st>>>(
      static_cast<const float*>(cm), static_cast<const float*>(sp),
      static_cast<const int*>(pvp), static_cast<const float*>(vs),
      static_cast<float*>(out), G, D, nch, bk / chunk, two_over_qmax);
  return static_cast<int>(cudaGetLastError());
}
