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
// The paged decode kernels replace
//   src/repro/kernels/int_attention.py::int_paged_decode_attention
//   (_paged_decode_kernel, _paged_meta): every engine decode step.  A
//   sequence's page table is cut into chunks of P whole pages, P from
//   kernels/int_attention.py::paged_plan (G, D, the page size and the
//   packing only: never the batch, the table's width or another row), one
//   block of 256 threads per (chunk, kv head h, sequence b).  A block reads
//   pos and its page ids on the device (the TPU's scalar prefetch); a page
//   none of whose keys is live (unallocated, past pos, before the window)
//   is never read, a chunk without a live page marks itself dead, and the
//   steps after the logits walk a list of the chunk's live pages.  A
//   block puts the cp.async copies of all its live pages in flight at once,
//   a warp a page (16-byte pieces into rows skewed by 16 bytes; byte loads
//   where the rows are not 16-byte aligned).  QK^T takes one key on 1 to 32
//   lanes, the key's words in registers (int4 nibbles unpacked there)
//   against q words broadcast from shared memory, by dp4a; page maxima and
//   each page's Sigma are trees over a page's lanes; PV takes a column quad
//   and a group of pages a thread, the values of four keys transposed into
//   a word a column by byte permutes, against the code words by dp4a.
//   A row's pages are split across blocks and the codes stay exact: the
//   running max at page t is the floor of a maximum over page maxima,
//   which is the same in any order.
//   1. paged_chunk_kernel<PG_LOGITS>: a chunk's logits to scratch and, per
//      query row, the chunk maximum (NEG_BIG when the chunk is dead).
//   2. paged_chunk_kernel<PG_PV>: m_t from the earlier chunks' maxima and
//      this chunk's page maxima up to page t; the codes; each page's Sigma
//      and int32 PV, scaled by the exact 2^(m_t - m_c) to the chunk's last
//      m (m_c) and added in page order; the chunk's Sigma and PV to
//      scratch.
//   3. paged_merge_kernel: per (row, column), the live chunks in order,
//      folded by the exact power-of-two rescale (merge_chunk).
//   When the whole table is one chunk (maxp <= P), one launch of
//   paged_chunk_kernel<PG_SHORT> does all three in a block: it folds its
//   only chunk into the empty state with merge_chunk, so it gives the bits
//   of the split path.  Codes, m and the int32 page PVs are exact; Sigma
//   and PV are f32 sums in another association than the plain version's.
//   No atomics.  Shared memory holds one chunk (PagedLayout, whose fit the
//   launcher checks).  Bound: the live KV bytes.
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
//   Where the ring is split by slot range over the model ranks of a
//   partitioned program (each rank a whole number of chunks), the three
//   passes run as stages with exchanges between them (the
//   ring_stage_*_launch functions): a rank's chunk maxima are all-gathered
//   after pass 1 (a maximum is exact in any order); pass 2 runs on the
//   rank's chunks against the whole ring's maxima and ring_block_pv_kernel
//   sums its live chunks' int32 PV per block; the Sigma partials are
//   all-gathered and the per-block PV all-reduced (exact); pass 3 merges
//   every chunk on every rank.  Each value is the one the one-launch path
//   computes, so the output is its output bit for bit.
//   Sigma's association (chunk sums, then the chunks in order) is the
//   plain version's; within a chunk the sum runs in another order, so
//   Sigma agrees within a tolerance; codes and the int32 partials are
//   exact.  No atomics.  Shared memory holds
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
constexpr int NTG = 256;     // paged decode chunk block: 8 warps
constexpr int NTPM = 128;    // paged merge block
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

// ---------------------------------------------------------------------------
// Paged decode
// ---------------------------------------------------------------------------

enum { PG_SHORT = 0, PG_LOGITS = 1, PG_PV = 2 };

// Shared-memory layout of paged_chunk_kernel<MODE> for chunks of P pages of
// ps keys, G query rows and head dim D (dk bytes a stored row).  Staged K
// and V rows keep a stride of a 16-byte multiple plus 16, so lanes on
// neighbouring keys read different banks; each buffer ends in 64 spare
// bytes that a key's last 64-value segment may run into (the q words there
// are zero, so whatever lies there adds nothing).  The PV partial sums of
// the page groups (pg x G x 4nq f32) share the K rows' space, which the PV
// phase no longer reads.  This is the kernel's fit: the launcher refuses a
// layout over the card's 227 KB.
struct PagedLayout {
  int gp, nk, rs, qw, pw, nq, pg, kpl;
  size_t k, v, q, x, pc, rows, pages, total;
  __host__ __device__ PagedLayout(int mode, int G, int P, int ps, int D,
                                  int packed, int mg) {
    const int dk = packed ? D / 2 : D;
    gp = round_up(G, mg);                  // q and code rows, zero-padded
    nk = P * ps;                           // keys of a chunk
    rs = round_up(dk, 16) + 16;            // staged row stride, bytes
    qw = round_up((D + 3) / 4, 16);        // q words a row, zero-padded
    pw = (ps + 3) / 4;                     // code words a page
    nq = (D + 3) / 4;                      // column quads of a row
    pg = 1;                                // PV page groups (a power of 2)
    while (2 * pg * nq <= NTG && 2 * pg <= P) pg *= 2;
    kpl = 1;                               // lanes a (row, page) reduction
    while (kpl < ps && kpl < 4) kpl *= 2;
    const size_t kv = (size_t)nk * rs + 64;
    const size_t red = mode == PG_LOGITS ? 0 : 16 * (size_t)pg * G * nq;
    k = 0;                                 // K rows, then the PV partials
    v = k + (mode == PG_PV ? red : (kv > red ? kv : red));
    q = v + (mode == PG_LOGITS ? 0 : kv);  // V rows (PV passes)
    x = q + (mode == PG_PV ? 0 : 4 * (size_t)gp * qw);
    pc = x + 4 * (size_t)G * nk;           // G x nk f32 logits
    rows = pc + 4 * (size_t)gp * P * pw;   // gp x P x pw code words
    pages = rows + 16 * (size_t)G * P;     // G x P: max, m, rescale, Sigma
    // per page: id, scales, live list; per row: m before, Sigma; count
    total = pages + 16 * (size_t)P + 8 * (size_t)G + 16;
  }
};

// What every paged decode launch reads and writes (paged_decode_launch).
struct PagedArgs {
  const int8_t* q;
  const uint8_t* kpool;
  const uint8_t* vpool;
  const float *sc, *vs, *kps, *vps;
  const int *page_table, *pos;
  float* out;
  uint8_t* codes;
  float *xg, *cm, *sp, *pvp;                // split-path scratch
  int HKV, G, D, ps, P, maxp, num_phys, window, packed;
  float qmax, two_over_qmax;
};

// Fold one chunk (its maximum, and its Sigma and PV relative to its own
// last m) into a row's running (m, Sigma, PV) by the exact power-of-two
// rescale.  The short path folds its only chunk into the empty state.
__device__ __forceinline__ void merge_chunk(float& m, float& s, float& acc,
                                            float cmax, float cs, float cpv) {
  const float mn = fmaxf(m, floorf(cmax));
  const float r = carry_scale(m, mn);
  m = mn;
  s = __fadd_rn(__fmul_rn(s, r), cs);
  acc = __fadd_rn(__fmul_rn(acc, r), cpv);
}

__device__ __forceinline__ float paged_out(float s, float acc,
                                           float two_over_qmax,
                                           bool page_scaled, float vsb) {
  float f = __fdiv_rn(two_over_qmax, fmaxf(s, 1e-30f));
  if (!page_scaled) f = __fmul_rn(f, vsb);
  return __fmul_rn(acc, f);
}

// Values 64s .. 64s+63 of a staged key row as 16 words of int8 codes
// (nibbles unpacked in registers, low nibble first).
__device__ __forceinline__ void key_segment(const uint8_t* row, int s,
                                            int packed, int (&kw)[16]) {
  if (packed) {
    const uint4* p = reinterpret_cast<const uint4*>(row + 32 * s);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint4 u = p[i];
      const unsigned w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kw[8 * i + 2 * j] = unpack4(w4[j] & 0xFFFFu);
        kw[8 * i + 2 * j + 1] = unpack4(w4[j] >> 16);
      }
    }
  } else {
    const int4* p = reinterpret_cast<const int4*>(row + 64 * s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int4 u = p[i];
      kw[4 * i] = u.x;
      kw[4 * i + 1] = u.y;
      kw[4 * i + 2] = u.z;
      kw[4 * i + 3] = u.w;
    }
  }
}

// Copy the ps rows (dk bytes each) of kv head h of every live page of the
// chunk (pphys[t] >= 0) into dst at stride rs, a warp a page: a page is
// ps * dk contiguous bytes of the pool, moved as cp.async 16-byte pieces
// (committed as one group), or by byte loads where the pool's rows are not
// 16-byte aligned.
__device__ __forceinline__ void stage_pages(uint8_t* dst,
                                            const uint8_t* __restrict__ pool,
                                            const int* pphys, int P, int ps,
                                            int dk, int rs, int HKV, int h,
                                            int warp, int lane) {
  const bool vec = reinterpret_cast<size_t>(pool) % 16 == 0 && dk % 16 == 0;
  const int unit = vec ? 16 : 1, nv = dk / unit;   // pieces a row
  const int sh = __ffs(nv) - 1;                    // nv = 2^sh, or -1
  const bool pow2 = (nv & (nv - 1)) == 0;
  for (int t = warp; t < P; t += NTG / 32) {
    const int phys = pphys[t];
    if (phys < 0) continue;
    const uint8_t* src = pool + ((size_t)phys * HKV + h) * ps * dk;
    uint8_t* d = dst + (size_t)t * ps * rs;
    for (int i = lane; i < ps * nv; i += 32) {
      const int row = pow2 ? i >> sh : i / nv;
      const int j = i - row * nv;
      if (vec)
        cp_async16(d + row * rs + 16 * j, src + 16 * (size_t)i);
      else
        d[row * rs + j] = src[i];
    }
  }
  cp_commit();
}

// Four int8 codes of columns 4cq .. 4cq+3 of a staged value row.
__device__ __forceinline__ unsigned value_quad(const uint8_t* row, int cq,
                                               int packed) {
  return packed ? static_cast<unsigned>(unpack4(
                      *reinterpret_cast<const unsigned short*>(row + 2 * cq)))
                : *reinterpret_cast<const unsigned*>(row + 4 * cq);
}

// One chunk of P pages of sequence b, kv head h, against its G query rows.
// MODE PG_SHORT: the whole table is this chunk; logits, codes, PV and the
// output in one block.  PG_LOGITS: pass 1 (logits and chunk maxima to
// scratch).  PG_PV: pass 2 (codes, and Sigma and PV partials to scratch).
// MG: query rows a thread carries at once (G is walked in tiles of MG).
template <int MODE, int MG>
__global__ void __launch_bounds__(NTG) paged_chunk_kernel(const PagedArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int G = a.G, D = a.D, ps = a.ps, P = a.P, packed = a.packed;
  const PagedLayout L(MODE, G, P, ps, D, packed, MG);
  const int ci = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nch = gridDim.x, tid = threadIdx.x, nk = L.nk;
  const int warp = tid / 32, lane = tid % 32;
  uint8_t* const kb = smem + L.k;
  float* const red = reinterpret_cast<float*>(smem + L.k);
  uint8_t* const vb = smem + L.v;
  int* const qs = reinterpret_cast<int*>(smem + L.q);
  float* const xs = reinterpret_cast<float*>(smem + L.x);
  int* const pc = reinterpret_cast<int*>(smem + L.pc);
  float* const pm = reinterpret_cast<float*>(smem + L.rows);  // page max
  float* const mt = pm + G * P;            // m at page t
  float* const st = mt + G * P;            // 2^(m_t - the chunk's last m)
  float* const pz = st + G * P;            // page Sigma
  int* const pphys = reinterpret_cast<int*>(smem + L.pages);
  float* const pxs = reinterpret_cast<float*>(pphys + P);    // logit scale
  float* const pvf = pxs + P;              // page's PV factor
  int* const lt = reinterpret_cast<int*>(pvf + P);  // live pages, in order
  float* const mprev = reinterpret_cast<float*>(lt + P);  // m before, per row
  float* const srow = mprev + G;           // chunk Sigma, per row
  int* const nlive = reinterpret_cast<int*>(srow + G);

  const size_t bh = (size_t)b * a.HKV + h;
  const size_t span = (size_t)a.maxp * ps;  // a row's keys (codes, xg)
  const size_t key0 = (size_t)ci * nk;      // the chunk's first position
  const bool page_scaled = a.kps != nullptr;
  // pos and the page ids are read together (neither address depends on
  // the other), the page scales only once the copies are in flight.
  const int pb = a.pos[b];
  const int wlo = a.window >= 0 ? max(pb - a.window + 1, 0) : 0;
  const float scb = a.sc[b], vsb = a.vs[b];
  bool any = false;
  for (int t = tid; t < P; t += NTG) {
    const int logical = ci * P + t, first = logical * ps;
    const int raw =
        logical < a.maxp ? a.page_table[(size_t)b * a.maxp + logical] : -1;
    const bool live = pb >= 0 && raw >= 0 &&
                      max(first, wlo) <= min(first + ps - 1, pb);
    pphys[t] = live ? min(raw, a.num_phys - 1) : -1;
    any |= live;
  }
  if (!__syncthreads_or(any)) {            // dead chunk: nothing is read
    if (MODE == PG_LOGITS)
      for (int g = tid; g < G; g += NTG)
        a.cm[(bh * nch + ci) * G + g] = NEG_BIG;
    if (MODE == PG_SHORT)                  // the merge of no live chunk
      for (int o = tid; o < G * D; o += NTG)
        a.out[bh * G * D + o] =
            paged_out(0.0f, 0.0f, a.two_over_qmax, page_scaled, vsb);
    return;
  }

  if (MODE != PG_LOGITS && warp == 0) {   // the live pages, in order
    int n = 0;
    for (int t0 = 0; t0 < P; t0 += 32) {
      const bool live = t0 + lane < P && pphys[t0 + lane] >= 0;
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (live) lt[n + __popc(m & ((1u << lane) - 1))] = t0 + lane;
      n += __popc(m);
    }
    if (lane == 0) *nlive = n;
  }

  // Every load of the block in flight at once: the logits pass 1 wrote
  // (a group of its own, first, so it can be waited for alone), the K and
  // V rows, q, and the earlier chunks' maxima.
  const int dk = packed ? D / 2 : D;
  if (MODE == PG_PV) {
    const bool vec = ps % 4 == 0 && reinterpret_cast<size_t>(a.xg) % 16 == 0;
    const int nv = vec ? ps / 4 : ps;      // pieces a (row, page)
    for (int idx = tid; idx < G * P * nv; idx += NTG) {
      const int pair = idx / nv, j = idx - pair * nv;
      const int g = pair / P, t = pair - g * P;
      if (pphys[t] < 0) continue;
      float* d = xs + (size_t)g * nk + (size_t)t * ps;
      const float* src = a.xg + (bh * G + g) * span + key0 + (size_t)t * ps;
      if (vec)
        cp_async16(d + 4 * j, src + 4 * j);
      else
        d[j] = src[j];
    }
    cp_commit();
  }
  if (MODE != PG_PV)
    stage_pages(kb, a.kpool, pphys, P, ps, dk, L.rs, a.HKV, h, warp, lane);
  if (MODE != PG_LOGITS)
    stage_pages(vb, a.vpool, pphys, P, ps, dk, L.rs, a.HKV, h, warp, lane);
  if (MODE != PG_PV) {
    const uint8_t* qb = reinterpret_cast<const uint8_t*>(a.q) + bh * G * D;
    if (D % 16 == 0 && reinterpret_cast<size_t>(a.q) % 16 == 0) {
      const int nv = L.qw / 4;             // 16-byte pieces a q row
      for (int idx = tid; idx < L.gp * nv; idx += NTG) {
        const int g = idx / nv, j = idx % nv;
        reinterpret_cast<int4*>(qs)[idx] =
            g < G && 16 * j < D
                ? *reinterpret_cast<const int4*>(qb + (size_t)g * D + 16 * j)
                : make_int4(0, 0, 0, 0);
      }
    } else {
      for (int idx = tid; idx < L.gp * L.qw; idx += NTG) {
        const int g = idx / L.qw, d0 = 4 * (idx % L.qw);
        unsigned word = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (g < G && d0 + i < D)
            word |= static_cast<unsigned>(qb[(size_t)g * D + d0 + i])
                    << (8 * i);
        qs[idx] = static_cast<int>(word);
      }
    }
  }
  for (int t = tid; t < P; t += NTG) {
    const int phys = pphys[t];
    if (phys >= 0) {
      pxs[t] = page_scaled ? __fmul_rn(scb, a.kps[phys]) : scb;
      pvf[t] = page_scaled ? __fmul_rn(vsb, a.vps[phys]) : 1.0f;
    }
  }
  if (MODE != PG_LOGITS) {
    for (int g = warp; g < G; g += NTG / 32) {
      float m = NEG_BIG;
      if (MODE == PG_PV)
        for (int c = lane; c < ci; c += 32)
          m = fmaxf(m, a.cm[(bh * nch + c) * G + g]);
      m = warp_max(m);
      if (lane == 0) mprev[g] = floorf(m);
    }
    for (int i = tid; i < L.gp * P * L.pw; i += NTG) pc[i] = 0;  // tails
  }

  if (MODE != PG_PV) {
    // Logits: key kk on `lanes` lanes, each over 64-value segments of D.
    if (MODE == PG_SHORT) cp_wait<1>(); else cp_wait<0>();
    __syncthreads();
    const int nseg = ((D + 3) / 4 + 15) / 16;
    int lanes = 1;
    while (lanes < nseg && lanes < 32) lanes *= 2;
    const int part = tid % lanes;
    for (int k0 = 0; k0 < nk; k0 += NTG / lanes) {
      const int kk = k0 + tid / lanes;
      const int t = min(kk, nk - 1) / ps;
      const bool act = kk < nk && pphys[t] >= 0;
      const uint8_t* krow = kb + (size_t)min(kk, nk - 1) * L.rs;
      for (int g0 = 0; g0 < G; g0 += MG) {
        int acc[MG];
#pragma unroll
        for (int r = 0; r < MG; ++r) acc[r] = 0;
        if (act) {                         // rows past G: zero q words
          for (int s = part; s < nseg; s += lanes) {
            int kw[16];
            key_segment(krow, s, packed, kw);
            const int4* qv =
                reinterpret_cast<const int4*>(qs + g0 * L.qw + 16 * s);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
              for (int r = 0; r < MG; ++r) {
                const int4 u = qv[r * (L.qw / 4) + i];
                acc[r] = __dp4a(u.x, kw[4 * i], acc[r]);
                acc[r] = __dp4a(u.y, kw[4 * i + 1], acc[r]);
                acc[r] = __dp4a(u.z, kw[4 * i + 2], acc[r]);
                acc[r] = __dp4a(u.w, kw[4 * i + 3], acc[r]);
              }
            }
          }
        }
        for (int o = lanes / 2; o > 0; o /= 2) {
#pragma unroll
          for (int r = 0; r < MG; ++r)
            acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
        }
        if (act && part == 0) {
          const int kp = static_cast<int>(key0) + kk;
          const bool valid = kp <= pb && kp >= wlo;
#pragma unroll
          for (int r = 0; r < MG; ++r) {
            if (g0 + r >= G) break;
            const float x = fmaxf(
                valid ? __fmul_rn(__int2float_rn(acc[r]), pxs[t]) : NEG_BIG,
                -120.0f);
            xs[(g0 + r) * nk + kk] = x;
            if (MODE == PG_LOGITS)
              a.xg[(bh * G + g0 + r) * span + key0 + kk] = x;
          }
        }
      }
    }
  } else {
    cp_wait<1>();                          // the logits, not V
  }
  __syncthreads();

  // (row, page) pairs, kpl lanes a pair, a lane its keys in order: pass 1
  // over all P pages, the other passes over the live ones only.
  const int nl = MODE == PG_LOGITS ? P : *nlive;
  const int kpl = L.kpl, sub = lane / kpl, c0 = lane % kpl;
  const int pairs = (NTG / 32) * (32 / kpl);   // pairs a pass
  // Each page's maximum (NEG_BIG for a dead page).
  for (int base = warp * (32 / kpl); base < G * nl; base += pairs) {
    const int idx = base + sub, g = idx / max(nl, 1), i = idx - g * nl;
    const int t = idx >= G * nl ? 0 : MODE == PG_LOGITS ? i : lt[i];
    const bool live = idx < G * nl && pphys[t] >= 0;
    const float* xr = xs + g * nk + t * ps;
    float mx = -INFINITY;
    if (live)
      for (int c = c0; c < ps; c += kpl) mx = fmaxf(mx, xr[c]);
    for (int o = kpl / 2; o > 0; o /= 2)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (idx < G * nl && c0 == 0) pm[g * P + t] = live ? mx : NEG_BIG;
  }
  __syncthreads();

  if constexpr (MODE == PG_LOGITS) {
    for (int g = tid; g < G; g += NTG) {
      float mx = NEG_BIG;
      for (int t = 0; t < P; ++t) mx = fmaxf(mx, pm[g * P + t]);
      a.cm[(bh * nch + ci) * G + g] = mx;
    }
  } else {
    // m_t: the floor of the maximum over the earlier chunks and this
    // chunk's pages up to t; each page's carries are rescaled exactly to
    // the chunk's last m (m_c) before they are added.
    for (int idx = tid; idx < G * nl; idx += NTG) {
      const int g = idx / nl, i = idx - g * nl;
      float m = mprev[g], mc = m;
      for (int i2 = 0; i2 < nl; ++i2) {
        const float f = floorf(pm[g * P + lt[i2]]);
        if (i2 <= i) m = fmaxf(m, f);
        mc = fmaxf(mc, f);
      }
      mt[g * P + lt[i]] = m;
      st[g * P + lt[i]] = carry_scale(m, mc);
    }
    __syncthreads();

    // Codes on the running grid and each page's Sigma (a tree over kpl
    // lanes, the page's keys in lane order first).
    const float qmax = a.qmax, qmax_half = qmax * 0.5f;
    uint8_t* const pcb = reinterpret_cast<uint8_t*>(pc);
    for (int base = warp * (32 / kpl); base < G * nl; base += pairs) {
      const int pair = base + sub, g = pair / max(nl, 1);
      const bool live = pair < G * nl;
      const int t = live ? lt[pair - g * nl] : 0, idx = g * P + t;
      float z = 0.0f;
      if (live) {
        const float m = mt[idx];
        for (int c = c0; c < ps; c += kpl) {
          const float x = xs[g * nk + t * ps + c];
          const float e = x <= -120.0f ? 0.0f : exp2_shift(__fsub_rn(x, m));
          const float p =
              fminf(fmaxf(rintf(__fmul_rn(e, qmax_half)), 0.0f), qmax);
          z = __fadd_rn(z, e);
          pcb[(size_t)idx * L.pw * 4 + c] = static_cast<uint8_t>(p);
          if (a.codes)
            a.codes[(bh * G + g) * span + key0 + t * ps + c] =
                static_cast<uint8_t>(p);
        }
      }
      for (int o = kpl / 2; o > 0; o /= 2)
        z = __fadd_rn(z, __shfl_xor_sync(0xffffffffu, z, o));
      if (live && c0 == 0) pz[idx] = z;
    }
    __syncthreads();

    for (int g = tid; g < G; g += NTG) {   // the chunk's Sigma, page order
      float s = 0.0f;
      for (int i = 0; i < nl; ++i)
        s = __fadd_rn(s, __fmul_rn(pz[g * P + lt[i]], st[g * P + lt[i]]));
      srow[g] = s;
      if (MODE == PG_PV) a.sp[(bh * nch + ci) * G + g] = s;
    }
    cp_wait<0>();                          // V
    __syncthreads();

    // PV: thread (column quad cq, page group pgi) over the group's pages,
    // the values of four keys transposed into a word a column by byte
    // permutes; each page's int32 sums, scaled and rescaled, added in page
    // order into the group's partials (red).
    const int nq = L.nq, ppg = (nl + L.pg - 1) / L.pg;
    float4* const red4 = reinterpret_cast<float4*>(red);
    for (int item = tid; item < nq * L.pg; item += NTG) {
      const int cq = item % nq, pgi = item / nq;
      const int i0 = pgi * ppg, i1 = min(i0 + ppg, nl);
      for (int g0 = 0; g0 < G; g0 += 8) {
        bool started = false;
        for (int i = i0; i < i1; ++i) {
          const int t = lt[i];
          const uint8_t* vrow = vb + (size_t)t * ps * L.rs;
          int pv[8][4];
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int j = 0; j < 4; ++j) pv[r][j] = 0;
          for (int kg = 0; kg < L.pw; ++kg) {
            unsigned w[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int c = 4 * kg + i;
              w[i] = c < ps ? value_quad(vrow + (size_t)c * L.rs, cq, packed)
                            : 0u;
            }
            const unsigned t01 = __byte_perm(w[0], w[1], 0x5140);
            const unsigned t23 = __byte_perm(w[2], w[3], 0x5140);
            const unsigned u01 = __byte_perm(w[0], w[1], 0x7362);
            const unsigned u23 = __byte_perm(w[2], w[3], 0x7362);
            const int col[4] = {
                static_cast<int>(__byte_perm(t01, t23, 0x5410)),
                static_cast<int>(__byte_perm(t01, t23, 0x7632)),
                static_cast<int>(__byte_perm(u01, u23, 0x5410)),
                static_cast<int>(__byte_perm(u01, u23, 0x7632))};
#pragma unroll
            for (int r = 0; r < 8; ++r) {      // rows past G: zero codes
              const unsigned cw = static_cast<unsigned>(
                  pc[((g0 + r) * P + t) * L.pw + kg]);
#pragma unroll
              for (int j = 0; j < 4; ++j)
                pv[r][j] = dp4a_us(cw, col[j], pv[r][j]);
            }
          }
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const int g = g0 + r;
            if (g >= G) break;
            const float sg = st[g * P + t];
            float f[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float v = __int2float_rn(pv[r][j]);
              if (page_scaled) v = __fmul_rn(v, pvf[t]);
              f[j] = __fmul_rn(v, sg);
            }
            float4& dst = red4[((size_t)pgi * G + g) * nq + cq];
            dst = started ? make_float4(__fadd_rn(dst.x, f[0]),
                                        __fadd_rn(dst.y, f[1]),
                                        __fadd_rn(dst.z, f[2]),
                                        __fadd_rn(dst.w, f[3]))
                          : make_float4(f[0], f[1], f[2], f[3]);
          }
          started = true;
        }
        if (!started)
          for (int g = g0; g < min(g0 + 8, G); ++g)
            red4[((size_t)pgi * G + g) * nq + cq] = make_float4(0, 0, 0, 0);
      }
    }
    __syncthreads();

    // The chunk's PV: the page groups in order.
    for (int o = tid; o < G * D; o += NTG) {
      const int g = o / D, d = o % D;
      float acc = red[(size_t)g * 4 * nq + d];
      for (int pgi = 1; pgi < L.pg; ++pgi)
        acc = __fadd_rn(acc, red[((size_t)pgi * G + g) * 4 * nq + d]);
      if (MODE == PG_PV) {
        a.pvp[(bh * nch + ci) * G * D + o] = acc;
      } else {
        float m = NEG_BIG, s = 0.0f, out = 0.0f;
        merge_chunk(m, s, out, mt[g * P + P - 1], srow[g], acc);
        a.out[bh * G * D + o] =
            paged_out(s, out, a.two_over_qmax, page_scaled, vsb);
      }
    }
  }
}

// Pass 3: one thread per (row g, column d) of (sequence b, kv head h)
// folds the live chunks in order: the chunk maxima first, 16 at a time,
// then the partials of the live ones (a dead chunk's were never written).
__global__ void __launch_bounds__(NTPM) paged_merge_kernel(const PagedArgs a) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int o = blockIdx.x * NTPM + threadIdx.x, G = a.G, D = a.D;
  if (o >= G * D) return;
  const int nch = (a.maxp + a.P - 1) / a.P;
  const size_t bh = (size_t)b * a.HKV + h;
  const float* cmh = a.cm + bh * nch * G + o / D;
  const float* sph = a.sp + bh * nch * G + o / D;
  const float* pvh = a.pvp + bh * nch * G * D + o;
  float m = NEG_BIG, s = 0.0f, acc = 0.0f;
  for (int c0 = 0; c0 < nch; c0 += 16) {
    float cv[16], sv[16], pv[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      cv[i] = c0 + i < nch ? cmh[(size_t)(c0 + i) * G] : NEG_BIG;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const size_t c = c0 + i;
      sv[i] = cv[i] > NEG_BIG ? sph[c * G] : 0.0f;
      pv[i] = cv[i] > NEG_BIG ? pvh[c * G * D] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (cv[i] > NEG_BIG) merge_chunk(m, s, acc, cv[i], sv[i], pv[i]);
  }
  a.out[bh * G * D + o] =
      paged_out(s, acc, a.two_over_qmax, a.kps != nullptr, a.vs[b]);
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
// block's running m_t.  The launch covers chunks c0 .. c0 + gridDim.x - 1
// of a ring of nch_all chunks (a rank's slot range; c0 = 0 and nch_all =
// gridDim.x for the whole ring): cm holds the maxima of every chunk of
// the ring, xs, v, codes, sp and pvp the launch's own.
__global__ void __launch_bounds__(256)
ring_pv_kernel(const uint8_t* __restrict__ v, const float* __restrict__ xs,
               const float* __restrict__ cm, uint8_t* __restrict__ codes,
               float* __restrict__ sp, int* __restrict__ pvp, int G, int D,
               int span, int bk, int ds, int packed, float qmax, int c0,
               int nch_all) {
  extern __shared__ __align__(16) uint8_t smem[];
  int* const words = reinterpret_cast<int*>(smem);
  const int C = blockDim.x, tid = threadIdx.x, ci = blockIdx.x;
  const int h = blockIdx.y, nch = gridDim.x, k0 = ci * C;
  const int warp = tid / 32, lane = tid % 32, nwarps = C / 32;
  const float* cmh = cm + (size_t)h * nch_all * G;
  if (cmh[(size_t)(c0 + ci) * G] <= NEG_BIG) return;   // dead chunk
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
  const int cend = min(((c0 + ci) * C / bk + 1) * (bk / C), nch_all);
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

// Pass 2 of a ring split by slot range over ranks (ring_stage_pv_launch):
// the launch's int32 PV of each bk block, summed over its live chunks c0 ..
// c0 + nloc - 1 (exact; 0 for a block it holds no live chunk of), which
// the ranks then sum.
__global__ void __launch_bounds__(NTM)
ring_block_pv_kernel(const float* __restrict__ cm, const int* __restrict__ pvp,
                     int* __restrict__ pvb, int G, int D, int nloc, int c0,
                     int nch_all, int cpb) {
  const int h = blockIdx.y, o = blockIdx.x * NTM + threadIdx.x;
  if (o >= G * D) return;
  const int g = o / D, d = o % D, nblk = (nch_all + cpb - 1) / cpb;
  const float* cmh = cm + (size_t)h * nch_all * G + g;
  const int* pvh = pvp + (size_t)h * nloc * G * D + (size_t)g * D + d;
  int* pbh = pvb + (size_t)h * nblk * G * D + (size_t)g * D + d;
  for (int b = 0; b < nblk; ++b) {
    const int lo = max(b * cpb, c0), hi = min((b + 1) * cpb, c0 + nloc);
    int ip = 0;
    for (int c = lo; c < hi; ++c)
      if (cmh[(size_t)c * G] > NEG_BIG) ip += pvh[(size_t)(c - c0) * G * D];
    pbh[(size_t)b * G * D] = ip;
  }
}

// Pass 3: one thread per (row g, column d) of head-fold h merges the live
// chunks, block by block in slot order.  The block's int32 PV is the sum
// of its chunks' partials pvp, or with pvb (a ring split by slot range)
// the exchanged per-block sums.
__global__ void __launch_bounds__(NTM)
ring_merge_kernel(const float* __restrict__ cm, const float* __restrict__ sp,
                  const int* __restrict__ pvp, const int* __restrict__ pvb,
                  const float* __restrict__ vs, float* __restrict__ out,
                  int G, int D, int nch, int cpb, float two_over_qmax) {
  const int h = blockIdx.y, o = blockIdx.x * NTM + threadIdx.x;
  if (o >= G * D) return;
  const int g = o / D, d = o % D;
  const float* cmh = cm + (size_t)h * nch * G + g;
  const float* sph = sp + (size_t)h * nch * G + g;
  const int* pvh =
      pvp ? pvp + (size_t)h * nch * G * D + (size_t)g * D + d : nullptr;
  const int* pbh = pvb ? pvb + (size_t)h * ((nch + cpb - 1) / cpb) * G * D +
                             (size_t)g * D + d
                       : nullptr;
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
      const int pvc = pvb ? 0 : pvh[(size_t)c * G * D];
      if (live) {
        st = __fadd_rn(st, spc);
        ip += pvc;
      }
    }
    if (pvb) ip = pbh[(size_t)(c0 / cpb) * G * D];
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

template <int MODE, int MG>
cudaError_t launch_chunks(const PagedArgs& a, dim3 grid, cudaStream_t st) {
  const size_t smem =
      PagedLayout(MODE, a.G, a.P, a.ps, a.D, a.packed, MG).total;
  static size_t done[16];
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(paged_chunk_kernel<MODE, MG>), smem,
      done);
  if (err != cudaSuccess) return err;
  paged_chunk_kernel<MODE, MG><<<grid, NTG, smem, st>>>(a);
  return cudaGetLastError();
}

template <int MG>
cudaError_t launch_paged(const PagedArgs& a, int B, cudaStream_t st) {
  const int nch = (a.maxp + a.P - 1) / a.P;
  if (nch <= 1) return launch_chunks<PG_SHORT, MG>(a, dim3(1, a.HKV, B), st);
  const dim3 grid(nch, a.HKV, B);
  cudaError_t err = launch_chunks<PG_LOGITS, MG>(a, grid, st);
  if (err != cudaSuccess) return err;
  err = launch_chunks<PG_PV, MG>(a, grid, st);
  if (err != cudaSuccess) return err;
  paged_merge_kernel<<<dim3((a.G * a.D + NTPM - 1) / NTPM, a.HKV, B), NTPM,
                       0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q (B, HKV, G, D) int8; pools (num_phys, HKV, ps, D) int8 or
// (..., D/2) uint8 nibbles (packed); sc, vs (B,) f32; kps, vps
// (num_phys,) f32 per physical page, or both null; page_table
// (B, maxp) int32 (negative = unallocated); pos (B,) int32 on the device
// (negative = inactive row -> zero output); out (B, HKV, G, D) f32; codes
// (B, HKV, G, maxp * ps) uint8 (zero-filled by the caller) or null;
// window < 0 means none.  P: pages a chunk (paged_plan).  When maxp > P,
// scratch from the caller: xg (B, HKV, G, maxp * ps) f32, cm and sp
// (B, HKV, nch, G) f32, pvp (B, HKV, nch, G, D) f32, nch = ceil(maxp / P);
// null otherwise.
// Refuses (cudaErrorInvalidValue, before any launch) a chunk whose
// PagedLayout exceeds 227 KB.
extern "C" int paged_decode_launch(
    const void* q, const void* kpool, const void* vpool, const void* sc,
    const void* vs, const void* kps, const void* vps, const void* page_table,
    const void* pos, void* out, void* codes, void* xg, void* cm, void* sp,
    void* pvp, int B, int HKV, int G, int D, int ps, int P, int maxp,
    int num_phys, int window, int packed, float qmax, float two_over_qmax,
    void* stream) {
  const int nch = P > 0 ? (maxp + P - 1) / P : 0;
  const bool split = nch > 1;
  const int mg = G <= 8 ? 8 : 16;          // launch_paged's row tile
  auto fit = [&](int mode) {
    return PagedLayout(mode, G, P, ps, D, packed, mg).total <= 232448;
  };
  const bool fits = split ? fit(PG_LOGITS) && fit(PG_PV) : fit(PG_SHORT);
  if (B <= 0 || HKV <= 0 || G <= 0 || D <= 0 || ps <= 0 || P <= 0 ||
      maxp < 0 || num_phys <= 0 || B > 65535 || HKV > 65535 ||
      (packed && D % 2) || !fits || (split && !(xg && cm && sp && pvp)))
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedArgs a{
      static_cast<const int8_t*>(q), static_cast<const uint8_t*>(kpool),
      static_cast<const uint8_t*>(vpool), static_cast<const float*>(sc),
      static_cast<const float*>(vs), static_cast<const float*>(kps),
      static_cast<const float*>(vps), static_cast<const int*>(page_table),
      static_cast<const int*>(pos), static_cast<float*>(out),
      static_cast<uint8_t*>(codes), static_cast<float*>(xg),
      static_cast<float*>(cm), static_cast<float*>(sp),
      static_cast<float*>(pvp), HKV, G, D, ps, P, maxp, num_phys, window,
      packed, qmax, two_over_qmax};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(mg == 8 ? launch_paged<8>(a, B, st)
                                  : launch_paged<16>(a, B, st));
}

// The shared memory each ring kernel is allowed, per device: one record
// for every launcher of the kernel (allow_smem only raises it).
static size_t ring_logits_done[16], ring_pv_done[16];

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
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(ring_logits_kernel), s1, ring_logits_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(reinterpret_cast<const void*>(ring_pv_kernel), s2,
                   ring_pv_done);
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
      packed, qmax, 0, nch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ring_merge_kernel<<<dim3((G * D + NTM - 1) / NTM, H), NTM, 0, st>>>(
      static_cast<const float*>(cm), static_cast<const float*>(sp),
      static_cast<const int*>(pvp), nullptr, static_cast<const float*>(vs),
      static_cast<float*>(out), G, D, nch, bk / chunk, two_over_qmax);
  return static_cast<int>(cudaGetLastError());
}

// The same three passes as stages of a ring split by slot range over the
// model ranks (kernels/int_attention.py::int_decode_attention_staged),
// the caller exchanging between them.  A rank holds nloc = span / chunk
// whole chunks, c0 = its index * nloc of the ring's nch_all.
// Stage 1: q (H, G, D); k (H, span, dk) and kpos (span,) the rank's
// slots; xs (H, G, span) f32 and cm (H, nloc, G) f32 out (the rank's
// chunk maxima, which the ranks all-gather into (H, nch_all, G)).
extern "C" int ring_stage_logits_launch(const void* q, const void* k,
                                        const void* kpos, const void* pos,
                                        const void* sc, void* xs, void* cm,
                                        int H, int G, int D, int span,
                                        int chunk, int ds, int causal,
                                        int window, int packed, float qmax,
                                        float two_over_qmax, void* stream) {
  const size_t s1 = ring_logits_smem(G, chunk, ds);
  if (chunk % 32 || chunk > 256 || span % chunk || ds % 16 || ds <= 0 ||
      (packed && D % 2) || s1 > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(ring_logits_kernel), s1, ring_logits_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  ring_logits_kernel<<<dim3(span / chunk, H), chunk, s1,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const uint8_t*>(k),
      static_cast<const int*>(kpos), static_cast<const int*>(pos),
      static_cast<const float*>(sc), static_cast<float*>(xs),
      static_cast<float*>(cm), G, D, span, ds, causal, window, packed);
  return static_cast<int>(cudaGetLastError());
}

// Stage 2: v (H, span, dk) the rank's slots, xs from stage 1, cm the
// ring's (H, nch_all, G) maxima; out codes (H, G, span) (or null), sp
// (H, nloc, G) f32 (all-gathered next), pvb (H, nblk, G, D) int32 (the
// rank's per-block sums, all-reduced next); pvp (H, nloc, G, D) int32 is
// scratch.
extern "C" int ring_stage_pv_launch(const void* v, const void* xs,
                                    const void* cm, void* codes, void* sp,
                                    void* pvp, void* pvb, int H, int G,
                                    int D, int span, int bk, int chunk,
                                    int ds, int c0, int nch_all, int packed,
                                    float qmax, float two_over_qmax,
                                    void* stream) {
  const size_t s2 = ring_pv_smem(G, chunk, ds);
  if (chunk % 32 || chunk > 256 || bk % chunk || span % chunk || ds % 16 ||
      ds <= 0 || (packed && D % 2) || s2 > 232448 ||
      c0 + span / chunk > nch_all)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(ring_pv_kernel),
                               s2, ring_pv_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nloc = span / chunk;
  ring_pv_kernel<<<dim3(nloc, H), chunk, s2, st>>>(
      static_cast<const uint8_t*>(v), static_cast<const float*>(xs),
      static_cast<const float*>(cm), static_cast<uint8_t*>(codes),
      static_cast<float*>(sp), static_cast<int*>(pvp), G, D, span, bk, ds,
      packed, qmax, c0, nch_all);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ring_block_pv_kernel<<<dim3((G * D + NTM - 1) / NTM, H), NTM, 0, st>>>(
      static_cast<const float*>(cm), static_cast<const int*>(pvp),
      static_cast<int*>(pvb), G, D, nloc, c0, nch_all, bk / chunk);
  return static_cast<int>(cudaGetLastError());
}

// Stage 3, on every rank alike: cm and sp (H, nch_all, G) and pvb (H,
// nblk, G, D) after the exchanges; vs (H,); out (H, G, D) f32.
extern "C" int ring_stage_merge_launch(const void* cm, const void* sp,
                                       const void* pvb, const void* vs,
                                       void* out, int H, int G, int D,
                                       int nch_all, int bk, int chunk,
                                       float qmax, float two_over_qmax,
                                       void* stream) {
  if (chunk % 32 || chunk > 256 || bk % chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  ring_merge_kernel<<<dim3((G * D + NTM - 1) / NTM, H), NTM, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cm), static_cast<const float*>(sp), nullptr,
      static_cast<const int*>(pvb), static_cast<const float*>(vs),
      static_cast<float*>(out), G, D, nch_all, bk / chunk, two_over_qmax);
  return static_cast<int>(cudaGetLastError());
}
