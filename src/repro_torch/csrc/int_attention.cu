// Integer attention with the embedded base-2 softmax, for Hopper (sm_90a).
//
// Four kernels share one online quantizer (kernels/ref.py):
//   x = acc * sc (masked -> -1e30, clamped at -120); running integer
//   m = floor(max); e = (1 + r) * 2^(x - m); codes p = clip(rint(e*qmax/2),
//   0, qmax); int32 PV; the f32 carries (Sigma, PV) rescaled by the exact
//   2^(m_old - m_new); out = acc * ((2/qmax) / Sigma * dv).
//
// attention_kernel<FUSED> replaces the Pallas TPU kernel
//   src/repro/kernels/int_attention.py::int_attention_fused
//   (_fused_kernel, _live_kblock_meta, _tile_logits, _online_update,
//   _pv_dot, _grid_scales): prompt-prefill attention.
//   One block per (head-fold h, query block i) walks its own key tiles in
//   order (the TPU's sequential key grid axis becomes this loop) and skips
//   tiles no (row, key) pair of the block can see (the TPU's static
//   live-block map becomes an in-block test; skipping a fully masked tile
//   is bit-exact).  Codes are unsigned bytes multiplied with the signed
//   value codes by dp4a.u32.s32, so 8-bit grids need no -128 bias.
//   Bound: int8 operations (Sq*Sk*D*2 per head-fold, halved by causality).
//
// The two-pass kernel replaces
//   src/repro/kernels/int_attention.py::int_attention (_stats_kernel,
//   _pv_kernel), the reference's baseline: the same device code as the
//   fused kernel (attention_kernel<MODE>), run as a Sigma pass (STATS:
//   no V, no PV; writes max(Sigma, 1e-30) per row) and a PV pass (PV:
//   recomputes QK^T and the same running-m codes, reads Sigma).  Both
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
//   are unpacked in shared memory.  Bound: the live KV bytes.
//
// ring_decode_kernel replaces
//   src/repro/kernels/int_attention.py::int_decode_attention
//   (_decode_kernel, _decode_meta): every decode step over the KV ring
//   cache of models/lm.py.  One block per head-fold h loads the query
//   position from device memory and walks the ring's bk-blocks in slot
//   order; a block none of whose slots holds a live key (k_positions
//   negative, after pos, or outside the window) is skipped, which is
//   bit-exact (it cannot raise the running m and adds e = 0): this replaces
//   the TPU's scalar-prefetched live-block map.  Per live block the G x bk
//   f32 logits stay in shared memory (80 KB at G = 5, bk = 4096) until the
//   block's floor(max) is known; then the codes, Sigma, and the int32 PV
//   over 128-key sub-tiles of V (transposed into shared memory, sub-tiles
//   without a live key skipped).  Keys whose slot is dead skip their
//   logits' dot products.  The TPU's padding of G to 8 rows is not carried
//   over.  Bound: the live KV bytes.  A simple kernel: at the main path's
//   32 head-folds it fills 32 of the 132 SMs and reads each key row with
//   4-byte loads; splitting the ring across blocks needs a second pass
//   that merges running grids, left to later work.
//
// Sigma is an f32 sum over a tile taken in another order than the plain
// versions take it, so outputs agree within a tolerance; codes, m and the
// int32 partials agree exactly.
#include "common.cuh"

namespace {

constexpr int NTA = 256;     // fused prefill block
constexpr int MAXJA = 32;    // accumulators per thread: bq * D <= 8192
constexpr int NTP = 128;     // paged decode block
constexpr int MAXJP = 16;    // accumulators per thread: G * D <= 2048
constexpr int NTR = 256;     // ring decode block
constexpr int MAXJR = 8;     // accumulators per thread: G * D <= 2048
constexpr int MAXGR = 8;     // query rows per pass over a key row
constexpr int RSUB = 128;    // keys per V sub-tile

enum { FUSED = 0, STATS = 1, PV = 2 };

// Query rows i*bq + r of head-fold h against the key tiles of one row;
// MODE FUSED does everything in one sweep, STATS only Sigma (into sums),
// PV only the codes and PV (Sigma from sums).  The validity of a (row,
// key) pair is the reference's _mask: key < SK, key <= row position when
// causal, key > row position - window; a tile where no pair is valid is
// skipped, which is bit-exact (e = 0, the carries keep their values).
template <int MODE>
__global__ void __launch_bounds__(NTA)
attention_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                 const int8_t* __restrict__ v, const float* __restrict__ sc,
                 const float* __restrict__ vs, float* __restrict__ out,
                 uint8_t* __restrict__ codes, float* __restrict__ sums,
                 int SQ, int SK, int D, int bq, int bk, int nq, int sq_mod,
                 int causal, int window, float qmax, float two_over_qmax) {
  extern __shared__ __align__(16) int smem[];
  const int i = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = NTA / 32;
  const int DW = D / 4, QS = DW + 1, KWD = bk / 4, PS = KWD + 1;
  int* qs = smem;                          // bq x QS words
  int* ks = qs + bq * QS;                  // bk x QS words
  int* vt = ks + bk * QS;                  // D x PS words: vT[d][key]
  float* xs = reinterpret_cast<float*>(vt + D * PS);     // bq x bk
  int* pc = reinterpret_cast<int*>(xs + bq * bk);        // bq x PS words
  float* mrow = reinterpret_cast<float*>(pc + bq * PS);  // bq
  float* srow = mrow + bq;
  float* arow = srow + bq;
  uint8_t* vtb = reinterpret_cast<uint8_t*>(vt);
  uint8_t* pcb = reinterpret_cast<uint8_t*>(pc);

  const int q0 = i * bq;
  const float sct = sc[h * nq + i];
  const float qmax_half = qmax * 0.5f;
  for (int idx = tid; idx < bq * DW; idx += NTA) {
    const int r = idx / DW, c = idx % DW, gr = q0 + r;
    qs[r * QS + c] = gr < SQ ? ld32(q + ((size_t)h * SQ + gr) * D + 4 * c) : 0;
  }
  for (int r = tid; r < bq; r += NTA) {
    mrow[r] = NEG_BIG;
    srow[r] = 0.0f;
  }
  float acc[MAXJA];
#pragma unroll
  for (int j = 0; j < MAXJA; ++j) acc[j] = 0.0f;

  const int nk = (SK + bk - 1) / bk;
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * bk;
    // Row r's valid keys under _mask are the interval [lo, hi].
    int live = 0;
    for (int r = tid; r < bq; r += NTA) {
      const int qp = (q0 + r) % sq_mod;
      const int lo = window >= 0 ? max(qp - (window - 1), 0) : 0;
      const int hi = causal ? min(qp, SK - 1) : SK - 1;
      live |= (lo <= hi && lo <= k0 + bk - 1 && hi >= k0);
    }
    if (!__syncthreads_or(live)) continue;   // fully masked: bit-exact skip

    for (int idx = tid; idx < bk * DW; idx += NTA) {
      const int r = idx / DW, c = idx % DW, gk = k0 + r;
      const size_t off = ((size_t)h * SK + gk) * D + 4 * c;
      ks[r * QS + c] = gk < SK ? ld32(k + off) : 0;
      if (MODE != STATS) {
        const int vv = gk < SK ? ld32(v + off) : 0;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          vtb[(4 * c + b) * (PS * 4) + r] = (vv >> (8 * b)) & 0xFF;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < bq * bk; idx += NTA) {
      const int r = idx / bk, c = idx % bk;
      int a = 0;
      for (int w = 0; w < DW; ++w) a = __dp4a(qs[r * QS + w], ks[c * QS + w], a);
      const int qp = (q0 + r) % sq_mod, kp = k0 + c;
      bool valid = kp < SK;
      if (causal) valid &= kp <= qp;
      if (window >= 0) valid &= kp > qp - window;
      const float x = valid ? __fmul_rn(__int2float_rn(a), sct) : NEG_BIG;
      xs[idx] = fmaxf(x, -120.0f);
    }
    __syncthreads();

    for (int r = warp; r < bq; r += nwarps) {
      float mx = -INFINITY;
      for (int c = lane; c < bk; c += 32) mx = fmaxf(mx, xs[r * bk + c]);
      mx = warp_max(mx);
      if (lane == 0) {
        const float mo = mrow[r];
        const float mn = fmaxf(mo, floorf(mx));
        arow[r] = carry_scale(mo, mn);
        mrow[r] = mn;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < bq * bk; idx += NTA) {
      const int r = idx / bk, c = idx % bk;
      const float x = xs[idx];
      const float e = x <= -120.0f ? 0.0f : exp2_shift(__fsub_rn(x, mrow[r]));
      xs[idx] = e;
      if (MODE != STATS) {
        const float p =
            fminf(fmaxf(rintf(__fmul_rn(e, qmax_half)), 0.0f), qmax);
        pcb[r * PS * 4 + c] = static_cast<uint8_t>(p);
        if (codes && q0 + r < SQ && k0 + c < SK)
          codes[((size_t)h * SQ + q0 + r) * SK + k0 + c] =
              static_cast<uint8_t>(p);
      }
    }
    __syncthreads();

    if (MODE != PV) {
      for (int r = warp; r < bq; r += nwarps) {
        float sum = 0.0f;
        for (int c = lane; c < bk; c += 32)
          sum = __fadd_rn(sum, xs[r * bk + c]);
        sum = warp_sum(sum);
        if (lane == 0) srow[r] = __fadd_rn(__fmul_rn(srow[r], arow[r]), sum);
      }
    }
    if (MODE != STATS) {
#pragma unroll
      for (int j = 0; j < MAXJA; ++j) {
        const int o = tid + NTA * j;
        if (o < bq * D) {
          const int r = o / D, col = o % D;
          int a = 0;
          for (int w = 0; w < KWD; ++w)
            a = dp4a_us(static_cast<unsigned>(pc[r * PS + w]),
                        vt[col * PS + w], a);
          acc[j] = __fadd_rn(__fmul_rn(acc[j], arow[r]), __int2float_rn(a));
        }
      }
    }
    __syncthreads();
  }

  if (MODE == STATS) {
    for (int r = tid; r < bq; r += NTA)
      sums[(size_t)h * nq * bq + q0 + r] = fmaxf(srow[r], 1e-30f);
    return;
  }
  const float dv = vs[h];
#pragma unroll
  for (int j = 0; j < MAXJA; ++j) {
    const int o = tid + NTA * j;
    if (o < bq * D) {
      const int r = o / D, col = o % D, gr = q0 + r;
      if (gr < SQ) {
        const float s = MODE == PV ? sums[(size_t)h * nq * bq + gr]
                                   : fmaxf(srow[r], 1e-30f);
        const float dattn = __fdiv_rn(two_over_qmax, s);
        out[((size_t)h * SQ + gr) * D + col] =
            __fmul_rn(acc[j], __fmul_rn(dattn, dv));
      }
    }
  }
}

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
  extern __shared__ __align__(16) int smem[];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = NTP / 32;
  const int DW = D / 4, QS = DW + 1, KWD = ps / 4, PS = KWD + 1;
  const int dk = packed ? D / 2 : D;
  int* qs = smem;                          // G x QS
  int* ks = qs + G * QS;                   // ps x QS
  int* vt = ks + ps * QS;                  // D x PS: vT[d][key]
  float* xs = reinterpret_cast<float*>(vt + D * PS);     // G x ps
  int* pc = reinterpret_cast<int*>(xs + G * ps);         // G x PS
  float* mrow = reinterpret_cast<float*>(pc + G * PS);   // G
  float* srow = mrow + G;
  float* arow = srow + G;
  uint8_t* vtb = reinterpret_cast<uint8_t*>(vt);
  uint8_t* pcb = reinterpret_cast<uint8_t*>(pc);
  const float qmax_half = qmax * 0.5f;
  const bool page_scaled = kps != nullptr;

  const size_t qrow = ((size_t)b * HKV + h) * G;
  for (int idx = tid; idx < G * DW; idx += NTP) {
    const int g = idx / DW, c = idx % DW;
    qs[g * QS + c] = ld32(q + (qrow + g) * D + 4 * c);
  }
  for (int g = tid; g < G; g += NTP) {
    mrow[g] = NEG_BIG;
    srow[g] = 0.0f;
  }
  float acc[MAXJP];
#pragma unroll
  for (int j = 0; j < MAXJP; ++j) acc[j] = 0.0f;

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
    for (int idx = tid; idx < ps * DW; idx += NTP) {
      const int r = idx / DW, c = idx % DW;
      int kw, vw;
      if (packed) {
        const size_t off = page + (size_t)r * dk + 2 * c;
        kw = unpack4(*reinterpret_cast<const unsigned short*>(kpool + off));
        vw = unpack4(*reinterpret_cast<const unsigned short*>(vpool + off));
      } else {
        const size_t off = page + (size_t)r * dk + 4 * c;
        kw = *reinterpret_cast<const int*>(kpool + off);
        vw = *reinterpret_cast<const int*>(vpool + off);
      }
      ks[r * QS + c] = kw;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
        vtb[(4 * c + bb) * (PS * 4) + r] = (vw >> (8 * bb)) & 0xFF;
    }
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
#pragma unroll
    for (int j = 0; j < MAXJP; ++j) {
      const int o = tid + NTP * j;
      if (o < G * D) {
        const int g = o / D, col = o % D;
        int a = 0;
        for (int w = 0; w < KWD; ++w)
          a = dp4a_us(static_cast<unsigned>(pc[g * PS + w]), vt[col * PS + w],
                      a);
        float pv = __int2float_rn(a);
        if (page_scaled) pv = __fmul_rn(pv, vfac);
        acc[j] = __fadd_rn(__fmul_rn(acc[j], arow[g]), pv);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < MAXJP; ++j) {
    const int o = tid + NTP * j;
    if (o < G * D) {
      const int g = o / D, col = o % D;
      float f = __fdiv_rn(two_over_qmax, fmaxf(srow[g], 1e-30f));
      if (!page_scaled) f = __fmul_rn(f, vsb);
      out[(qrow + g) * D + col] = __fmul_rn(acc[j], f);
    }
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

__global__ void __launch_bounds__(NTR)
ring_decode_kernel(const int8_t* __restrict__ q,
                   const uint8_t* __restrict__ k,
                   const uint8_t* __restrict__ v,
                   const int* __restrict__ kpos, const int* __restrict__ posp,
                   const float* __restrict__ sc, const float* __restrict__ vs,
                   float* __restrict__ out, uint8_t* __restrict__ codes,
                   int G, int D, int span, int bk, int causal, int window,
                   int packed, float qmax, float two_over_qmax) {
  extern __shared__ __align__(16) int smem[];
  const int h = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = NTR / 32;
  const int DW = D / 4, PSW = bk / 4 + 1, VS = RSUB / 4 + 1;
  const int dk = packed ? D / 2 : D;
  int* qs = smem;                                        // G x DW
  float* xs = reinterpret_cast<float*>(qs + G * DW);     // G x bk
  int* pc = reinterpret_cast<int*>(xs + (size_t)G * bk); // G x PSW
  int* vt = pc + G * PSW;                                // D x VS: vT[d][key]
  float* mrow = reinterpret_cast<float*>(vt + D * VS);   // G
  float* srow = mrow + G;
  float* arow = srow + G;
  uint8_t* vtb = reinterpret_cast<uint8_t*>(vt);
  uint8_t* pcb = reinterpret_cast<uint8_t*>(pc);
  const float qmax_half = qmax * 0.5f;

  for (int idx = tid; idx < G * DW; idx += NTR) {
    const int g = idx / DW, c = idx % DW;
    qs[g * DW + c] = ld32(q + ((size_t)h * G + g) * D + 4 * c);
  }
  for (int g = tid; g < G; g += NTR) {
    mrow[g] = NEG_BIG;
    srow[g] = 0.0f;
  }
  float acc[MAXJR];
#pragma unroll
  for (int j = 0; j < MAXJR; ++j) acc[j] = 0.0f;
  const int pos = posp[0];
  const float sct = sc[h], vsh = vs[h];
  const size_t ring = (size_t)h * span * dk;
  __syncthreads();

  const int nk = (span + bk - 1) / bk;
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * bk;
    int live = 0;
    for (int c = tid; c < bk && !live; c += NTR)
      live = ring_live(kpos, k0 + c, span, pos, causal, window);
    if (!__syncthreads_or(live)) continue;   // no live key: bit-exact skip

    // Logits of the block: one key row per thread, up to MAXGR query rows
    // per pass over it; dead slots skip the dot products.
    for (int c = tid; c < bk; c += NTR) {
      const int j = k0 + c;
      if (!ring_live(kpos, j, span, pos, causal, window)) {
        for (int g = 0; g < G; ++g) xs[(size_t)g * bk + c] = -120.0f;
        continue;
      }
      const uint8_t* krow = k + ring + (size_t)j * dk;
      for (int g0 = 0; g0 < G; g0 += MAXGR) {
        int a[MAXGR];
#pragma unroll
        for (int r = 0; r < MAXGR; ++r) a[r] = 0;
        for (int w = 0; w < DW; w += 2) {
          int k0w, k1w;
          if (packed) {
            const unsigned u =
                *reinterpret_cast<const unsigned*>(krow + 2 * w);
            k0w = unpack4(u & 0xFFFFu);
            k1w = unpack4(u >> 16);
          } else {
            k0w = *reinterpret_cast<const int*>(krow + 4 * w);
            k1w = *reinterpret_cast<const int*>(krow + 4 * w + 4);
          }
#pragma unroll
          for (int r = 0; r < MAXGR; ++r) {
            if (g0 + r < G) {
              a[r] = __dp4a(qs[(g0 + r) * DW + w], k0w, a[r]);
              a[r] = __dp4a(qs[(g0 + r) * DW + w + 1], k1w, a[r]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < MAXGR; ++r) {
          if (g0 + r < G)
            xs[(size_t)(g0 + r) * bk + c] =
                fmaxf(__fmul_rn(__int2float_rn(a[r]), sct), -120.0f);
        }
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += nwarps) {
      float mx = -INFINITY;
      for (int c = lane; c < bk; c += 32)
        mx = fmaxf(mx, xs[(size_t)g * bk + c]);
      mx = warp_max(mx);
      if (lane == 0) {
        const float mo = mrow[g];
        const float mn = fmaxf(mo, floorf(mx));
        arow[g] = carry_scale(mo, mn);
        mrow[g] = mn;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < G * bk; idx += NTR) {
      const int g = idx / bk, c = idx % bk;
      const float x = xs[idx];
      const float e = x <= -120.0f ? 0.0f : exp2_shift(__fsub_rn(x, mrow[g]));
      const float p =
          fminf(fmaxf(rintf(__fmul_rn(e, qmax_half)), 0.0f), qmax);
      xs[idx] = e;
      pcb[(size_t)g * PSW * 4 + c] = static_cast<uint8_t>(p);
      if (codes && k0 + c < span)
        codes[((size_t)h * G + g) * span + k0 + c] = static_cast<uint8_t>(p);
    }
    __syncthreads();

    for (int g = warp; g < G; g += nwarps) {
      float sum = 0.0f;
      for (int c = lane; c < bk; c += 32)
        sum = __fadd_rn(sum, xs[(size_t)g * bk + c]);
      sum = warp_sum(sum);
      if (lane == 0) srow[g] = __fadd_rn(__fmul_rn(srow[g], arow[g]), sum);
    }

    // Integer PV over the block, 128 keys of V at a time.
    int ia[MAXJR];
#pragma unroll
    for (int j = 0; j < MAXJR; ++j) ia[j] = 0;
    for (int s0 = 0; s0 < bk; s0 += RSUB) {
      int sub = 0;
      for (int c = tid; c < RSUB && !sub; c += NTR)
        sub = ring_live(kpos, k0 + s0 + c, span, pos, causal, window);
      if (!__syncthreads_or(sub)) continue;  // all codes 0: exact skip
      for (int idx = tid; idx < RSUB * DW; idx += NTR) {
        const int r = idx / DW, c = idx % DW, j = k0 + s0 + r;
        int vw = 0;
        if (j < span) {
          const uint8_t* vrow = v + ring + (size_t)j * dk;
          vw = packed ? unpack4(*reinterpret_cast<const unsigned short*>(
                            vrow + 2 * c))
                      : *reinterpret_cast<const int*>(vrow + 4 * c);
        }
#pragma unroll
        for (int b = 0; b < 4; ++b)
          vtb[(4 * c + b) * (VS * 4) + r] = (vw >> (8 * b)) & 0xFF;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < MAXJR; ++j) {
        const int o = tid + NTR * j;
        if (o < G * D) {
          const int g = o / D, col = o % D;
          const int* pw = pc + g * PSW + s0 / 4;
          int a = ia[j];
          for (int w = 0; w < RSUB / 4; ++w)
            a = dp4a_us(static_cast<unsigned>(pw[w]), vt[col * VS + w], a);
          ia[j] = a;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < MAXJR; ++j) {
      const int o = tid + NTR * j;
      if (o < G * D)
        acc[j] = __fadd_rn(__fmul_rn(acc[j], arow[o / D]),
                           __int2float_rn(ia[j]));
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < MAXJR; ++j) {
    const int o = tid + NTR * j;
    if (o < G * D) {
      const int g = o / D, col = o % D;
      const float f = __fmul_rn(
          __fdiv_rn(two_over_qmax, fmaxf(srow[g], 1e-30f)), vsh);
      out[((size_t)h * G + g) * D + col] = __fmul_rn(acc[j], f);
    }
  }
}

size_t fused_smem(int bq, int bk, int D) {
  const int QS = D / 4 + 1, PS = bk / 4 + 1;
  return 4 * ((size_t)bq * QS + (size_t)bk * QS + (size_t)D * PS +
              (size_t)bq * bk + (size_t)bq * PS + 3 * (size_t)bq);
}

size_t paged_smem(int G, int ps, int D) {
  const int QS = D / 4 + 1, PS = ps / 4 + 1;
  return 4 * ((size_t)G * QS + (size_t)ps * QS + (size_t)D * PS +
              (size_t)G * ps + (size_t)G * PS + 3 * (size_t)G);
}

size_t ring_smem(int G, int bk, int D) {
  return 4 * ((size_t)G * (D / 4) + (size_t)G * bk + (size_t)G * (bk / 4 + 1) +
              (size_t)D * (RSUB / 4 + 1) + 3 * (size_t)G);
}

template <int MODE>
cudaError_t launch_attention(const void* q, const void* k, const void* v,
                             const void* sc, const void* vs, void* out,
                             void* codes, void* sums, int H, int SQ, int SK,
                             int D, int bq, int bk, int sq_mod, int causal,
                             int window, float qmax, float two_over_qmax,
                             cudaStream_t stream) {
  const size_t smem = fused_smem(bq, bk, D);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int nq = (SQ + bq - 1) / bq;
  attention_kernel<MODE><<<dim3(nq, H), NTA, smem, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(sc),
      static_cast<const float*>(vs), static_cast<float*>(out),
      static_cast<uint8_t*>(codes), static_cast<float*>(sums), SQ, SK, D, bq,
      bk, nq, sq_mod, causal, window, qmax, two_over_qmax);
  return cudaGetLastError();
}

// What the fused and two-pass kernels take (also stated in
// kernels/int_attention.py): D % 4 == 0 and bk % 4 == 0 (int8 words),
// bq * D <= 8192 (32 f32 output accumulators a thread), fused_smem within
// the card's 227 KB.
bool attention_fits(int D, int bq, int bk) {
  return D % 4 == 0 && bk % 4 == 0 && bq * D <= NTA * MAXJA;
}

}  // namespace

// q (H, SQ, D) int8 with GQA groups stacked along SQ (row r at position
// r % sq_mod); k, v (H, SK, D) int8; sc (H, nq) f32 per (head-fold, query
// block); vs (H,) f32; out (H, SQ, D) f32; codes (H, SQ, SK) uint8 or
// null.  window < 0 means none.
extern "C" int fused_attention_launch(const void* q, const void* k,
                                      const void* v, const void* sc,
                                      const void* vs, void* out, void* codes,
                                      int H, int SQ, int SK, int D, int bq,
                                      int bk, int sq_mod, int causal,
                                      int window, float qmax,
                                      float two_over_qmax, void* stream) {
  if (!attention_fits(D, bq, bk))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_attention<FUSED>(
      q, k, v, sc, vs, out, codes, nullptr, H, SQ, SK, D, bq, bk, sq_mod,
      causal, window, qmax, two_over_qmax,
      static_cast<cudaStream_t>(stream)));
}

// The two-pass kernel: same operands as fused_attention_launch, plus sums
// (H, nq * bq) f32 scratch, written by the Sigma pass and read by the PV
// pass on the same stream.
extern "C" int two_pass_attention_launch(const void* q, const void* k,
                                         const void* v, const void* sc,
                                         const void* vs, void* out,
                                         void* codes, void* sums, int H,
                                         int SQ, int SK, int D, int bq,
                                         int bk, int sq_mod, int causal,
                                         int window, float qmax,
                                         float two_over_qmax, void* stream) {
  if (!attention_fits(D, bq, bk))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_attention<STATS>(
      q, k, v, sc, vs, out, nullptr, sums, H, SQ, SK, D, bq, bk, sq_mod,
      causal, window, qmax, two_over_qmax, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_attention<PV>(
      q, k, v, sc, vs, out, codes, sums, H, SQ, SK, D, bq, bk, sq_mod,
      causal, window, qmax, two_over_qmax, st));
}

namespace {

// Paged decode takes D % 4 == 0, ps % 4 == 0 (int8 words), G * D <= 2048
// (16 f32 output accumulators a thread) and paged_smem within 227 KB (also
// stated in kernels/int_attention.py).
bool paged_fits(int G, int D, int ps) {
  return D % 4 == 0 && ps % 4 == 0 && G * D <= NTP * MAXJP;
}

}  // namespace

// q (B, HKV, G, D) int8; pools (num_phys, HKV, ps, D) int8 or
// (..., D/2) uint8 nibbles (packed); sc, vs (B,) f32; kps, vps
// (num_phys,) f32 per physical page, or both null; page_table
// (B, maxp) int32 (negative = unallocated); pos (B,) int32 (negative =
// inactive row -> zero output); out (B, HKV, G, D) f32; codes
// (B, HKV, G, maxp * ps) uint8 or null.
extern "C" int paged_decode_launch(const void* q, const void* kpool,
                                   const void* vpool, const void* sc,
                                   const void* vs, const void* kps,
                                   const void* vps, const void* page_table,
                                   const void* pos, void* out, void* codes,
                                   int B, int HKV, int G, int D, int ps,
                                   int maxp, int num_phys, int window,
                                   int packed, float qmax,
                                   float two_over_qmax, void* stream) {
  if (!paged_fits(G, D, ps)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = paged_smem(G, ps, D);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_kernel<<<dim3(HKV, B), NTP, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const uint8_t*>(kpool),
      static_cast<const uint8_t*>(vpool), static_cast<const float*>(sc),
      static_cast<const float*>(vs), static_cast<const float*>(kps),
      static_cast<const float*>(vps), static_cast<const int*>(page_table),
      static_cast<const int*>(pos), static_cast<float*>(out),
      static_cast<uint8_t*>(codes), HKV, G, D, ps, maxp, num_phys, window,
      packed, qmax, two_over_qmax);
  return static_cast<int>(cudaGetLastError());
}

// q (H, G, D) int8; k, v (H, span, D) int8 or (H, span, D/2) uint8
// nibbles (packed); kpos (span,) int32 slot -> position (negative =
// unwritten); pos (1,) int32 on the device; sc, vs (H,) f32; out
// (H, G, D) f32; codes (H, G, span) uint8 (zero-filled by the caller) or
// null.  window < 0 means none.  Constraints (checked in Python):
// D % 8 == 0, bk % 128 == 0, G * D <= 2048, ring_smem <= 227 KB.
extern "C" int ring_decode_launch(const void* q, const void* k, const void* v,
                                  const void* kpos, const void* pos,
                                  const void* sc, const void* vs, void* out,
                                  void* codes, int H, int G, int D, int span,
                                  int bk, int causal, int window, int packed,
                                  float qmax, float two_over_qmax,
                                  void* stream) {
  if (D % 8 || bk % RSUB || G * D > NTR * MAXJR)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ring_smem(G, bk, D);
  cudaError_t err = cudaFuncSetAttribute(
      ring_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ring_decode_kernel<<<dim3(H), NTR, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(v), static_cast<const int*>(kpos),
      static_cast<const int*>(pos), static_cast<const float*>(sc),
      static_cast<const float*>(vs), static_cast<float*>(out),
      static_cast<uint8_t*>(codes), G, D, span, bk, causal, window, packed,
      qmax, two_over_qmax);
  return static_cast<int>(cudaGetLastError());
}
