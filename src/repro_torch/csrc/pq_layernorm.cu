// Post-quantized LayerNorm (paper §IV-C), for Hopper (sm_90a).
//
// pq_layernorm_kernel replaces the Pallas TPU kernel
//   src/repro/kernels/pq_layernorm.py::pq_layernorm (_pqln_kernel):
//   f32 LayerNorm (or RMS with rms_only) -> gamma/beta -> divide by delta
//   -> round half to even -> clip to the signed b-bit grid, int8 out.  The
//   normalized activations never reach device memory in float.
//
// Bound: bytes (the input once, gamma/beta, one byte a code out).  The
// design reads each row from device memory once:
//  - A row is cut into 16-byte vectors (4 f32 or 8 bf16, V elements).  Its
//    TPR threads take vector j * TPR + t, j = 0, 1, ... (neighbouring
//    threads on neighbouring 16 bytes), each by one ld.global.nc into
//    registers, all issued before the first add.  The mean, the squared
//    deviations and the codes are computed from those registers; the codes
//    go out packed (4 or 8 bytes a vector).
//  - plan() picks TPR from d and V alone: a warp per row while a lane holds
//    at most WARP_VECS vectors (DeiT-S's 384, the reference's 1024), else
//    the fewest of 128, 256, 512, 1024 threads that leave a lane at most
//    ROW_VECS vectors, so that 256 wide rows (5120, 7168) fill the card
//    with 8 warps each.  A row wider than 1024 x ROW_VECS vectors is
//    re-read from global for each pass, in the same order.  Blocks of
//    1024 threads leave a thread 64 registers, so a lane holds more than
//    ROW_VECS vectors only in the 128-thread blocks of a warp per row.
//  - The order of every sum is a function of (d, V) only: each thread adds
//    its elements in element order, an xor-butterfly warp tree (16, 8, 4,
//    2, 1) adds the lanes, and a multi-warp row adds its warps' partials in
//    warp order through shared memory.  A tail vector (d % V != 0) and a
//    row whose base is not 16-byte aligned take element loads in the same
//    order, so only the load width depends on the pointer.  The plain
//    version (kernels/ref.py::pq_layernorm_ref, _plan_sums) takes the same
//    sums in the same order, so the codes agree exactly:
//      mean = sum(x) / d, var = sum((x - mean)^2) / d (RMS: sum(x*x) / d),
//      inv = 1 / sqrt(var + eps), each correctly rounded (no rsqrtf),
//      y = (x - mean) * inv * gamma (+ beta), each step rounded on its own,
//      code = clip(rint(y / delta)).
//    A null beta skips the add: y + 0 differs from y only at -0, whose code
//    is 0 either way.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int WARP_VECS = 8;    // vectors a lane holds when a warp takes a row
constexpr int ROW_VECS = 4;     // ... when several warps take a row
constexpr int MAX_TPR = 1024;
constexpr int MIN_BLOCK = 128;  // a warp-per-row block takes 4 rows

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// kernels/ref.py::pq_layernorm_plan, the one plan the launcher takes:
// threads per row, and vectors a thread takes (in registers when a warp
// takes the row or a lane holds at most ROW_VECS, else re-read).
struct Plan {
  int tpr, nv;
  bool in_registers() const { return tpr == 32 || nv <= ROW_VECS; }
};

Plan plan(int d, int vec) {
  const int chunks = cdiv(d, vec);
  if (chunks <= 32 * WARP_VECS) return {32, cdiv(chunks, 32)};
  int tpr = 128;
  while (tpr < MAX_TPR && cdiv(chunks, tpr) > ROW_VECS) tpr *= 2;
  return {tpr, cdiv(chunks, tpr)};
}

// One element type's raw bits and how they widen to f32.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  using Raw = unsigned;
  static constexpr int V = 4;
  static __device__ __forceinline__ float widen(Raw r) {
    return __uint_as_float(r);
  }
};
template <>
struct Elem<__nv_bfloat16> {
  using Raw = unsigned short;
  static constexpr int V = 8;
  static __device__ __forceinline__ float widen(Raw r) {
    return __bfloat162float(__ushort_as_bfloat16(r));
  }
};

// One 16-byte vector of a row, element i in r[i].
template <typename T>
union Chunk {
  uint4 v;
  typename Elem<T>::Raw r[Elem<T>::V];
};

// Vector c of row xr: one 16-byte load when the row is aligned and the
// vector whole, else element loads; elements at or past d are +0 bits.
template <typename T>
__device__ __forceinline__ Chunk<T> load_chunk(const T* xr, int c, int d,
                                               bool aligned) {
  constexpr int V = Elem<T>::V;
  const int e0 = c * V;
  Chunk<T> k;
  if (aligned && e0 + V <= d) {
    k.v = __ldg(reinterpret_cast<const uint4*>(xr) + c);
  } else {
    const auto* raw = reinterpret_cast<const typename Elem<T>::Raw*>(xr);
#pragma unroll
    for (int i = 0; i < V; ++i)
      k.r[i] = e0 + i < d ? __ldg(raw + e0 + i) : 0;
  }
  return k;
}

// gamma or beta at elements c*V .. c*V + V - 1 (only the first n valid).
template <int V>
__device__ __forceinline__ void load_vec(const float* p, int c, int n,
                                         bool aligned, float (&out)[V]) {
  if (aligned && n >= V) {
#pragma unroll
    for (int h = 0; h < V / 4; ++h) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p) +
                             c * (V / 4) + h);
      out[4 * h] = f.x;
      out[4 * h + 1] = f.y;
      out[4 * h + 2] = f.z;
      out[4 * h + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = i < n ? __ldg(p + c * V + i) : 0.0f;
  }
}

// The row's sum of each thread's s: the warp tree, then (several warps a
// row, one row a block) the warps' partials in warp order.
__device__ __forceinline__ float row_sum(float s, int tpr, float* part) {
  s = warp_sum(s);
  if (tpr == 32) return s;
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = s;
  __syncthreads();
  float total = part[0];
  for (int w = 1; w < tpr / 32; ++w) total = __fadd_rn(total, part[w]);
  return total;
}

// The two's complement byte of q, an integer in [-128, 127]: 1.5 * 2^23 + q
// is exact and its low mantissa byte is that byte.  An add in place of a
// float-to-int conversion, which issues at a quarter of the add's rate.
__device__ __forceinline__ unsigned code_byte(float q) {
  return __float_as_uint(__fadd_rn(q, 12582912.0f)) & 0xFFu;
}

struct Args {
  const void* x;
  const float* gamma;
  const float* beta;     // null: no beta
  int8_t* out;
  int rows, d, tpr;
  float eps, delta, qmin, qmax;
  int rms_only;
};

// NV > 0: the thread's NV vectors sit in registers; NV == 0: a row above
// the register plan, its vectors re-read from global in each pass.  A
// warp-per-row block holding more than ROW_VECS vectors a lane asks for 8
// blocks an SM (64 registers a thread), so the reference's 4096 rows of
// 1024 run in one wave.
template <typename T, int NV>
__global__ void __launch_bounds__(NV > ROW_VECS ? MIN_BLOCK : MAX_TPR,
                                  NV > ROW_VECS ? 8 : 1)
    pq_layernorm_kernel(Args a) {
  constexpr int V = Elem<T>::V;
  __shared__ float part[2][MAX_TPR / 32];
  const int tpr = a.tpr, d = a.d;
  const int t = threadIdx.x % tpr;
  const int row = blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  // A warp-per-row block leaves a row at a time; a multi-warp row has the
  // block to itself, so no thread that syncs ever leaves.
  if (row >= a.rows) return;
  const T* xr = static_cast<const T*>(a.x) + (size_t)row * d;
  const bool x_al = (reinterpret_cast<uintptr_t>(xr) & 15) == 0;
  const int nv = NV > 0 ? NV : cdiv(cdiv(d, V), tpr);
  Chunk<T> k[NV > 0 ? NV : 1];
  if constexpr (NV > 0) {
#pragma unroll
    for (int j = 0; j < NV; ++j) k[j] = load_chunk(xr, j * tpr + t, d, x_al);
  }
  auto chunk = [&](int j) -> Chunk<T> {
    if constexpr (NV > 0)
      return k[j];
    else
      return load_chunk(xr, j * tpr + t, d, x_al);
  };
  const float fd = static_cast<float>(d);
  float mu = 0.0f;
  if (!a.rms_only) {
    float s = 0.0f;                  // +0 bits past d add nothing
#pragma unroll
    for (int j = 0; j < nv; ++j) {
      const Chunk<T> c = chunk(j);
#pragma unroll
      for (int i = 0; i < V; ++i) s = __fadd_rn(s, Elem<T>::widen(c.r[i]));
    }
    mu = __fdiv_rn(row_sum(s, tpr, part[0]), fd);
  }
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < nv; ++j) {
    const Chunk<T> c = chunk(j);
    const int n = d - (j * tpr + t) * V;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float x = Elem<T>::widen(c.r[i]);
      const float u = a.rms_only ? x : __fsub_rn(x, mu);
      if (i < n) s = __fadd_rn(s, __fmul_rn(u, u));
    }
  }
  const float var = __fdiv_rn(row_sum(s, tpr, part[1]), fd);
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, a.eps)));
  int8_t* orow = a.out + (size_t)row * d;
  const bool o_al = (reinterpret_cast<uintptr_t>(orow) % V) == 0;
  const bool g_al = (reinterpret_cast<uintptr_t>(a.gamma) & 15) == 0;
  const bool b_al = (reinterpret_cast<uintptr_t>(a.beta) & 15) == 0;
#pragma unroll
  for (int j = 0; j < nv; ++j) {
    const int c = j * tpr + t;
    const int n = d - c * V;
    if (n <= 0) break;
    const Chunk<T> ch = chunk(j);
    float g[V], b[V];
    load_vec<V>(a.gamma, c, n, g_al, g);
    if (a.beta) load_vec<V>(a.beta, c, n, b_al, b);
    unsigned w[V / 4];
#pragma unroll
    for (int h = 0; h < V / 4; ++h) w[h] = 0;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float x = Elem<T>::widen(ch.r[i]);
      const float u = a.rms_only ? x : __fsub_rn(x, mu);
      float y = __fmul_rn(__fmul_rn(u, inv), g[i]);
      if (a.beta) y = __fadd_rn(y, b[i]);
      const float q =
          fminf(fmaxf(rintf(__fdiv_rn(y, a.delta)), a.qmin), a.qmax);
      w[i / 4] |= code_byte(q) << (8 * (i % 4));
    }
    if (o_al && n >= V) {
      if constexpr (V == 4)
        *reinterpret_cast<unsigned*>(orow + c * V) = w[0];
      else
        *reinterpret_cast<uint2*>(orow + c * V) = make_uint2(w[0], w[1]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (i < n)
          orow[c * V + i] = static_cast<int8_t>(w[i / 4] >> (8 * (i % 4)));
    }
  }
}

template <typename T>
cudaError_t launch(const Args& a, const Plan& p, cudaStream_t st) {
  const int block = a.tpr > MIN_BLOCK ? a.tpr : MIN_BLOCK;
  const int per = block / a.tpr;
  const unsigned grid = static_cast<unsigned>(cdiv(a.rows, per));
  switch (p.in_registers() ? p.nv : 0) {
    case 0: pq_layernorm_kernel<T, 0><<<grid, block, 0, st>>>(a); break;
    case 1: pq_layernorm_kernel<T, 1><<<grid, block, 0, st>>>(a); break;
    case 2: pq_layernorm_kernel<T, 2><<<grid, block, 0, st>>>(a); break;
    case 3: pq_layernorm_kernel<T, 3><<<grid, block, 0, st>>>(a); break;
    case 4: pq_layernorm_kernel<T, 4><<<grid, block, 0, st>>>(a); break;
    case 5: pq_layernorm_kernel<T, 5><<<grid, block, 0, st>>>(a); break;
    case 6: pq_layernorm_kernel<T, 6><<<grid, block, 0, st>>>(a); break;
    case 7: pq_layernorm_kernel<T, 7><<<grid, block, 0, st>>>(a); break;
    case 8: pq_layernorm_kernel<T, 8><<<grid, block, 0, st>>>(a); break;
  }
  return cudaGetLastError();
}

}  // namespace

// x (rows, d) f32 (bf16 when is_bf16), any 2-byte (bf16) or 4-byte (f32)
// alignment; gamma (d,) f32; beta (d,) f32 or null; out (rows, d) int8.
// (tpr, vec, ept) must be plan(d, vec): threads per row, elements a vector
// (4 f32, 8 bf16) and elements a thread (vectors a thread times vec);
// anything else returns cudaErrorInvalidValue and launches nothing.
extern "C" int pq_layernorm_launch(const void* x, const void* gamma,
                                   const void* beta, void* out, int rows,
                                   int d, int is_bf16, int tpr, int vec,
                                   int ept, float eps, float delta,
                                   float qmin, float qmax, int rms_only,
                                   void* stream) {
  const int want_vec = is_bf16 ? Elem<__nv_bfloat16>::V : Elem<float>::V;
  if (rows <= 0 || d <= 0 || vec != want_vec)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(d, vec);
  if (tpr != p.tpr || ept != p.nv * vec)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, static_cast<const float*>(gamma),
               static_cast<const float*>(beta), static_cast<int8_t*>(out),
               rows, d, tpr, eps, delta, qmin, qmax, rms_only};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? launch<__nv_bfloat16>(a, p, st)
                                  : launch<float>(a, p, st));
}
