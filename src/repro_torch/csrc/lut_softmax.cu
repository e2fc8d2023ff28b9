// Row-wise LUT softmax for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/lut_softmax/lut_softmax.py:
// rexp_softmax_pallas (body _rexp_kernel) and lut2d_softmax_pallas (body
// _lut2d_kernel), both launched by the pallas_call of _row_softmax_call.
// x (rows, cols) of f32, bf16 or f16 → σ (rows, cols) f32, REXP
// (Algorithm 1) or 2D-LUT (Algorithm 2) along each row, with the TPU
// kernel's semantics: the row max is taken over the finite entries (0
// when none is finite), and every non-finite entry (−inf, +inf, NaN)
// gives a hard 0.
//
// The per-element arithmetic is csrc/lut_pipeline.cuh's, bin for bin:
// lut_e_term (the numerator from the row max), sigma_col (the weight
// table's column from the row's Σ, once a row, with REXP's α) and
// sigma_int / weight.  Every rounding step is an _rn intrinsic and the
// f32 reciprocals come from the host, as there; the bins round half to
// even or down through a magic-number add on the FP32 pipe instead of
// rintf / floorf and float ↔ int conversions (bin_index below), and the
// tables are held as f32, so no element touches the conversion pipe.
// Build without --use_fast_math.
//
// Where the output is bitwise the plain version's: Σ is an f32 sum of
// integer numerators, split across lanes (and warps) in another order
// than the reference's jnp.sum / torch.sum.  The order does not matter
// while every partial sum is an integer below 2^24, that is while
// cols · qmax < 2^24 (65 793 columns at uint8, 512 at int16).  Past it
// the reference's own f32 sum depends on its order, and no kernel can
// promise its bits; nothing in either package guards the row op there.
//
// What bounds it on the H100: bytes.  Each element is read once and
// written once as f32 with about ten operations between, far below the
// card's operations per byte; the least time is (input bytes + 4 bytes
// out) per element over 3.35 TB/s.
//
// Design.  The launch plan comes from the host (kernels/lut_softmax/
// lut_softmax.py: row_plan): the route, the vector width, the register
// budget, the pipeline depth, the grid, the threads and the shared
// memory; the launcher only checks it.  Both routes run a persistent
// grid of about (SMs × blocks an SM holds) CTAs: each copies the tables
// into shared memory once and walks rows by a grid stride.
//
// * Route 0, "warp" (rows of up to 2048 columns): one warp a row, the
//   row in registers (E elements a lane, E a template bucket).  Loads
//   are ld.global.nc.L1::no_allocate of V elements (16 bytes for f32 at
//   V = 4 and 16-bit types at V = 8), 16-bit inputs kept packed until
//   used; a 16-bit row's successor is copied into the warp's buffer in
//   shared memory by cp.async while the warp works on it; the max and Σ
//   are warp shuffles with no block barrier; sigma_col (and REXP's α)
//   once a row; σ leaves as streaming stores (st.global.cs) of V floats.
// * Route 1, "cta" (longer rows): one CTA a row.  When the row is
//   16-byte aligned and fits, it is staged in shared memory by a TMA
//   1-D bulk copy (cp.async.bulk) completed on an mbarrier, with the
//   CTA's next row already in flight into a second buffer where two fit
//   (stages 2); otherwise (stages 0) each pass re-reads the row from
//   global memory (L2), so no column count is refused.
//
// V is the widest of 8, 4 and 1 elements that divides cols and both
// base pointers' alignment (a row of bf16 at 1500 columns is only 8-byte
// aligned every other row, so it loads 4 elements); a misaligned vector
// load would fault, so the launcher refuses a plan that does not fit the
// pointers.
#include "lut_pipeline.cuh"

#include <string.h>

namespace {

using lutk::LutParams;

// The threads and the blocks an SM must hold (the __launch_bounds__
// minimum: the host's grid is SMs × blocks) of each route.  Python's
// row_plan mirrors these, and the warp route's register budget: E
// elements a lane, in two buckets (48 for Whisper's 1500 columns, 64
// for 2048); rows of up to 32 · E columns fit bucket E.
constexpr int kWarpThreads = 256, kWarpBlocks = 2;
constexpr int kCtaThreads = 512, kCtaBlocks = 2;
// Shared memory a CTA may take (227 KB).
constexpr size_t kSmemLimit = 232448;

// V consecutive elements of a row as raw bits: BYTES = V · sizeof(T).
template <int BYTES>
struct Raw;
template <>
struct Raw<2> { unsigned short u; };
template <>
struct Raw<4> { unsigned u; };
template <>
struct Raw<8> { uint2 u; };
template <>
struct Raw<16> { uint4 u; };

// Read-only streaming loads: each element is read once, so none is kept
// in L1.
__device__ __forceinline__ void ld_stream(Raw<2>& r, const void* p) {
  asm("ld.global.nc.L1::no_allocate.b16 %0, [%1];" : "=h"(r.u) : "l"(p));
}
__device__ __forceinline__ void ld_stream(Raw<4>& r, const void* p) {
  asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(r.u) : "l"(p));
}
__device__ __forceinline__ void ld_stream(Raw<8>& r, const void* p) {
  asm("ld.global.nc.L1::no_allocate.v2.b32 {%0, %1}, [%2];"
      : "=r"(r.u.x), "=r"(r.u.y)
      : "l"(p));
}
__device__ __forceinline__ void ld_stream(Raw<16>& r, const void* p) {
  asm("ld.global.nc.L1::no_allocate.v4.b32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.u.x), "=r"(r.u.y), "=r"(r.u.z), "=r"(r.u.w)
      : "l"(p));
}

template <typename T, int V>
struct Vec {
  Raw<V * sizeof(T)> r;
  __device__ __forceinline__ void load_stream(const T* p) { ld_stream(r, p); }
  // a plain load: from shared memory, or a row re-read from L2
  __device__ __forceinline__ void load(const T* p) {
    r = *reinterpret_cast<const Raw<V * sizeof(T)>*>(p);
  }
  __device__ __forceinline__ void get(float (&f)[V]) const {
    T e[V];
    memcpy(e, &r, sizeof(e));
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = lutk::to_f32(e[j]);
  }
};

// V floats of σ as streaming stores (st.global.cs): the output is
// written once and not read back by this kernel.
template <int V>
__device__ __forceinline__ void st_stream(float* dst, const float (&w)[V]) {
  if constexpr (V == 1) {
    __stcs(dst, w[0]);
  } else {
#pragma unroll
    for (int j = 0; j < V; j += 4)
      __stcs(reinterpret_cast<float4*>(dst + j),
             make_float4(w[j], w[j + 1], w[j + 2], w[j + 3]));
  }
}

// The tables in shared memory as f32 — their entries are integers up to
// qmax, exact in f32, so no int → float conversion follows a lookup:
// LUT_1/e or LUT_exp replicated across the 32 banks (lane l reads copy
// l, so a warp's lookups never conflict; 2D-LUT's 101-entry LUT_exp
// would conflict up to 4-way), then LUT_α or LUT_σ as they are.  Python's
// row_plan mirrors the size.
__host__ __device__ inline size_t table_bytes(const LutParams& p) {
  return 4 * (32 * size_t(p.n_main) + size_t(p.aux_rows) * p.aux_cols);
}

__device__ __forceinline__ void copy_tables(float* tables, const int* lut_main,
                                            const int* lut_aux,
                                            const LutParams& p) {
  const int n_rep = 32 * p.n_main, n = n_rep + p.aux_rows * p.aux_cols;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    tables[i] = float(i < n_rep ? lut_main[i >> 5] : lut_aux[i - n_rep]);
}

// The bin path of lutk::clamp_bin, lut_e_term and sigma_int, bit for bit,
// on the FP32 and integer pipes only: rintf, floorf and the float ↔ int
// conversions run at an eighth of the FP32 rate on Hopper, and at six an
// element they held the card back.  Adding 1.5 · 2^23 rounds x to an
// integer in the low mantissa bits, half to even, exactly as rintf for
// 0 ≤ x < 2^22; floor takes one off where that rounded up.  Every x the
// kernel bins is ≥ 0 (m − s for finite s, since m is the max over the
// finite entries; e / scale), larger x and +inf land above hi, and a NaN
// (only from a non-finite s, whose numerator is forced to 0) lands
// anywhere: the clamp keeps every index inside the table.
constexpr float kMagic = 12582912.f;

__device__ __forceinline__ int bin_index(float x, int round_mode, int lo,
                                         int hi) {
  const float t = __fadd_rn(x, kMagic);
  int k = __float_as_int(t) - __float_as_int(kMagic);
  if (!round_mode && __fsub_rn(t, kMagic) > x) --k;
  return min(max(k, lo), hi);
}

// rintf(x) for 0 ≤ x < 2^22.
__device__ __forceinline__ float round_even(float x) {
  return __fsub_rn(__fadd_rn(x, kMagic), kMagic);
}

// lutk::lut_e_term: the numerator of logit s given the row max m,
// LUT_1/e[bin(m − s)] (REXP) or LUT_exp[bin((m − s)/step)] (2D-LUT), a
// hard 0 for a non-finite s.
template <int M>
__device__ __forceinline__ float numerator(float s, float m,
                                           const float* main_rep, int lane,
                                           const LutParams& p) {
  float d = __fsub_rn(m, s);
  if constexpr (M == lutk::kLut2d) d = __fmul_rn(d, p.inv_step);
  const float e = main_rep[bin_index(d, p.round_mode, 0, p.n_main - 1) * 32 +
                           lane];
  return isfinite(s) ? e : 0.f;
}

// What a row's Σ fixes for every weight of the row: the column of the
// weight table (lutk::sigma_col) and, for REXP, α = LUT_α[col] itself.
struct RowSigma {
  int col;
  float alpha;
};

template <int M>
__device__ __forceinline__ RowSigma row_sigma(float S, const float* aux,
                                              const LutParams& p) {
  const int col = lutk::sigma_col(S, p);
  return {col, M == lutk::kRexp ? aux[col] : 0.f};
}

// σ of one element from its numerator e: lutk::weight's arithmetic —
// REXP round(e·α/qmax), 2D-LUT LUT_σ[i(e), j(Σ)], times 1/qmax.  e·α is
// the f32 rounding of the exact integer product, as float(int(e) * α).
template <int M>
__device__ __forceinline__ float row_weight(float e, RowSigma rs,
                                            const float* aux,
                                            const LutParams& p) {
  float s;
  if constexpr (M == lutk::kRexp) {
    s = round_even(__fmul_rn(__fmul_rn(e, rs.alpha), p.inv_q));
  } else {
    const int i = bin_index(__fmul_rn(e, p.inv_ex), p.round_mode, 0,
                            p.aux_rows - 1);
    s = aux[i * p.aux_cols + rs.col];
  }
  return __fmul_rn(s, p.inv_q);
}

// The warp route copies each warp's next row into shared memory
// (cp.async) while it works on the current one for elements of up to
// this many bytes (and vectors of 4 bytes or more), and loads other rows
// straight into registers when it starts on them.  A 16-bit row holds
// half the bytes in flight of an f32 one; f32 rows measured no faster
// with the copy, 2D-LUT's slower.  Python's row_plan mirrors it.
constexpr int kPrefetchMaxBytes = 2;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return unsigned(__cvta_generic_to_shared(p));
}

// N bytes (4, 8 or 16) global → shared, asynchronously.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(N)
                 : "memory");
}

// Shared memory is laid out in 16-byte units: the tables, then the
// warp route's per-warp row buffers or the cta route's row buffers.
__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Route 0: a warp a row, the row in registers.  E elements a lane in
// NV = E / V vectors; lane l holds vectors l, l + 32, ... of the row.
// With kStage, each lane copies its own vectors of the warp's next row
// into the warp's buffer in shared memory as soon as it has used the
// current row's (after the max), and reads them from there when the warp
// starts on that row, so a warp's loads are in flight while it computes
// and stores.
template <int M, typename T, int V, int E>
__global__ void __launch_bounds__(kWarpThreads, kWarpBlocks)
    lut_softmax_warp_kernel(const T* __restrict__ x,
                            const int* __restrict__ lut_main,
                            const int* __restrict__ lut_aux,
                            float* __restrict__ out, int rows, int cols,
                            LutParams p) {
  constexpr int NV = E / V;
  constexpr bool kStage =
      sizeof(T) <= kPrefetchMaxBytes && V * sizeof(T) >= 4;
  extern __shared__ float tables[];
  p.method = M;  // a constant from here on: lutk::sigma_col folds
  copy_tables(tables, lut_main, lut_aux, p);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const float* aux = tables + 32 * p.n_main;
  const int nvec = cols / V;
  T* stage = reinterpret_cast<T*>(
      reinterpret_cast<unsigned char*>(tables) + round16(table_bytes(p)) +
      warp * round16(size_t(cols) * sizeof(T)));
  auto prefetch = [&](int r) {
    const T* xr = x + size_t(r) * cols;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (lane + 32 * i < nvec)
        cp_async<V * sizeof(T)>(stage + (lane + 32 * i) * V,
                                xr + (lane + 32 * i) * V);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  const int stride = gridDim.x * warps;
  int row = blockIdx.x * warps + warp;
  if (kStage && row < rows) prefetch(row);
  for (; row < rows; row += stride) {
    Vec<T, V> buf[NV];
    if constexpr (kStage) {
      // each lane reads back only what it copied itself
      asm volatile("cp.async.wait_group 0;" ::: "memory");
#pragma unroll
      for (int i = 0; i < NV; ++i)
        if (lane + 32 * i < nvec) buf[i].load(stage + (lane + 32 * i) * V);
    } else {
      const T* xr = x + size_t(row) * cols;
#pragma unroll
      for (int i = 0; i < NV; ++i)
        if (lane + 32 * i < nvec)
          buf[i].load_stream(xr + (lane + 32 * i) * V);
    }

    // the max over the finite entries
    float m = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (lane + 32 * i < nvec) {
        float f[V];
        buf[i].get(f);
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (isfinite(f[j])) m = fmaxf(m, f[j]);
      }
    }
    m = lutk::warp_max(m);
    if (!isfinite(m)) m = 0.f;
    // every value read from the buffer has been used: refill it
    if (kStage && row + stride < rows) prefetch(row + stride);

    // numerators (a hard 0 for a non-finite entry), kept in registers,
    // and their integer Σ
    float e[E];
    float S = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (lane + 32 * i < nvec) {
        float f[V];
        buf[i].get(f);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          e[i * V + j] = numerator<M>(f[j], m, tables, lane, p);
          S += e[i * V + j];
        }
      }
    }
    S = lutk::warp_sum(S);
    const RowSigma rs = row_sigma<M>(S, aux, p);

    float* outr = out + size_t(row) * cols;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (lane + 32 * i < nvec) {
        float w[V];
#pragma unroll
        for (int j = 0; j < V; ++j)
          w[j] = row_weight<M>(e[i * V + j], rs, aux, p);
        st_stream<V>(outr + (lane + 32 * i) * V, w);
      }
    }
  }
}

// mbarrier and TMA bulk-copy primitives (PTX ISA 8.0, sm_90).
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.b32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
// One thread: copy `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global src into shared dst, completing on bar.  The fence orders
// the CTA's earlier generic-proxy accesses of dst before the copy.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Shared memory of the CTA route before its row buffers: two mbarriers,
// two per-warp reduction arrays, the tables rounded up to 16 bytes.
// Python's row_plan mirrors it.
constexpr size_t kCtaHead = 16 + 2 * 32 * 4;
__host__ __device__ inline size_t cta_fixed_smem(const LutParams& p) {
  return kCtaHead + round16(table_bytes(p));
}

__device__ __forceinline__ float block_max(float x, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  x = lutk::warp_max(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float m = -CUDART_INF_F;
  for (int w = 0; w < int(blockDim.x >> 5); ++w) m = fmaxf(m, red[w]);
  return m;
}

__device__ __forceinline__ float block_sum(float x, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  x = lutk::warp_sum(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < int(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

// Route 1: a CTA a row, in three passes over the row — staged in shared
// memory by a bulk copy (stages 1 or 2 buffers), or re-read from global
// memory (stages 0).  The numerators are recomputed in pass 3 rather
// than written back, so a staged buffer is only ever read by the
// threads.
template <int M, typename T, int V>
__global__ void __launch_bounds__(kCtaThreads, kCtaBlocks)
    lut_softmax_cta_kernel(const T* __restrict__ x,
                           const int* __restrict__ lut_main,
                           const int* __restrict__ lut_aux,
                           float* __restrict__ out, int rows, int cols,
                           LutParams p, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* red_max = reinterpret_cast<float*>(smem + 16);
  float* red_sum = red_max + 32;
  float* tables = reinterpret_cast<float*>(smem + kCtaHead);
  T* buf0 = reinterpret_cast<T*>(smem + cta_fixed_smem(p));
  p.method = M;
  const int tid = threadIdx.x, nt = blockDim.x;
  const unsigned row_bytes = unsigned(cols) * sizeof(T);
  copy_tables(tables, lut_main, lut_aux, p);
  if (stages && tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bar + s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < stages; ++s) {
      const int r = blockIdx.x + s * gridDim.x;
      if (r < rows)
        bulk_copy(buf0 + size_t(s) * cols, x + size_t(r) * cols, row_bytes,
                  bar + s);
    }
  }
  __syncthreads();
  const int lane = tid & 31;
  const float* aux = tables + 32 * p.n_main;
  const int nvec = cols / V;
  int it = 0;
  for (int row = blockIdx.x; row < rows; row += gridDim.x, ++it) {
    const int s = stages ? it % stages : 0;
    const T* xr = x + size_t(row) * cols;
    if (stages) {
      mbar_wait(bar + s, unsigned(it / stages) & 1u);
      xr = buf0 + size_t(s) * cols;
    }
    float m = -CUDART_INF_F;
    for (int v = tid; v < nvec; v += nt) {
      Vec<T, V> c;
      c.load(xr + v * V);
      float f[V];
      c.get(f);
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (isfinite(f[j])) m = fmaxf(m, f[j]);
    }
    m = block_max(m, red_max);
    if (!isfinite(m)) m = 0.f;

    float S = 0.f;
    for (int v = tid; v < nvec; v += nt) {
      Vec<T, V> c;
      c.load(xr + v * V);
      float f[V];
      c.get(f);
#pragma unroll
      for (int j = 0; j < V; ++j) S += numerator<M>(f[j], m, tables, lane, p);
    }
    S = block_sum(S, red_sum);
    const RowSigma rs = row_sigma<M>(S, aux, p);

    float* outr = out + size_t(row) * cols;
    for (int v = tid; v < nvec; v += nt) {
      Vec<T, V> c;
      c.load(xr + v * V);
      float f[V], w[V];
      c.get(f);
#pragma unroll
      for (int j = 0; j < V; ++j)
        w[j] = row_weight<M>(numerator<M>(f[j], m, tables, lane, p), rs, aux,
                             p);
      st_stream<V>(outr + v * V, w);
    }
    if (stages) {
      __syncthreads();  // every thread is done with buffer s
      const int next = row + stages * gridDim.x;
      if (tid == 0 && next < rows)
        bulk_copy(buf0 + size_t(s) * cols, x + size_t(next) * cols,
                  row_bytes, bar + s);
    }
  }
}

// The host's launch plan (kernels/lut_softmax/lut_softmax.py: row_plan).
struct Plan {
  int route, vec, per_lane, stages, grid, threads, smem;
};

template <int M, typename T, int V, int E>
cudaError_t launch_warp(const void* x, const int* lut_main,
                        const int* lut_aux, float* out, int rows, int cols,
                        const LutParams& p, const Plan& plan,
                        cudaStream_t stream) {
  static int reserved = 0;
  auto kernel = lut_softmax_warp_kernel<M, T, V, E>;
  cudaError_t err = lutk::reserve_smem(kernel, plan.smem, reserved);
  if (err != cudaSuccess) return err;
  kernel<<<plan.grid, plan.threads, plan.smem, stream>>>(
      static_cast<const T*>(x), lut_main, lut_aux, out, rows, cols, p);
  return cudaGetLastError();
}

template <int M, typename T, int V>
cudaError_t launch_v(const void* x, const int* lut_main, const int* lut_aux,
                     float* out, int rows, int cols, const LutParams& p,
                     const Plan& plan, cudaStream_t stream) {
  if (plan.route == 1) {
    static int reserved = 0;
    auto kernel = lut_softmax_cta_kernel<M, T, V>;
    cudaError_t err = lutk::reserve_smem(kernel, plan.smem, reserved);
    if (err != cudaSuccess) return err;
    kernel<<<plan.grid, plan.threads, plan.smem, stream>>>(
        static_cast<const T*>(x), lut_main, lut_aux, out, rows, cols, p,
        plan.stages);
    return cudaGetLastError();
  }
  switch (plan.per_lane) {
    case 48:
      return launch_warp<M, T, V, 48>(x, lut_main, lut_aux, out, rows, cols,
                                      p, plan, stream);
    case 64:
      return launch_warp<M, T, V, 64>(x, lut_main, lut_aux, out, rows, cols,
                                      p, plan, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int M, typename T>
cudaError_t launch_t(const void* x, const int* lut_main, const int* lut_aux,
                     float* out, int rows, int cols, const LutParams& p,
                     const Plan& plan, cudaStream_t stream) {
  switch (plan.vec) {
    case 1:
      return launch_v<M, T, 1>(x, lut_main, lut_aux, out, rows, cols, p, plan,
                               stream);
    case 4:
      return launch_v<M, T, 4>(x, lut_main, lut_aux, out, rows, cols, p, plan,
                               stream);
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch_v<M, T, 8>(x, lut_main, lut_aux, out, rows, cols, p,
                                 plan, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

// Refuses a plan the kernels cannot run safely: a vector width the
// pointers or the row length do not allow (a misaligned vector access
// faults), a row past the register budget, a staged row that is not
// 16-byte aligned, too little or too much shared memory.
bool plan_fits(const Plan& pl, const void* x, const void* out, int esize,
               int cols, const LutParams& p) {
  const size_t in_bytes = size_t(pl.vec) * esize;
  const size_t out_align = pl.vec * 4 < 16 ? pl.vec * 4 : 16;
  if (!(pl.vec == 1 || pl.vec == 4 || (pl.vec == 8 && esize == 2)))
    return false;
  if (cols % pl.vec || reinterpret_cast<uintptr_t>(x) % in_bytes ||
      reinterpret_cast<uintptr_t>(out) % out_align)
    return false;
  if (pl.grid < 1 || pl.threads < 32 || pl.threads % 32 ||
      size_t(pl.smem) > kSmemLimit)
    return false;
  if (pl.route == 0)
    return pl.threads <= kWarpThreads && cols <= 32 * pl.per_lane &&
           size_t(pl.smem) >=
               round16(table_bytes(p)) +
                   (esize <= kPrefetchMaxBytes && in_bytes >= 4
                        ? size_t(pl.threads / 32) *
                              round16(size_t(cols) * esize)
                        : 0);
  if (pl.route != 1 || pl.threads > kCtaThreads || pl.stages < 0 ||
      pl.stages > 2)
    return false;
  if (pl.stages && in_bytes != 16) return false;
  return size_t(pl.smem) >=
         cta_fixed_smem(p) + size_t(pl.stages) * size_t(cols) * esize;
}

template <int M>
int run(const void* x, const void* lut_main, const void* lut_aux, void* out,
        int dtype, int rows, int cols, int n_main, int aux_rows, int aux_cols,
        int round_mode, float inv_step, float inv_q, float inv_ex,
        float inv_sum, const Plan& plan, void* stream) {
  const bool ok = rows >= 0 && cols >= 1 && n_main >= 1 && aux_rows >= 1 &&
                  aux_cols >= 1 && (M != lutk::kRexp || aux_rows == 1) &&
                  dtype >= 0 && dtype <= 2;
  if (!ok) return int(cudaErrorInvalidValue);
  lutk::LutParams p;
  p.n_main = n_main; p.aux_rows = aux_rows; p.aux_cols = aux_cols;
  p.method = M; p.round_mode = round_mode;
  p.inv_step = inv_step; p.inv_q = inv_q; p.inv_ex = inv_ex;
  p.inv_sum = inv_sum;
  if (!plan_fits(plan, x, out, dtype == 0 ? 4 : 2, cols, p))
    return int(cudaErrorInvalidValue);
  if (rows == 0) return int(cudaSuccess);
  const int* lm = static_cast<const int*>(lut_main);
  const int* la = static_cast<const int*>(lut_aux);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return int(launch_t<M, float>(x, lm, la, o, rows, cols, p, plan, s));
    case 1:
      return int(launch_t<M, __nv_bfloat16>(x, lm, la, o, rows, cols, p, plan,
                                            s));
    default:
      return int(launch_t<M, __half>(x, lm, la, o, rows, cols, p, plan, s));
  }
}

}  // namespace

// x (rows, cols) contiguous of dtype 0 = f32, 1 = bf16, 2 = f16; out
// (rows, cols) f32.  REXP: lut_main = LUT_1/e (n_main), lut_aux = LUT_α
// as one row (1, aux_cols); inv_q = 1/qmax.  2D-LUT: lut_main = LUT_exp,
// lut_aux = LUT_σ (aux_rows, aux_cols); inv_step, inv_q, inv_ex, inv_sum
// the f32 reciprocals of exp_step, qmax, qmax·scale_ex, qmax·scale_sum.
// round_mode 1 = round half to even, 0 = floor.  Then the plan: route
// (0 warp, 1 cta), vec (elements a vector: 1, 4 or 8), per_lane (the
// warp route's register bucket: 48 or 64), stages (the cta route's
// row buffers: 0, 1 or 2), grid, threads, smem (bytes).
extern "C" int lut_softmax_rexp_launch(
    const void* x, const void* lut_main, const void* lut_aux, void* out,
    int dtype, int rows, int cols, int n_main, int aux_rows, int aux_cols,
    int round_mode, float inv_step, float inv_q, float inv_ex, float inv_sum,
    int route, int vec, int per_lane, int stages, int grid, int threads,
    int smem, void* stream) {
  return run<lutk::kRexp>(x, lut_main, lut_aux, out, dtype, rows, cols,
                          n_main, aux_rows, aux_cols, round_mode, inv_step,
                          inv_q, inv_ex, inv_sum,
                          Plan{route, vec, per_lane, stages, grid, threads,
                               smem},
                          stream);
}

extern "C" int lut_softmax_lut2d_launch(
    const void* x, const void* lut_main, const void* lut_aux, void* out,
    int dtype, int rows, int cols, int n_main, int aux_rows, int aux_cols,
    int round_mode, float inv_step, float inv_q, float inv_ex, float inv_sum,
    int route, int vec, int per_lane, int stages, int grid, int threads,
    int smem, void* stream) {
  return run<lutk::kLut2d>(x, lut_main, lut_aux, out, dtype, rows, cols,
                           n_main, aux_rows, aux_cols, round_mode, inv_step,
                           inv_q, inv_ex, inv_sum,
                           Plan{route, vec, per_lane, stages, grid, threads,
                                smem},
                           stream);
}
