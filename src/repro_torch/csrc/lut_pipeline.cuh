// Shared LUT-softmax pipeline of the LUT-attention kernels (sm_90a);
// the row-wise LUT softmax (csrc/lut_softmax.cu) and the paged kernels
// (csrc/paged_attn.cuh) reuse its per-element helpers, loads and
// reductions.
//
// The counterpart of the JAX package's in-kernel helpers in
// src/repro/kernels/common.py (policy_e_terms, rexp_sigma,
// lut2d_sigma_int, kernel_lookup) plus the three-pass row engine of the
// dense kernel's row route, which lut_attention.py spreads over several
// pallas_calls.  On the TPU the passes are separate calls because an
// accumulator only lives across a sequential grid axis; here one thread
// block runs all passes for its rows:
//
//   pass 1  s = q·k · scale for every visible key      → row max m
//   pass 2  e = numerator(s, m)                        → integer Σ
//   pass 3  w = weight(e, Σ), out += w · v
//
// or, for REXP's fused α form (lut_attention.py's _fused_sum_av_kernel,
// kFused), pass 1 and then one pass that accumulates Σ and U = Σ e·v
// together, with U · α(Σ)/qmax² as the epilogue.
//
// Where a key row lives is a policy (Rows): DenseRows reads it from a
// contiguous (B, KVH, Lk, Dh) tensor.
//
// Bit-exactness with core/lut_softmax.py (the reference semantics):
//   * every rounding step of the bin path is an explicit _rn intrinsic
//     (__fmul_rn / __fsub_rn), so nvcc cannot contract `m - dot*scale`
//     into one FMA, which would move bins;
//   * rintf (round half to even, like torch.round / jnp.round), never
//     roundf; floorf for index_mode="floor";
//   * divisions by table constants are multiplies by the f32 reciprocal
//     the host passes in (inv_scale); only exact's e / max(Σ, tiny) is
//     an IEEE division;
//   * Σ is an f32 sum of integers below 2^24, exact in any order;
//   * a masked key gives a hard 0, never the terminal LUT entry, and a
//     row max that is not finite becomes 0.
// Build without --use_fast_math.
//
// The loads take int8 rows too (Chunk<int8_t>, kQuantized): the paged
// kernels' int8 pools, one f32 scale per (page, token, KV head) row — the
// JAX package's _pg_*_kernel_int8 / _pf_*_kernel_int8 bodies.  An int8
// row is dequantized element by element, __fmul_rn(float(code), scale),
// before the q·k dot and before σ·V, exactly as dequantize_rows and the
// reference's _page_rows do; the scale is never folded out of the dot
// (scale · Σ q·code rounds differently and would move bins).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace lutk {

enum Method { kExact = 0, kRexp = 1, kLut2d = 2 };

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// V rows each warp keeps in flight in pass 3.
constexpr int kUnroll = 8;
// Shared memory a block may take with the logits cache; above it every
// pass recomputes q·k from the pages instead, as the TPU kernel does.
constexpr size_t kCacheSmemBudget = 96 * 1024;

// The fields the per-element LUT pipeline reads (clamp_bin, e_term,
// weight): the table sizes, the method, the bin mode and the f32
// reciprocal constants from the host.  The row-wise softmax kernel
// (csrc/lut_softmax.cu) passes just these; the attention kernels' Params
// extends them.
struct LutParams {
  int n_main, aux_rows, aux_cols, method, round_mode;
  float inv_step, inv_q, inv_ex, inv_sum;
};

struct Params : LutParams {
  const void* q;          // (B, H, C, Dh) TQ
  const void* k_pages;    // (n_pages, ps, KVH, Dh) TK
  const void* v_pages;
  const float* k_scales;  // (n_pages, ps, KVH) f32 — int8 pools only
  const float* v_scales;
  const int* block_tables;  // (B, mp)
  const int* kv_lens;       // (B,)
  const int* q_start;       // (B,) — prefill; nullptr for decode
  const int* lut_main;      // (n_main,)
  const int* lut_aux;       // (aux_rows, aux_cols)
  float* out;               // (B, H, C, Dh) f32
  int B, H, KVH, Dh, n_pages, ps, mp, C;
  int kv_len, causal, fused;  // dense kernel: valid keys of every
                              // sequence, causal mask, REXP's fused form
  float scale;
};

// Shared memory of one block serving R query rows of lut_rows: per-warp
// row offsets and weight tiles of 32 keys, q rows, per-warp partials, m
// and Σ, per-warp output partials, the tables, and (when `cached`) the
// R × (mp·ps) logits/numerators cache.
inline size_t smem_bytes(const Params& p, int R, bool cached) {
  size_t floats = size_t(kWarps) * R * 32 + size_t(R) * p.Dh +
                  size_t(kWarps) * R + 2 * size_t(R) +
                  size_t(kWarps) * R * p.Dh;
  if (cached) floats += size_t(R) * p.mp * p.ps;
  return 8 * size_t(kWarps) * 32 +
         4 * (floats + size_t(p.n_main) + size_t(p.aux_rows) * p.aux_cols);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return float(x); }

template <typename TK>
constexpr bool kQuantized = std::is_same<TK, int8_t>::value;

// Eight consecutive elements (16-byte aligned; 8-byte for int8) of a
// pool row or a query row, held packed in registers between the load and
// their use, so a lane can have a whole batch of loads in flight.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* src) {
    a = reinterpret_cast<const float4*>(src)[0];
    b = reinterpret_cast<const float4*>(src)[1];
  }
  __device__ __forceinline__ void get(float (&f)[8]) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* src) {
    u = *reinterpret_cast<const uint4*>(src);
  }
  __device__ __forceinline__ void get(float (&f)[8]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};

template <>
struct Chunk<int8_t> {
  uint2 u;  // eight int8 codes: an int8 row is only 8-byte aligned for
            // head dims that are not a multiple of 16
  __device__ __forceinline__ void load(const int8_t* src) {
    u = *reinterpret_cast<const uint2*>(src);
  }
  __device__ __forceinline__ void get(float (&f)[8]) const {
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = float(c[i]);
  }
};

// Clamped bin index, clamped while still a float (the same result as
// XLA's saturating float→int conversion followed by the clip).
__device__ __forceinline__ int clamp_bin(float v, int round_mode, int lo,
                                         int hi) {
  float r = round_mode ? rintf(v) : floorf(v);
  r = fminf(fmaxf(r, float(lo)), float(hi));
  return int(r);
}

// Integer numerator of one element given the row max m, for the LUT
// policies (policy_e_terms): LUT_1/e[bin(m − s)] (REXP) or
// LUT_exp[bin((m − s)/step)] (2D-LUT).  No branch, so that a kernel can
// keep many elements' table reads in flight: a masked key (s = −inf; or
// +inf, NaN) still clamps to a bin inside the table, and its numerator is
// then set to a hard 0, never the terminal LUT entry.
__device__ __forceinline__ float lut_e_term(float s, float m,
                                            const int* lut_main,
                                            const LutParams& p) {
  float d = __fsub_rn(m, s);
  d = p.method == kLut2d ? __fmul_rn(d, p.inv_step) : d;
  const float e = float(lut_main[clamp_bin(d, p.round_mode, 0, p.n_main - 1)]);
  return isfinite(s) ? e : 0.f;
}

// Numerator of one element given the row max m (policy_e_terms): exact's
// f32 exp(s − m), or the LUT policies' integer.
__device__ __forceinline__ float e_term(float s, float m, const int* lut_main,
                                        const LutParams& p) {
  if (p.method == kExact) return isfinite(s) ? expf(__fsub_rn(s, m)) : 0.f;
  return lut_e_term(s, m, lut_main, p);
}

// The column of the weight table that a row's global Σ selects: REXP's
// α index rnd(Σ/qmax), 2D-LUT's j(Σ); one per row, so a kernel may look
// it up once and pass it to sigma_int for every element of the row.
__device__ __forceinline__ int sigma_col(float S, const LutParams& p) {
  if (p.method == kRexp)
    return clamp_bin(__fmul_rn(S, p.inv_q), p.round_mode, 0, p.aux_cols - 1);
  return clamp_bin(__fmul_rn(S, p.inv_sum), p.round_mode, 1, p.aux_cols) - 1;
}

// Integer weight σ_int of one element given its numerator e and its row's
// sigma_col (REXP: rexp_sigma's round(e·α/qmax); 2D-LUT:
// lut2d_sigma_int's LUT_σ[i(e), j(Σ)]); an integer in [0, qmax], held
// exactly in f32 (and in bf16 for qmax ≤ 256).  One table read and no
// branch for either policy, as in lut_e_term.
__device__ __forceinline__ float sigma_int(float e, int col,
                                           const int* lut_aux,
                                           const LutParams& p) {
  const bool rexp = p.method == kRexp;
  const int i =
      clamp_bin(__fmul_rn(e, p.inv_ex), p.round_mode, 0, p.aux_rows - 1);
  const int a = lut_aux[rexp ? col : i * p.aux_cols + col];
  const float prod = float(int(e) * a);  // REXP: ≤ qmax² < 2^30
  return rexp ? rintf(__fmul_rn(prod, p.inv_q)) : float(a);
}

__device__ __forceinline__ float weight_int(float e, float S,
                                            const int* lut_aux,
                                            const LutParams& p) {
  return sigma_int(e, sigma_col(S, p), lut_aux, p);
}

// Weight of one element given its numerator e and the row's global Σ
// (exact: e/Σ; the LUT policies: weight_int dequantized by 1/qmax).
__device__ __forceinline__ float weight(float e, float S, const int* lut_aux,
                                        const LutParams& p) {
  if (p.method == kExact) return __fdiv_rn(e, fmaxf(S, 1.17549435e-38f));
  return __fmul_rn(weight_int(e, S, lut_aux, p), p.inv_q);
}

// REXP's fused epilogue factor α(Σ)·(1/qmax)·(1/qmax), α looked up at
// rnd(Σ/qmax): U = Σ e·v times it is the fused form's output.
__device__ __forceinline__ float alpha_factor(float S, const int* lut_aux,
                                              const LutParams& p) {
  const float alpha = float(lut_aux[sigma_col(S, p)]);
  return __fmul_rn(__fmul_rn(alpha, p.inv_q), p.inv_q);
}

// Where key j of sequence b, KV head kvh lives (the row's elements start
// at index · Dh), and how many keys of b are valid.
//
// DenseRows: row (b · KVH + kvh) · Lk + j of a contiguous
// (B, KVH, Lk, Dh) tensor, with Lk = mp · ps (mp = 1, ps = Lk); every
// sequence has the same valid length kv_len ≤ Lk.
struct DenseRows {
  static __device__ __forceinline__ size_t index(const Params& p, int b,
                                                 int kvh, int j) {
    return (size_t(b) * p.KVH + kvh) * (size_t(p.mp) * p.ps) + j;
  }
  static __device__ __forceinline__ int valid(const Params& p, int) {
    return max(min(p.kv_len, p.mp * p.ps), 0);
  }
};

// dot[r] = q_r · k for the R query rows in shared memory against one key
// row read by this lane alone: up to 8 chunks are loaded before the
// first is used (Dh ≤ 32·DPL, a multiple of 8).
template <typename T, int DPL, int R>
__device__ __forceinline__ void dot_rows(const T* krow, const float* q_s,
                                         int Dh, float (&dot)[R]) {
  constexpr int kChunks = DPL * 4;
  constexpr int kBatch = kChunks < 8 ? kChunks : 8;
#pragma unroll
  for (int r = 0; r < R; ++r) dot[r] = 0.f;
#pragma unroll
  for (int c0 = 0; c0 < kChunks; c0 += kBatch) {
    Chunk<T> ch[kBatch];
#pragma unroll
    for (int c = 0; c < kBatch; ++c)
      if ((c0 + c) * 8 < Dh) ch[c].load(krow + (c0 + c) * 8);
#pragma unroll
    for (int c = 0; c < kBatch; ++c) {
      const int d = (c0 + c) * 8;
      if (d >= Dh) break;
      float k[8];
      ch[c].get(k);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        Chunk<float> qc;
        qc.load(q_s + r * Dh + d);
        float q[8];
        qc.get(q);
#pragma unroll
        for (int e = 0; e < 8; ++e) dot[r] = fmaf(q[e], k[e], dot[r]);
      }
    }
  }
}

// Masked logits s_r = (q_r·k_j) · scale of this lane's key j; rows that
// do not see j (and lanes past the walk) get −inf.
template <typename Rows, typename T, int DPL, int R>
__device__ __forceinline__ void lane_logits(const Params& p, const T* k,
                                            const float* q_s, int b, int kvh,
                                            int j, bool live,
                                            const int (&lim)[R],
                                            float (&s)[R]) {
  float dot[R];
  if (live) dot_rows<T, DPL, R>(k + Rows::index(p, b, kvh, j) * p.Dh, q_s,
                                p.Dh, dot);
#pragma unroll
  for (int r = 0; r < R; ++r)
    s[r] = live && j < lim[r] ? __fmul_rn(dot[r], p.scale) : -CUDART_INF_F;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The passes for R query rows of (sequence b, query head h), rows
// row0 .. row0+R-1; queries of type TQ, key/value elements of type TK,
// rows found through Rows.  Row c sees key j iff j < kv_len and
// j <= q0 + c.  Only keys below the largest such limit are walked:
// pages past kv_len (null pages, a partial page's tail) or a cache's
// unwritten tail add an exact 0 in the reference and are never read
// here.
//
// The keys go in tiles of 32, one tile per warp at a time.  For q·k a
// lane owns one key of the tile and reads its whole row itself (16-byte
// loads, no cross-lane reduction); for σ·V the lanes split the head
// dimension and walk the tile's keys, kUnroll value rows in flight,
// reading the weights and row offsets the key lanes left in shared
// memory.
//
// kFused (REXP only): no Σ pass; the last pass weights each key by its
// integer numerator e, sums Σ beside U = Σ e·v, and the epilogue scales
// U by α(Σ)·(1/qmax)·(1/qmax), α looked up at rnd(Σ · 1/qmax).
template <typename TQ, typename TK, int DPL, int R, typename Rows,
          bool kFused = false>
__device__ void lut_rows(const Params& p, int b, int h, int row0, int q0,
                         bool cached) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kvh = h / (p.H / p.KVH);
  const int L = p.mp * p.ps;
  const int kv_len = Rows::valid(p, b);
  const TK* kp = static_cast<const TK*>(p.k_pages);
  const TK* vp = static_cast<const TK*>(p.v_pages);

  size_t* rowp_s = reinterpret_cast<size_t*>(smem4);  // kWarps × 32
  float* w_s = reinterpret_cast<float*>(rowp_s + kWarps * 32);  // kWarps×R×32
  float* q_s = w_s + kWarps * R * 32;      // R × Dh
  float* red_s = q_s + R * p.Dh;           // kWarps × R
  float* m_s = red_s + kWarps * R;         // R
  float* S_s = m_s + R;                    // R
  float* acc_s = S_s + R;                  // kWarps × R × Dh
  int* main_s = reinterpret_cast<int*>(acc_s + kWarps * R * p.Dh);
  int* aux_s = main_s + p.n_main;
  float* cache_s = reinterpret_cast<float*>(aux_s + p.aux_rows * p.aux_cols);

  const TQ* q = static_cast<const TQ*>(p.q);
  for (int i = tid; i < R * p.Dh; i += kThreads) {
    int r = i / p.Dh, c = row0 + r;
    q_s[i] = c < p.C
                 ? to_f32(q[((size_t(b) * p.H + h) * p.C + c) * p.Dh + i % p.Dh])
                 : 0.f;
  }
  for (int i = tid; i < p.n_main; i += kThreads) main_s[i] = p.lut_main[i];
  for (int i = tid; i < p.aux_rows * p.aux_cols; i += kThreads)
    aux_s[i] = p.lut_aux[i];

  int lim[R];
  int jmax = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    int c = row0 + r;
    lim[r] = c < p.C ? max(min(kv_len, q0 + c + 1), 0) : 0;
    jmax = max(jmax, lim[r]);
  }
  __syncthreads();

  // Pass 1: logits and the row max.
  float part[R];
#pragma unroll
  for (int r = 0; r < R; ++r) part[r] = -CUDART_INF_F;
  for (int t0 = warp * 32; t0 < jmax; t0 += kWarps * 32) {
    const int j = t0 + lane;
    const bool live = j < jmax;
    float s[R];
    lane_logits<Rows, TK, DPL, R>(p, kp, q_s, b, kvh, j, live, lim, s);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (cached && live) cache_s[r * L + j] = s[r];
      part[r] = fmaxf(part[r], s[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float m = warp_max(part[r]);
    if (lane == 0) red_s[warp * R + r] = m;
  }
  __syncthreads();
  if (tid < R) {
    float m = -CUDART_INF_F;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red_s[w * R + tid]);
    m_s[tid] = isfinite(m) ? m : 0.f;
  }
  __syncthreads();

  // Pass 2: numerators and their (integer, for the LUT policies) Σ.
  if (!kFused) {
#pragma unroll
    for (int r = 0; r < R; ++r) part[r] = 0.f;
    for (int t0 = warp * 32; t0 < jmax; t0 += kWarps * 32) {
      const int j = t0 + lane;
      const bool live = j < jmax;
      float s[R];
      if (cached) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          s[r] = live ? cache_s[r * L + j] : -CUDART_INF_F;
      } else {
        lane_logits<Rows, TK, DPL, R>(p, kp, q_s, b, kvh, j, live, lim, s);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float e = e_term(s[r], m_s[r], main_s, p);
        if (cached && live) cache_s[r * L + j] = e;
        part[r] += e;
      }
    }
    __syncthreads();  // red_s is reused below
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float S = warp_sum(part[r]);
      if (lane == 0) red_s[warp * R + r] = S;
    }
    __syncthreads();
    if (tid < R) {
      float S = 0.f;
      for (int w = 0; w < kWarps; ++w) S += red_s[w * R + tid];
      S_s[tid] = S;
    }
    __syncthreads();
  }

  // Pass 3: per-element weights times V (kFused: numerators times V,
  // and their Σ).
#pragma unroll
  for (int r = 0; r < R; ++r) part[r] = 0.f;
  float acc[R][DPL];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  float* w_tile = w_s + warp * R * 32;
  size_t* rowp = rowp_s + warp * 32;
  for (int t0 = warp * 32; t0 < jmax; t0 += kWarps * 32) {
    const int j = t0 + lane;
    const bool live = j < jmax;
    float e[R];
    if (cached && !kFused) {  // the cache holds numerators
#pragma unroll
      for (int r = 0; r < R; ++r) e[r] = live ? cache_s[r * L + j] : 0.f;
    } else {                  // the cache (if any) holds logits
      float s[R];
      if (cached) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          s[r] = live ? cache_s[r * L + j] : -CUDART_INF_F;
      } else {
        lane_logits<Rows, TK, DPL, R>(p, kp, q_s, b, kvh, j, live, lim, s);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) e[r] = e_term(s[r], m_s[r], main_s, p);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (kFused) part[r] += e[r];
      w_tile[r * 32 + lane] = kFused ? e[r] : weight(e[r], S_s[r], aux_s, p);
    }
    rowp[lane] = (live ? Rows::index(p, b, kvh, j) : 0) * p.Dh;
    __syncwarp();
    const int n = min(32, jmax - t0);
    for (int u0 = 0; u0 < n; u0 += kUnroll) {
      float v[kUnroll][DPL];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = min(u0 + u, n - 1);
        const TK* row = vp + rowp[t];
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          int d = i * 32 + lane;
          v[u][i] = u0 + u < n && d < p.Dh ? to_f32(row[d]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (u0 + u >= n) break;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float w = w_tile[r * 32 + u0 + u];
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(w, v[u][i], acc[r][i]);
        }
      }
    }
    __syncwarp();  // the next tile rewrites w_tile and rowp
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      int d = i * 32 + lane;
      if (d < p.Dh) acc_s[(warp * R + r) * p.Dh + d] = acc[r][i];
    }
  if (kFused) {  // Σ of the numerators → the epilogue's α·(1/qmax)²
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float S = warp_sum(part[r]);
      if (lane == 0) red_s[warp * R + r] = S;
    }
    __syncthreads();
    if (tid < R) {
      float S = 0.f;
      for (int w = 0; w < kWarps; ++w) S += red_s[w * R + tid];
      S_s[tid] = alpha_factor(S, aux_s, p);
    }
  }
  __syncthreads();
  for (int i = tid; i < R * p.Dh; i += kThreads) {
    int r = i / p.Dh, c = row0 + r;
    if (c >= p.C) continue;
    float o = 0.f;
    for (int w = 0; w < kWarps; ++w) o += acc_s[(w * R + r) * p.Dh + i % p.Dh];
    if (kFused) o = __fmul_rn(o, S_s[r]);
    p.out[((size_t(b) * p.H + h) * p.C + c) * p.Dh + i % p.Dh] = o;
  }
}

// Raise a kernel's dynamic shared-memory limit only when a launch needs
// more than it was last given (`reserved`, one per kernel instance): the
// attribute call costs host time on every launch otherwise.
template <typename Kernel>
inline cudaError_t reserve_smem(Kernel kernel, size_t bytes, int& reserved) {
  if (int(bytes) <= reserved) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err == cudaSuccess) reserved = int(bytes);
  return err;
}

// Instantiate `Launch<TQ, TK, DPL>` for the head dims the port serves
// (Dh ≤ 256, in steps of 32 lanes).
template <template <typename, typename, int> class Launch, typename TQ,
          typename TK>
inline cudaError_t dispatch_dh(const Params& p, cudaStream_t stream) {
  int dpl = (p.Dh + 31) / 32;
  if (dpl <= 1) return Launch<TQ, TK, 1>::run(p, stream);
  if (dpl <= 2) return Launch<TQ, TK, 2>::run(p, stream);
  if (dpl <= 4) return Launch<TQ, TK, 4>::run(p, stream);
  if (dpl <= 8) return Launch<TQ, TK, 8>::run(p, stream);
  return cudaErrorInvalidValue;
}

// Inputs of one float type; dtype 0 = f32, 1 = bf16.
template <template <typename, typename, int> class Launch>
inline cudaError_t dispatch(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 0) return dispatch_dh<Launch, float, float>(p, stream);
  if (dtype == 1)
    return dispatch_dh<Launch, __nv_bfloat16, __nv_bfloat16>(p, stream);
  return cudaErrorInvalidValue;
}

// The host C interface the kernels share: everything the Python
// wrapper passes, as plain pointers, ints and floats (the scale pools
// only for an int8 pool; a dense kernel passes no block tables, no
// cursors, and sets kv_len itself).
inline Params make_params(const void* q, const void* k_pages,
                          const void* v_pages, const void* block_tables,
                          const void* kv_lens, const void* q_start,
                          const void* lut_main, const void* lut_aux,
                          void* out, int B, int H, int KVH, int Dh,
                          int n_pages, int ps, int mp, int C, int n_main,
                          int aux_rows, int aux_cols, int method,
                          int round_mode, float scale, float inv_step,
                          float inv_q, float inv_ex, float inv_sum,
                          const void* k_scales = nullptr,
                          const void* v_scales = nullptr) {
  Params p;
  p.q = q;
  p.k_pages = k_pages;
  p.v_pages = v_pages;
  p.k_scales = static_cast<const float*>(k_scales);
  p.v_scales = static_cast<const float*>(v_scales);
  p.block_tables = static_cast<const int*>(block_tables);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.q_start = static_cast<const int*>(q_start);
  p.lut_main = static_cast<const int*>(lut_main);
  p.lut_aux = static_cast<const int*>(lut_aux);
  p.out = static_cast<float*>(out);
  p.B = B; p.H = H; p.KVH = KVH; p.Dh = Dh;
  p.n_pages = n_pages; p.ps = ps; p.mp = mp; p.C = C;
  p.n_main = n_main; p.aux_rows = aux_rows; p.aux_cols = aux_cols;
  p.method = method; p.round_mode = round_mode;
  p.kv_len = 0; p.causal = 0; p.fused = 0;
  p.scale = scale; p.inv_step = inv_step; p.inv_q = inv_q;
  p.inv_ex = inv_ex; p.inv_sum = inv_sum;
  return p;
}

}  // namespace lutk
