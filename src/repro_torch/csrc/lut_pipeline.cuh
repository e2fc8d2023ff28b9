// Shared LUT-softmax pipeline of the LUT-attention kernels (sm_90a);
// the row-wise LUT softmax (csrc/lut_softmax.cu), the paged kernels and
// the dense split route (csrc/paged_attn.cuh), and the dense tile and
// simt routes (csrc/lut_attention.cu) reuse its per-element helpers,
// loads and reductions.
//
// The counterpart of the JAX package's in-kernel helpers in
// src/repro/kernels/common.py (policy_e_terms, rexp_sigma,
// lut2d_sigma_int, kernel_lookup): the numerator of a logit given its
// row max, the weight table's column for a row's Σ, the integer weight
// of a numerator, REXP's fused α factor, and where a contiguous key row
// lives (DenseRows).
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

#include "launch_plan.h"

namespace lutk {

enum Method { kExact = 0, kRexp = 1, kLut2d = 2 };

// kWarps and kThreads (the split-key body's block): launch_plan.h.

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
