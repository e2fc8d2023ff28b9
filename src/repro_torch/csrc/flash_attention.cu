// Exact flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention_pallas of
// src/repro/kernels/flash_attention/flash_attention.py (its pallas_call
// over _flash_kernel): exact softmax attention in one pass over the keys
// with the online recurrence — a running row max m, a running sum l and
// an f32 accumulator rescaled by exp(m_prev − m_new) whenever the max
// moves.  q (B, H, Lq, D), k / v (B, KVH, Lk, D) of one type (f32, bf16
// or f16; query head h reads KV head h / (H / KVH)); out (B, H, Lq, D),
// m and l (B, H, Lq), all f32.  A runtime kv_len (one for every
// sequence, or one per sequence) marks the valid keys of a pre-allocated
// cache, as the JAX package's naive backend does: key j is valid iff
// j < kv_len (default Lk), and causal masking is right-aligned to it —
// key j is visible to query row i iff j ≤ i + (kv_len − Lq).  Keys at or
// past kv_len are never read.  A row with no visible key (also every
// row when Lq > kv_len pushes it before key 0) returns out 0, m = −inf,
// l = 0, as the TPU kernel does: m_safe = 0 and corr = 0 while m is
// −inf.
//
// What bounds it on the H100: operations.  Per (sequence, head) it does
// Lq · Lk · D multiply-adds for q·kᵀ and as many for p·V against
// (Lq + 2 Lk) · D elements read, halved for causal.  The reference's
// 2e-5 tolerance rules out TF32, and p is f32: with 16-bit inputs q·kᵀ
// and three 16-bit pieces of p·V may run on the tensor cores; with f32
// inputs both run on the CUDA cores.
//
// Two routes, chosen by the wrapper (kernels/flash_attention/
// flash_attention.py: flash_route) before the launch:
//
//   * "tiles" — bf16 and f16 inputs with D ≤ 128 (a multiple of 8): the
//     tensor-core tile engine of csrc/attn_tiles.cuh, 64 query rows a
//     block of 4 warps, the recurrence kept in registers (a thread owns
//     two rows; the tile's row max by quad shuffles, l as per-thread
//     partial sums added up once at the end).  q·kᵀ is a bf16 (f16)
//     tensor-core product, exact per product.  p is f32, so p·V splits
//     it into kPieces = 3 16-bit pieces p₁ + p₂ + p₃ (each the rounding
//     of what the earlier ones left), each one mma against the 16-bit V,
//     all summed in f32: p₁ + p₂ + p₃ carries p to a relative 2^-27 in
//     bf16, below f32's own rounding, where one piece (2^-9) would miss
//     the 2e-5 limit and two (2^-18) hold it with little margin (on an
//     H100, two pieces put out 9.1e-6 off the plain version on rows of
//     a few far-apart logits, three 9.5e-7: tools/tile_variants.py).
//     So p·V costs three tensor-core products and the kernel four in
//     all.  For f16, whose exponent range is narrow, p is scaled by 2^14
//     before the split (and the sum back by 2^-14, both exact), so that
//     p down to 2^-24 stays normal in the pieces.  expf (not __expf,
//     not exp2f) and the final IEEE division by max(l, 1e-30) as
//     before.  The returned m is the winning key's logit recomputed in
//     IEEE f32 in this kernel's head-dim order (ieee_logit, below).
//   * "simt" — f32 inputs and D > 128: the CUDA-core kernel below.  One
//     block of 256 threads per (b, h, tile of kBQ = 64 query rows) holds
//     its queries in shared memory as f32 and walks the keys in tiles of
//     BK (64 for D ≤ 64, 32 above), only as far as the causal mask lets
//     the tile's last row see.  Per key tile: K and V rows into shared
//     memory; each thread takes a 4 × BK/16 block of the logits (a
//     register tile, conflict-free through padded rows); four threads
//     per row update m, l and p = exp(s − m) with expf; each thread
//     rescales and accumulates a 4 × D/16 block of the output.  IEEE f32
//     throughout: fmaf products, expf, and the division by max(l, 1e-30).
#include <climits>

#include "attn_tiles.cuh"
#include "lut_pipeline.cuh"

namespace {

// kThreads, kBQ and the simt route's Tiles<DMAX>: launch_plan.h.
using flash::kBQ;
using flash::kThreads;
using flash::Tiles;

// The valid keys of one sequence: n = clamp(kv_len, 0, Lk) of them, and
// the causal offset off = kv_len − Lq that right-aligns the queries to
// the valid length (key j is visible to row i iff j < n and j ≤ i + off).
struct Valid {
  int n, off;
};
__device__ __forceinline__ Valid valid_keys(int kv_len, int Lk, int Lq) {
  kv_len = max(kv_len, 0);
  return {min(kv_len, Lk), kv_len - Lq};
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, float* __restrict__ out,
                           float* __restrict__ m_out,
                           float* __restrict__ l_out, int H, int KVH, int Lq,
                           int Lk, int D, int causal, float scale,
                           int kv_len, const int* __restrict__ kv_lens) {
  using Tl = Tiles<DMAX>;
  constexpr int BK = Tl::BK, QS = Tl::QS, SS = Tl::SS;
  constexpr int RPT = kBQ / 16;   // query rows of a thread
  constexpr int CPT = BK / 16;    // keys of a thread in the logits tile
  constexpr int DPT = DMAX / 16;  // head dims of a thread in the output
  constexpr int KPR = BK / 4;     // keys of a thread in the row pass
  extern __shared__ float smem[];
  float* q_s = smem;                  // kBQ × QS
  float* k_s = q_s + kBQ * QS;        // BK × QS
  float* v_s = k_s + BK * QS;         // BK × DMAX
  float* p_s = v_s + BK * DMAX;       // kBQ × SS: logits, then p
  float* m_s = p_s + kBQ * SS;        // kBQ running max
  float* l_s = m_s + kBQ;             // kBQ running sum
  float* c_s = l_s + kBQ;             // kBQ this tile's rescale

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kBQ;
  const int kvh = h / (H / KVH);
  const Valid val = valid_keys(kv_lens ? kv_lens[b] : kv_len, Lk, Lq);
  const int off = val.off;
  const size_t qrow0 = (size_t(b) * H + h) * Lq;
  const size_t krow0 = (size_t(b) * KVH + kvh) * Lk;

  for (int i = tid; i < kBQ * DMAX; i += kThreads) {
    const int r = i / DMAX, d = i % DMAX;
    q_s[r * QS + d] = row0 + r < Lq && d < D
                          ? lutk::to_f32(q[(qrow0 + row0 + r) * D + d])
                          : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = -CUDART_INF_F;
    l_s[tid] = 0.f;
  }
  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) acc[i][dd] = 0.f;

  // Keys past the tile's last row's causal limit are never read.
  const int last = min(row0 + kBQ, Lq) - 1;
  const int jend = causal ? min(val.n, max(0, last + off + 1)) : val.n;

  for (int k0 = 0; k0 < jend; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * DMAX; i += kThreads) {
      const int r = i / DMAX, d = i % DMAX, j = k0 + r;
      const bool in = j < jend && d < D;
      k_s[r * QS + d] = in ? lutk::to_f32(k[(krow0 + j) * D + d]) : 0.f;
      v_s[r * DMAX + d] = in ? lutk::to_f32(v[(krow0 + j) * D + d]) : 0.f;
    }
    __syncthreads();

    // Logits of rows ty + 16 i against keys tx + 16 c, masked to −inf.
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[i][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = q_s[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = k_s[(tx + 16 * c) * QS + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int r = ty + 16 * i, j = k0 + tx + 16 * c;
        const bool vis = j < val.n && (!causal || j <= row0 + r + off);
        p_s[r * SS + tx + 16 * c] = vis ? s[i][c] * scale : -CUDART_INF_F;
      }
    __syncthreads();

    // The online recurrence, four threads (one warp's lanes) per row.
    {
      const int r = tid >> 2, part = tid & 3;
      float* row = p_s + r * SS + part * KPR;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < KPR; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      float ls = 0.f;
#pragma unroll
      for (int c = 0; c < KPR; ++c) {
        const float p = isfinite(row[c]) ? expf(row[c] - m_safe) : 0.f;
        row[c] = p;
        ls += p;
      }
      ls += __shfl_xor_sync(0xffffffffu, ls, 1);
      ls += __shfl_xor_sync(0xffffffffu, ls, 2);  // every lane read m_prev
      if (part == 0) {
        const float corr = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.f;
        l_s[r] = l_s[r] * corr + ls;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc · corr + p · V for rows ty + 16 i, dims tx + 16 dd.
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) acc[i][dd] *= corr;
    }
    for (int c = 0; c < BK; ++c) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = p_s[(ty + 16 * i) * SS + c];
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) vv[dd] = v_s[c * DMAX + tx + 16 * dd];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int dd = 0; dd < DPT; ++dd)
          acc[i][dd] = fmaf(pv[i], vv[dd], acc[i][dd]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + 16 * i;
    if (row0 + r >= Lq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) {
      const int d = tx + 16 * dd;
      if (d < D) out[(qrow0 + row0 + r) * D + d] = __fdiv_rn(acc[i][dd], l);
    }
  }
  if (tid < kBQ && row0 + tid < Lq) {
    m_out[qrow0 + row0 + tid] = m_s[tid];
    l_out[qrow0 + row0 + tid] = l_s[tid];
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* m, void* l, int B, int H, int KVH, int Lq, int Lk,
                   int D, int causal, float scale, int kv_len,
                   const int* kv_lens, cudaStream_t stream) {
  const size_t smem = 4 * Tiles<DMAX>::floats;
  static int reserved = 0;
  auto kernel = flash_attention_kernel<T, DMAX>;
  cudaError_t err = lutk::reserve_smem(kernel, smem, reserved);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(out),
      static_cast<float*>(m), static_cast<float*>(l), H, KVH, Lq, Lk, D,
      causal, scale, kv_len, kv_lens);
  return cudaGetLastError();
}

// The tile route: a thread owns two rows of its warp's 16 (row_of).
constexpr int kPieces = 3;

// One logit (q·k) · scale in IEEE f32, summed in head-dim order with
// fmaf from 0 — the order of the CUDA-core route above.  The tile route
// returns its row max m this way, from the key the tensor-core logits
// found largest: a tensor-core sum is ordered otherwise (and truncates),
// which on a row whose largest logit is near 0 — a causal row that sees
// one key — moves m by more than 1e-5 of itself, about as far as the
// f32 sum in any order is from the exact value there.  out and l keep
// the tile's own m (they differ from it only by that roundoff).
// q and k are 16-byte aligned and D is a multiple of 8: the loads go 64
// elements at a time, all in flight before the first fmaf.
template <typename T>
__device__ float ieee_logit(const T* q, const T* k, int D, float scale) {
  float dot = 0.f;
  for (int d0 = 0; d0 < D; d0 += 64) {
    uint4 kc[8], qc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (d0 + c * 8 < D) {
        kc[c] = *reinterpret_cast<const uint4*>(k + d0 + c * 8);
        qc[c] = *reinterpret_cast<const uint4*>(q + d0 + c * 8);
      }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (d0 + c * 8 >= D) break;
      const T* qe = reinterpret_cast<const T*>(&qc[c]);
      const T* ke = reinterpret_cast<const T*>(&kc[c]);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dot = fmaf(lutk::to_f32(qe[e]), lutk::to_f32(ke[e]), dot);
    }
  }
  return __fmul_rn(dot, scale);
}

// At DH = 64 three blocks share an SM when a thread keeps to 168
// registers; uncapped it takes ~180 and two fit (0.43 against 0.37 ms
// at the Whisper encoder's shape on an H100, tools/tile_variants.py).
// At DH = 128 the accumulator alone takes 64 registers and a cap only
// spills.
template <typename T, int DH>
__global__ void __launch_bounds__(tiles::kThreads, DH <= 64 ? 3 : 1)
    flash_attention_tiles_kernel(const T* __restrict__ q,
                                 const T* __restrict__ k,
                                 const T* __restrict__ v,
                                 float* __restrict__ out,
                                 float* __restrict__ m_out,
                                 float* __restrict__ l_out, int H, int KVH,
                                 int Lq, int Lk, int D, int causal,
                                 float scale, int kv_len,
                                 const int* __restrict__ kv_lens) {
  using tiles::kBM;
  constexpr int kS = tiles::stride<DH>();
  // f16 pieces stay normal for p ≥ 2^-24 once p is scaled by 2^14
  constexpr float kPScale = std::is_same<T, __half>::value ? 16384.f : 1.f;
  extern __shared__ uint4 smem_t[];
  T* q_s = reinterpret_cast<T*>(smem_t);  // kBM × kS
  T* k_ring = q_s + kBM * kS;              // kStages × kBN × kS
  T* v_ring = k_ring + tiles::kStages * tiles::kBN * kS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kBM;
  const int kvh = h / (H / KVH);
  const Valid val = valid_keys(kv_lens ? kv_lens[b] : kv_len, Lk, Lq);
  const int off = val.off;
  const size_t qrow0 = (size_t(b) * H + h) * Lq;
  const size_t krow0 = (size_t(b) * KVH + kvh) * Lk;
  // keys past the block's last row's causal limit are never read
  const int last = min(row0 + kBM, Lq) - 1;
  const int jend = causal ? min(val.n, max(0, last + off + 1)) : val.n;

  tiles::load_tile<T, DH>(q_s, q + qrow0 * D, row0, Lq, D);
  tiles::cp_async_commit();
  tiles::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[DH / 16][4];
  tiles::load_q<DH>(qf, q_s, warp, lane);

  int lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int c = row0 + warp * 16 + tiles::row_of(lane, 2 * r);
    lim[r] = c < Lq ? (causal ? min(val.n, max(0, c + off + 1)) : val.n) : 0;
  }
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  float acc[DH / 8][4] = {};
  // this thread's largest logit of each row so far, and its key
  float own[2] = {-CUDART_INF_F, -CUDART_INF_F};
  int arg[2] = {0, 0};
  tiles::sweep<T, DH, true>(
      k + krow0 * D, v + krow0 * D, jend, D, k_ring, v_ring,
      [&](int k0, const T* k_s, const T* v_s) {
        float S[8][4];
        tiles::qk_tile<T, DH>(S, qf, k_s, lane);
        float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j = k0 + tiles::col_of(lane, nt, i);
            S[nt][i] = j < lim[i >> 1] ? __fmul_rn(S[nt][i], scale)
                                       : -CUDART_INF_F;
            mt[i >> 1] = fmaxf(mt[i >> 1], S[nt][i]);
            if (S[nt][i] > own[i >> 1]) {
              own[i >> 1] = S[nt][i];
              arg[i >> 1] = j;
            }
          }
        float corr[2], m_safe[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m[r], tiles::quad_max(mt[r]));
          m_safe[r] = isfinite(m_new) ? m_new : 0.f;
          corr[r] = isfinite(m[r]) ? expf(__fsub_rn(m[r], m_safe[r])) : 0.f;
          m[r] = m_new;
          l[r] = __fmul_rn(l[r], corr[r]);
        }
        // p = exp(s − m_safe), its row sums, and its pieces
        uint32_t P[kPieces][4][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float s = S[nt][i];
            const float e =
                isfinite(s) ? expf(__fsub_rn(s, m_safe[i >> 1])) : 0.f;
            l[i >> 1] = __fadd_rn(l[i >> 1], e);
            S[nt][i] = e * kPScale;
          }
        }
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // fragment register j of key chunk kc: n-tile 2kc + j/2,
            // elements (j%2)·2 and (j%2)·2 + 1
            const float* x = S[2 * kc + (j >> 1)] + (j & 1) * 2;
            float x0 = x[0], x1 = x[1];
#pragma unroll
            for (int piece = 0; piece < kPieces; ++piece) {
              P[piece][kc][j] = tiles::Op<T>::pack(x0, x1);
              const float2 got = tiles::Op<T>::unpack(P[piece][kc][j]);
              x0 = __fsub_rn(x0, got.x);  // exact: the rounding's residue
              x1 = __fsub_rn(x1, got.y);
            }
          }
        tiles::pv_tile<T, DH, kPieces>(
            acc, P, v_s, lane,
            [&](float a, float c, int i) { return fmaf(a, corr[i >> 1], c); });
      });

  float lr[2];
  int key[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int c = row0 + warp * 16 + tiles::row_of(lane, 2 * r);
    lr[r] = tiles::quad_sum(l[r]);
    // the first key that holds the row max
    key[r] = own[r] == m[r] ? arg[r] : INT_MAX;
    key[r] = min(key[r], __shfl_xor_sync(0xffffffffu, key[r], 1));
    key[r] = min(key[r], __shfl_xor_sync(0xffffffffu, key[r], 2));
    if (c >= Lq) continue;
    const float denom = __fmul_rn(fmaxf(lr[r], 1e-30f), kPScale);
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
      const int d = tiles::col_of(lane, nt, 0);
      if (d < D)
        *reinterpret_cast<float2*>(out + (qrow0 + c) * D + d) =
            make_float2(__fdiv_rn(acc[nt][2 * r], denom),
                        __fdiv_rn(acc[nt][2 * r + 1], denom));
    }
  }
  // m and l: lane 0 of a quad takes its first row, lane 1 its second
  const int r = lane & 3;
  const int c = row0 + warp * 16 + tiles::row_of(lane, 2 * r);
  if (r < 2 && c < Lq) {
    const float mr = r ? m[1] : m[0];
    m_out[qrow0 + c] =
        isfinite(mr) ? ieee_logit(q_s + (c - row0) * kS,
                                  k + (krow0 + (r ? key[1] : key[0])) * D, D,
                                  scale)
                     : mr;
    l_out[qrow0 + c] = r ? lr[1] : lr[0];
  }
}

template <typename T, int DH>
cudaError_t launch_tiles(const void* q, const void* k, const void* v,
                         void* out, void* m, void* l, int B, int H, int KVH,
                         int Lq, int Lk, int D, int causal, float scale,
                         int kv_len, const int* kv_lens, cudaStream_t stream) {
  const size_t smem = tiles::smem_bytes<DH>();
  static int reserved = 0;
  auto kernel = flash_attention_tiles_kernel<T, DH>;
  cudaError_t err = lutk::reserve_smem(kernel, smem, reserved);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + tiles::kBM - 1) / tiles::kBM, H, B);
  kernel<<<grid, tiles::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(out),
      static_cast<float*>(m), static_cast<float*>(l), H, KVH, Lq, Lk, D,
      causal, scale, kv_len, kv_lens);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_tiles(const void* q, const void* k, const void* v,
                           void* out, void* m, void* l, int B, int H,
                           int KVH, int Lq, int Lk, int D, int causal,
                           float scale, int kv_len, const int* kv_lens,
                           cudaStream_t s) {
  if (tiles::tile_dh(D) == 64)
    return launch_tiles<T, 64>(q, k, v, out, m, l, B, H, KVH, Lq, Lk, D,
                               causal, scale, kv_len, kv_lens, s);
  return launch_tiles<T, 128>(q, k, v, out, m, l, B, H, KVH, Lq, Lk, D,
                              causal, scale, kv_len, kv_lens, s);
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       void* out, void* m, void* l, int B, int H, int KVH,
                       int Lq, int Lk, int D, int causal, float scale,
                       int kv_len, const int* kv_lens, cudaStream_t s) {
  const int dmax = flash::dmax(D);
  if (dmax == 64)
    return launch<T, 64>(q, k, v, out, m, l, B, H, KVH, Lq, Lk, D, causal,
                         scale, kv_len, kv_lens, s);
  if (dmax == 128)
    return launch<T, 128>(q, k, v, out, m, l, B, H, KVH, Lq, Lk, D, causal,
                          scale, kv_len, kv_lens, s);
  return launch<T, 256>(q, k, v, out, m, l, B, H, KVH, Lq, Lk, D, causal,
                        scale, kv_len, kv_lens, s);
}

}  // namespace

// q (B, H, Lq, D), k / v (B, KVH, Lk, D), contiguous, of dtype 0 = f32,
// 1 = bf16, 2 = f16; out (B, H, Lq, D), m and l (B, H, Lq) f32.  route
// 0 = simt, 1 = tiles (bf16 / f16 with D ≤ 128, a multiple of 8, and
// 16-byte aligned tensors only).  The valid keys: kv_lens (B,) int32 on
// the device when it is not null, else kv_len for every sequence (Lk
// when the caller has no cache length).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* m,
                                      void* l, int dtype, int B, int H,
                                      int KVH, int Lq, int Lk, int D,
                                      int causal, int route, float scale,
                                      int kv_len, const void* kv_lens_ptr,
                                      void* stream) {
  const int* kv_lens = static_cast<const int*>(kv_lens_ptr);
  const bool ok = B >= 1 && KVH >= 1 && H % KVH == 0 && Lq >= 1 &&
                  Lk >= 1 && D >= 1 && D <= 256;
  const bool tiles_ok = (dtype == 1 || dtype == 2) && D <= 128 && D % 8 == 0;
  if (!ok || (route == 1 && !tiles_ok) || route < 0 || route > 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1)
    return dtype == 1
               ? int(dispatch_tiles<__nv_bfloat16>(q, k, v, out, m, l, B, H,
                                                   KVH, Lq, Lk, D, causal,
                                                   scale, kv_len, kv_lens, s))
               : int(dispatch_tiles<__half>(q, k, v, out, m, l, B, H, KVH,
                                            Lq, Lk, D, causal, scale, kv_len,
                                            kv_lens, s));
  switch (dtype) {
    case 0:
      return int(dispatch_d<float>(q, k, v, out, m, l, B, H, KVH, Lq, Lk, D,
                                   causal, scale, kv_len, kv_lens, s));
    case 1:
      return int(dispatch_d<__nv_bfloat16>(q, k, v, out, m, l, B, H, KVH, Lq,
                                           Lk, D, causal, scale, kv_len,
                                           kv_lens, s));
    case 2:
      return int(dispatch_d<__half>(q, k, v, out, m, l, B, H, KVH, Lq, Lk, D,
                                    causal, scale, kv_len, kv_lens, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The launch plan of a call (csrc/launch_plan.h; the host library
// csrc/launch_plan.cpp exports the same entry): in = route, B, H, Lq, D;
// out = plan::kOut int64 fields.
extern "C" int flash_attention_plan(const int* in, int n_in, long long* out,
                                    int n_out) {
  return plan::flash_entry(in, n_in, out, n_out);
}
