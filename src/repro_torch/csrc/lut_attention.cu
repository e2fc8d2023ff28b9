// Dense LUT attention for Hopper (sm_90a).
//
// Replaces the TPU kernel lut_attention_pallas of
// src/repro/kernels/lut_attention/lut_attention.py: its pallas_calls
// over _rowmax_kernel and _sum_kernel (the shared passes), then
// _rexp_av_kernel or _lut2d_av_kernel (faithful per-element σ·V), or
// _fused_sum_av_kernel (REXP's fused α form: Σ and U = Σ e·v together,
// U · α(Σ)/qmax² as the epilogue).  q (B, H, Lq, Dh) attends to
// contiguous k, v (B, KVH, Lk, Dh) of its own type (f32 or bf16; query
// head h reads KV head h / (H / KVH)); the output is f32.  A runtime
// kv_len ≤ Lk masks the unwritten tail of a pre-allocated cache: key j
// is visible to query row i iff j < kv_len and, if causal,
// j ≤ i + (kv_len − Lq) — queries right-aligned to the valid length, as
// the TPU kernel aligns them to lk_valid − lq.  Without a cache
// kv_len = Lk.
//
// What bounds it on the H100: operations at the encoder's shapes.  Per
// (sequence, query head) the work is Lq · Lk · Dh multiply-adds for q·k
// and as many for σ·V against (Lq + 2 Lk) · Dh elements read, far above
// the card's operations per byte once Lq is in the hundreds, plus some
// ten CUDA-core operations per (row, key) pair for the bins and lookups.
// For f32 inputs q·k must be IEEE f32 (TF32 rounds the inputs and moves
// bins), so the CUDA cores' 67 TFLOP/s bound it; for bf16 inputs each
// product is exact in f32 and the tensor cores may take both products.
// A single-token query (cross-attention in a decode step) is bound by
// the bytes of K and V instead: at Whisper's decode step (B = 4, 12
// heads of 64, 1500 keys, bf16) 18.4 MB, 0.0055 ms at 3.35 TB/s.
//
// Three routes, chosen by the wrapper (kernels/lut_attention/
// lut_attention.py: dense_route) before the launch:
//
//   * "split" — fewer than MIN_TILE_ROWS query rows (decode steps, short
//     prefill chunks), any type, head dim and precision: the Hopper
//     design of the paged kernels (csrc/paged_attn.cuh) over contiguous
//     keys, as lut_attention_split_kernel.  A cluster of up to 8 CTAs
//     serves one (sequence, KV head, block of the KV head's G·Lq query
//     rows): K and V are read once per KV head, whatever the GQA group;
//     the keys are split across the CTAs in 32-key tiles and, when the
//     block has fewer rows than warps (Whisper's MHA decode step has
//     one), across the warps too; K and V stream through a cp.async ring,
//     and the CTAs exchange the row max, Σ and the σ·V partials through
//     distributed shared memory.  The fused α form skips the Σ pass: its
//     last pass sums Σ beside U = Σ e·v and the cluster exchanges both in
//     one round.  The launcher (paged::plan_dense) picks the split, the
//     warps' key slices, the ring and the logits cache from the shapes
//     and kv_len, and refuses a plan past 227 KB a CTA;
//   * "tiles" — bf16 inputs, Dh ≤ 128, qmax ≤ 255 and at least
//     MIN_TILE_ROWS query rows: the tensor-core tile engine of
//     csrc/attn_tiles.cuh.  A block of 4 warps owns 64 query rows.
//     Fused REXP takes two sweeps over the keys (S = q·kᵀ and the row
//     max; then S again by the same products, bit for bit, e_int from
//     the shared bin path, Σ by quad shuffles and U += e_int·V on the
//     tensor cores), the faithful forms three (max; Σ; σ_int·V); the
//     numerators e_int and σ_int are integers ≤ qmax ≤ 255, exact in
//     bf16, so σ·V is an exact-product tensor-core sum, dequantized once
//     in the epilogue (× α(Σ)/qmax² fused, × 1/qmax faithful, as the JAX
//     _dequant does).  S is recomputed in every sweep rather than kept:
//     at Lk = 1500 a 64-row block's logits take 375 KB, more than a
//     block's shared memory, and a recomputed tile costs no more
//     products than its σ·V.  The per-element bin path has no branch
//     (lut_e_term, sigma_int), so the 32 table reads of a thread's tile
//     are in flight together: that path, not the tensor cores, set
//     this route's time.
//   * "rows" — the many-row calls the tile engine does not take (f32,
//     int16 tables whose numerators bf16 does not hold, Dh > 128): the
//     row engine of csrc/lut_pipeline.cuh with DenseRows addressing.  One
//     block per (sequence, query head, tile of lutk::kDenseRows query
//     rows; one row for Lq = 1) runs every pass for its rows; a lane takes
//     a key's dot with all the tile's rows (queries broadcast from shared
//     memory), so
//     each K row is read once per tile per pass, and the tile's logits
//     stay in shared memory when they fit, so q·k is computed once.
//
// The routes share the bin path (lut_pipeline.cuh's lut_e_term,
// clamp_bin, sigma_int, alpha_factor), so for the same logits they pick
// the same bins; their q·k sums are ordered differently (and a tensor
// core's f32 sum truncates), so a logit on a bin edge may land in the
// neighbouring bin, as against the plain version's cuBLAS order.  The
// rows and split routes compute a logit by the same chain (fmaf from 0
// in head-dim order).
#include "attn_tiles.cuh"
#include "lut_pipeline.cuh"
#include "paged_attn.cuh"

namespace {

template <typename TQ, int DPL, int R, bool kFused>
__global__ void __launch_bounds__(lutk::kThreads)
    lut_attention_kernel(lutk::Params p, bool cached) {
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * R;
  const int kv_len = lutk::DenseRows::valid(p, b);
  // causal rows sit at the last C of the kv_len valid positions; a
  // non-causal row sees every valid key
  const int q0 = p.causal ? kv_len - p.C : kv_len;
  lutk::lut_rows<TQ, TQ, DPL, R, lutk::DenseRows, kFused>(p, b, h, row0, q0,
                                                         cached);
}

template <typename TQ, int DPL, int R, bool kFused>
cudaError_t launch(const lutk::Params& p, cudaStream_t stream) {
  const bool cached = lutk::smem_bytes(p, R, true) <= lutk::kCacheSmemBudget;
  const size_t smem = lutk::smem_bytes(p, R, cached);
  static int reserved = 0;
  auto kernel = lut_attention_kernel<TQ, DPL, R, kFused>;
  cudaError_t err = lutk::reserve_smem(kernel, smem, reserved);
  if (err != cudaSuccess) return err;
  dim3 grid((p.C + R - 1) / R, p.H, p.B);
  kernel<<<grid, lutk::kThreads, smem, stream>>>(p, cached);
  return cudaGetLastError();
}

// The pipeline's dispatch fixes (TQ, TK = TQ, DPL); here a single query
// row takes the one-row tile, and p.fused REXP's fused form.
template <typename TQ, typename TK, int DPL>
struct DenseLaunch {
  static cudaError_t run(const lutk::Params& p, cudaStream_t stream) {
    if (lutk::dense_rows(p.C) == 1)
      return p.fused ? launch<TQ, DPL, 1, true>(p, stream)
                     : launch<TQ, DPL, 1, false>(p, stream);
    constexpr int R = lutk::kDenseRows;
    return p.fused ? launch<TQ, DPL, R, true>(p, stream)
                   : launch<TQ, DPL, R, false>(p, stream);
  }
};


// The tile route.  A thread holds two rows of its warp's 16 (row_of) and,
// per key tile, 32 logits of them.
template <typename T, int DH, bool kFused>
__global__ void __launch_bounds__(tiles::kThreads)
    lut_attention_tiles_kernel(lutk::Params p) {
  using tiles::kBM;
  using tiles::kBN;
  constexpr int kS = tiles::stride<DH>();
  extern __shared__ uint4 smem_t[];
  T* q_s = reinterpret_cast<T*>(smem_t);  // kBM × kS
  T* k_ring = q_s + kBM * kS;              // kStages × kBN × kS
  T* v_ring = k_ring + tiles::kStages * kBN * kS;
  int* main_s = reinterpret_cast<int*>(v_ring + tiles::kStages * kBN * kS);
  int* aux_s = main_s + p.n_main;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kBM;
  const int kvh = h / (p.H / p.KVH);
  const int Lk = p.ps, Dh = p.Dh, C = p.C;
  const int kv_len = lutk::DenseRows::valid(p, b);
  const int q0 = p.causal ? kv_len - C : kv_len;
  const int last = min(row0 + kBM, C) - 1;
  const int jmax = max(min(kv_len, q0 + last + 1), 0);
  const T* q = static_cast<const T*>(p.q) + ((size_t(b) * p.H + h) * C) * Dh;
  const T* kg = static_cast<const T*>(p.k_pages) +
                (size_t(b) * p.KVH + kvh) * size_t(Lk) * Dh;
  const T* vg = static_cast<const T*>(p.v_pages) +
                (size_t(b) * p.KVH + kvh) * size_t(Lk) * Dh;

  tiles::load_tile<T, DH>(q_s, q, row0, C, Dh);
  tiles::cp_async_commit();
  for (int i = tid; i < p.n_main; i += tiles::kThreads)
    main_s[i] = p.lut_main[i];
  for (int i = tid; i < p.aux_rows * p.aux_cols; i += tiles::kThreads)
    aux_s[i] = p.lut_aux[i];
  tiles::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[DH / 16][4];
  tiles::load_q<DH>(qf, q_s, warp, lane);

  // key j is visible to row r iff j < lim[r]
  int lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int c = row0 + warp * 16 + tiles::row_of(lane, 2 * r);
    lim[r] = c < C ? max(min(kv_len, q0 + c + 1), 0) : 0;
  }
  // masked logits of one key tile: s = (q·k) · scale, or −inf
  auto logits = [&](float (&S)[8][4], int k0, const T* k_s) {
    tiles::qk_tile<T, DH>(S, qf, k_s, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        S[nt][i] = k0 + tiles::col_of(lane, nt, i) < lim[i >> 1]
                       ? __fmul_rn(S[nt][i], p.scale)
                       : -CUDART_INF_F;
  };

  // Sweep 1: the row max.
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  tiles::sweep<T, DH, false>(kg, vg, jmax, Dh, k_ring, v_ring,
                             [&](int k0, const T* k_s, const T*) {
    float S[8][4];
    logits(S, k0, k_s);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) m[i >> 1] = fmaxf(m[i >> 1], S[nt][i]);
  });
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = tiles::quad_max(m[r]);
    if (!isfinite(m[r])) m[r] = 0.f;
  }

  // Sweep 2 (faithful forms): the integer Σ, then each row's column of
  // the weight table.
  float S_row[2] = {0.f, 0.f};
  int col[2] = {0, 0};
  if (!kFused) {
    tiles::sweep<T, DH, false>(kg, vg, jmax, Dh, k_ring, v_ring,
                               [&](int k0, const T* k_s, const T*) {
      float S[8][4];
      logits(S, k0, k_s);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          S_row[i >> 1] +=
              lutk::lut_e_term(S[nt][i], m[i >> 1], main_s, p);
    });
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      S_row[r] = tiles::quad_sum(S_row[r]);
      col[r] = lutk::sigma_col(S_row[r], p);
    }
  }

  // Last sweep: integer weights (fused: the numerators, and their Σ)
  // times V on the tensor cores.
  float acc[DH / 8][4] = {};
  tiles::sweep<T, DH, true>(kg, vg, jmax, Dh, k_ring, v_ring,
                            [&](int k0, const T* k_s, const T* v_s) {
    float S[8][4];
    logits(S, k0, k_s);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const float e = lutk::lut_e_term(S[nt][i], m[r], main_s, p);
        if (kFused) S_row[r] += e;
        S[nt][i] = kFused ? e : lutk::sigma_int(e, col[r], aux_s, p);
      }
    uint32_t P[1][4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) tiles::pack_a<T>(P[0][kc], S, kc);
    tiles::pv_tile<T, DH, 1>(acc, P, v_s, lane,
                             [](float a, float c, int) { return a + c; });
  });

  float factor[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    factor[r] = kFused ? lutk::alpha_factor(tiles::quad_sum(S_row[r]), aux_s,
                                            p)
                       : p.inv_q;
  float* out = p.out + ((size_t(b) * p.H + h) * C) * Dh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int c = row0 + warp * 16 + tiles::row_of(lane, 2 * r);
    if (c >= C) continue;
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
      const int d = tiles::col_of(lane, nt, 0);
      if (d < Dh)
        *reinterpret_cast<float2*>(out + size_t(c) * Dh + d) =
            make_float2(__fmul_rn(acc[nt][2 * r], factor[r]),
                        __fmul_rn(acc[nt][2 * r + 1], factor[r]));
    }
  }
}

template <int DH, bool kFused>
cudaError_t launch_tiles(const lutk::Params& p, cudaStream_t stream) {
  const size_t smem = tiles::lut_smem<DH>(p);
  static int reserved = 0;
  auto kernel = lut_attention_tiles_kernel<__nv_bfloat16, DH, kFused>;
  cudaError_t err = lutk::reserve_smem(kernel, smem, reserved);
  if (err != cudaSuccess) return err;
  dim3 grid((p.C + tiles::kBM - 1) / tiles::kBM, p.H, p.B);
  kernel<<<grid, tiles::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_tiles(const lutk::Params& p, cudaStream_t stream) {
  if (tiles::tile_dh(p.Dh) == 64)
    return p.fused ? launch_tiles<64, true>(p, stream)
                   : launch_tiles<64, false>(p, stream);
  return p.fused ? launch_tiles<128, true>(p, stream)
                 : launch_tiles<128, false>(p, stream);
}

}  // namespace

// q (B, H, Lq, Dh), k / v (B, KVH, Lk, Dh), all of dtype 0 = f32 or
// 1 = bf16, contiguous; out (B, H, Lq, Dh) f32.  method 1 = REXP,
// 2 = 2D-LUT; fused (REXP only) takes the α form; route 0 = rows,
// 1 = tiles (bf16, Dh ≤ 128 only), 2 = split.
extern "C" int lut_attention_launch(
    const void* q, const void* k, const void* v, const void* lut_main,
    const void* lut_aux, void* out, int dtype, int B, int H, int KVH, int Lq,
    int Lk, int Dh, int kv_len, int causal, int fused, int route, int n_main,
    int aux_rows, int aux_cols, int method, int round_mode, float scale,
    float inv_step, float inv_q, float inv_ex, float inv_sum, void* stream) {
  const bool ok = (method == lutk::kRexp || method == lutk::kLut2d) &&
                  (!fused || method == lutk::kRexp) && kv_len >= 0 &&
                  kv_len <= Lk && Lq >= 1 && KVH >= 1 && H % KVH == 0;
  // the tile route takes bf16 with Dh ≤ 128 (a multiple of 8) only; the
  // wrapper has checked qmax ≤ 255 against its tables
  const bool tiles_ok = dtype == 1 && Dh <= 128 && Dh % 8 == 0;
  if (!ok || (route == 1 && !tiles_ok) || route < 0 || route > 2)
    return int(cudaErrorInvalidValue);
  lutk::Params p = lutk::make_params(
      q, k, v, nullptr, nullptr, nullptr, lut_main, lut_aux, out, B, H, KVH,
      Dh, /*n_pages=*/B * KVH, /*ps=*/Lk, /*mp=*/1, /*C=*/Lq, n_main,
      aux_rows, aux_cols, method, round_mode, scale, inv_step, inv_q, inv_ex,
      inv_sum);
  p.kv_len = kv_len;
  p.causal = causal;
  p.fused = fused;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) return int(dispatch_tiles(p, s));
  // the split plan follows the valid length, known here exactly (an
  // empty cache is planned as one key: its rows come out 0)
  if (route == 2)
    return int(paged::run<paged::DenseKeys>(
        p, paged::kSplitRows, kv_len > 0 ? kv_len : 1, 0, dtype, s));
  return int(lutk::dispatch<DenseLaunch>(p, dtype, s));
}

// The launch plan of a call (csrc/launch_plan.h; the host library
// csrc/launch_plan.cpp exports the same entry): in = route, dtype, B, H,
// KVH, Lq, Lk, Dh, kv_len, fused, n_main, aux_rows, aux_cols, n_sms; out
// = plan::kOut int64 fields.
extern "C" int lut_attention_plan(const int* in, int n_in, long long* out,
                                  int n_out) {
  return plan::dense_entry(in, n_in, out, n_out);
}

// The split route's instance a plan's call launches (paged::attrs_entry):
// in = the `lut_attention_plan` ints (route 2); out = registers, local
// (spill) bytes a thread, CTAs a multiprocessor holds at the plan's
// threads and shared memory.
extern "C" int lut_attention_attrs(const int* in, int n_in, int* out,
                                   int n_out) {
  return paged::attrs_entry<paged::DenseKeys>(paged::kSplitRows, in, n_in,
                                              out, n_out);
}
