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
// the card's f32 operations per byte once Lq is in the hundreds; the
// q·k feeding the bins must be IEEE f32 (TF32 moves bins), so the least
// time is 4 · Lq · Lk · Dh · H · B operations over the 67 TFLOP/s of the
// CUDA cores.  A single-token query (cross-attention in a decode step)
// is bound by the bytes of K and V instead.
//
// What the design does about it: nothing clever yet — it is the simple
// kernel of csrc/lut_pipeline.cuh's row engine with DenseRows
// addressing.  One block per (sequence, query head, tile of kRows query
// rows; one row for Lq = 1) runs every pass for its rows; a lane takes
// a key's dot with all the tile's rows (queries broadcast from shared
// memory), so each K row is read once per tile per pass, and the
// tile's logits stay in shared memory when they fit, so q·k is computed
// once.  No tensor cores.
#include "lut_pipeline.cuh"

namespace {

constexpr int kRows = 8;

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
    if (p.C == 1)
      return p.fused ? launch<TQ, DPL, 1, true>(p, stream)
                     : launch<TQ, DPL, 1, false>(p, stream);
    return p.fused ? launch<TQ, DPL, kRows, true>(p, stream)
                   : launch<TQ, DPL, kRows, false>(p, stream);
  }
};

}  // namespace

// q (B, H, Lq, Dh), k / v (B, KVH, Lk, Dh), all of dtype 0 = f32 or
// 1 = bf16, contiguous; out (B, H, Lq, Dh) f32.  method 1 = REXP,
// 2 = 2D-LUT; fused (REXP only) takes the α form.
extern "C" int lut_attention_launch(
    const void* q, const void* k, const void* v, const void* lut_main,
    const void* lut_aux, void* out, int dtype, int B, int H, int KVH, int Lq,
    int Lk, int Dh, int kv_len, int causal, int fused, int n_main,
    int aux_rows, int aux_cols, int method, int round_mode, float scale,
    float inv_step, float inv_q, float inv_ex, float inv_sum, void* stream) {
  const bool ok = (method == lutk::kRexp || method == lutk::kLut2d) &&
                  (!fused || method == lutk::kRexp) && kv_len >= 0 &&
                  kv_len <= Lk && Lq >= 1 && KVH >= 1 && H % KVH == 0;
  if (!ok) return int(cudaErrorInvalidValue);
  lutk::Params p = lutk::make_params(
      q, k, v, nullptr, nullptr, nullptr, lut_main, lut_aux, out, B, H, KVH,
      Dh, /*n_pages=*/B * KVH, /*ps=*/Lk, /*mp=*/1, /*C=*/Lq, n_main,
      aux_rows, aux_cols, method, round_mode, scale, inv_step, inv_q, inv_ex,
      inv_sum);
  p.kv_len = kv_len;
  p.causal = causal;
  p.fused = fused;
  return int(lutk::dispatch<DenseLaunch>(p, dtype,
                                         static_cast<cudaStream_t>(stream)));
}
