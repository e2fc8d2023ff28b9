// Paged-prefill LUT attention for Hopper (sm_90a).
//
// Replaces the TPU kernel paged_prefill_attention of
// src/repro/kernels/lut_attention/paged_prefill.py (its three
// pallas_calls over _pf_rowmax_kernel, _pf_sum_kernel and
// _pf_weight_kernel, masked as in _chunk_logits).  A C-token prompt
// chunk, already scattered into the pool, attends causally to its
// sequence through the block table: key pos is visible to chunk row i
// iff pos < kv_lens[b] and pos <= q_start[b] + i.
//
// What bounds it on the H100: bytes at serving chunk sizes.  A block of
// kRows chunk rows reads each live K and V row once and does kRows · Dh
// multiply-adds per row read, still far below the card's ~295
// operations per byte; the least time is the live K+V bytes (plus the
// chunk's queries and outputs) over 3.35 TB/s.
//
// What the design does about it: one block per (slot, query head, tile
// of kRows chunk rows) runs all three passes; a lane loads a key row
// once and takes its dot with every row of the tile (queries broadcast
// from shared memory, no cross-lane reduction); it walks only the keys
// below the tile's last causal limit, and keeps the tile's logits, then
// numerators, in shared memory when they fit, so K is read once per
// pass only above that budget (the TPU kernel's recompute-per-pass
// scheme).
#include "lut_pipeline.cuh"

namespace {

constexpr int kRows = 8;

template <typename T, int DPL>
__global__ void __launch_bounds__(lutk::kThreads)
    paged_prefill_kernel(lutk::Params p, bool cached) {
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kRows;
  lutk::paged_rows<T, DPL, kRows>(p, b, h, row0, p.q_start[b], cached);
}

template <typename T, int DPL>
struct PrefillLaunch {
  static cudaError_t run(const lutk::Params& p, cudaStream_t stream) {
    bool cached = lutk::smem_bytes(p, kRows, true) <= lutk::kCacheSmemBudget;
    size_t smem = lutk::smem_bytes(p, kRows, cached);
    static int reserved = 0;
    cudaError_t err =
        lutk::reserve_smem(paged_prefill_kernel<T, DPL>, smem, reserved);
    if (err != cudaSuccess) return err;
    dim3 grid((p.C + kRows - 1) / kRows, p.H, p.B);
    paged_prefill_kernel<T, DPL><<<grid, lutk::kThreads, smem, stream>>>(
        p, cached);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" int paged_prefill_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* kv_lens, const void* q_start,
    const void* lut_main, const void* lut_aux, void* out, int dtype, int B,
    int H, int KVH, int Dh, int n_pages, int ps, int mp, int C, int n_main,
    int aux_rows, int aux_cols, int method, int round_mode, float scale,
    float inv_step, float inv_q, float inv_ex, float inv_sum, void* stream) {
  lutk::Params p = lutk::make_params(
      q, k_pages, v_pages, block_tables, kv_lens, q_start, lut_main, lut_aux,
      out, B, H, KVH, Dh, n_pages, ps, mp, C, n_main, aux_rows, aux_cols,
      method, round_mode, scale, inv_step, inv_q, inv_ex, inv_sum);
  return int(lutk::dispatch<PrefillLaunch>(p, dtype,
                                           static_cast<cudaStream_t>(stream)));
}
