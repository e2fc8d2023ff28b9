// Paged-decode LUT attention for Hopper (sm_90a).
//
// Replaces the TPU kernel paged_decode_attention of
// src/repro/kernels/lut_attention/paged_decode.py (its three
// pallas_calls over _pg_rowmax_kernel, _pg_sum_kernel and
// _pg_weight_kernel), and, through the entry point
// paged_decode_int8_launch, their int8-pool bodies _pg_rowmax_kernel_int8,
// _pg_sum_kernel_int8 and _pg_weight_kernel_int8 (pages int8, one f32
// scale per token × KV head, dequantized row by row as in _page_rows).  One single-token query per slot attends to its
// own sequence, read page by page from the shared pool
// (n_pages, page_size, KVH, Dh) through the slot's block table; the
// softmax is exact, REXP or 2D-LUT (csrc/lut_pipeline.cuh).
//
// What bounds it on the H100: bytes.  Per (slot, query head) the block
// does O(kv_len · Dh) multiply-adds against O(kv_len · Dh) bytes of K and
// V, far below the ~295 operations per byte where the card turns
// compute-bound; the least time is the live K+V bytes over 3.35 TB/s —
// for an int8 pool a quarter of the f32 bytes plus 8 bytes of scales
// per (token, KV head), about half the bf16 bytes at Dh = 128.
//
// What the design does about it: one block per (slot, query head) runs
// all three passes itself, so m and Σ never leave the block; it walks
// only the ceil(kv_len / page_size) live pages (the TPU grid visits
// every block-table entry, null pages included), and keeps the row's
// logits, then its numerators, in shared memory so passes 2 and 3 read
// no K again: K and V are each read once from device memory per query
// head.  Each warp takes 32 keys at a time: for q·k every lane reads its
// own key row with 16-byte loads (no cross-lane reduction), for σ·V the
// lanes split the head dimension with eight value rows in flight, so the
// walk is bound by bandwidth rather than by one load's latency per key.
// The G = H / KVH query heads of one KV head read the same pages, mostly
// out of L2.  Rows longer than the shared-memory budget recompute q·k in
// every pass instead.
#include "lut_pipeline.cuh"

namespace {

template <typename TQ, typename TK, int DPL>
__global__ void __launch_bounds__(lutk::kThreads)
    paged_decode_kernel(lutk::Params p, bool cached) {
  const int b = blockIdx.y, h = blockIdx.x;
  // the query sits at position kv_len − 1: it sees every key < kv_len
  const int q0 = min(p.kv_lens[b], p.mp * p.ps) - 1;
  lutk::lut_rows<TQ, TK, DPL, 1, lutk::PagedRows>(p, b, h, 0, q0, cached);
}

template <typename TQ, typename TK, int DPL>
struct DecodeLaunch {
  static cudaError_t run(const lutk::Params& p, cudaStream_t stream) {
    bool cached = lutk::smem_bytes(p, 1, true) <= lutk::kCacheSmemBudget;
    size_t smem = lutk::smem_bytes(p, 1, cached);
    static int reserved = 0;
    cudaError_t err = lutk::reserve_smem(paged_decode_kernel<TQ, TK, DPL>,
                                         smem, reserved);
    if (err != cudaSuccess) return err;
    dim3 grid(p.H, p.B);
    paged_decode_kernel<TQ, TK, DPL><<<grid, lutk::kThreads, smem, stream>>>(
        p, cached);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" int paged_decode_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* kv_lens, const void* lut_main,
    const void* lut_aux, void* out, int dtype, int B, int H, int KVH, int Dh,
    int n_pages, int ps, int mp, int n_main, int aux_rows, int aux_cols,
    int method, int round_mode, float scale, float inv_step, float inv_q,
    float inv_ex, float inv_sum, void* stream) {
  lutk::Params p = lutk::make_params(
      q, k_pages, v_pages, block_tables, kv_lens, nullptr, lut_main, lut_aux,
      out, B, H, KVH, Dh, n_pages, ps, mp, /*C=*/1, n_main, aux_rows,
      aux_cols, method, round_mode, scale, inv_step, inv_q, inv_ex, inv_sum);
  return int(lutk::dispatch<DecodeLaunch>(p, dtype,
                                          static_cast<cudaStream_t>(stream)));
}

// The int8-pool entry: k/v pages int8, k/v scales f32 (n_pages, ps, KVH),
// q_dtype 0 = f32, 1 = bf16 queries.
extern "C" int paged_decode_int8_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_tables,
    const void* kv_lens, const void* lut_main, const void* lut_aux,
    void* out, int q_dtype, int B, int H, int KVH, int Dh, int n_pages,
    int ps, int mp, int n_main, int aux_rows, int aux_cols, int method,
    int round_mode, float scale, float inv_step, float inv_q, float inv_ex,
    float inv_sum, void* stream) {
  lutk::Params p = lutk::make_params(
      q, k_pages, v_pages, block_tables, kv_lens, nullptr, lut_main, lut_aux,
      out, B, H, KVH, Dh, n_pages, ps, mp, /*C=*/1, n_main, aux_rows,
      aux_cols, method, round_mode, scale, inv_step, inv_q, inv_ex, inv_sum,
      k_scales, v_scales);
  return int(lutk::dispatch_int8<DecodeLaunch>(
      p, q_dtype, static_cast<cudaStream_t>(stream)));
}
