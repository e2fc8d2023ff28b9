// Paged-decode LUT attention for Hopper (sm_90a).
//
// Replaces the TPU kernel paged_decode_attention of
// src/repro/kernels/lut_attention/paged_decode.py (its three
// pallas_calls over _pg_rowmax_kernel, _pg_sum_kernel and
// _pg_weight_kernel), and, through the entry point
// paged_decode_int8_launch, their int8-pool bodies _pg_rowmax_kernel_int8,
// _pg_sum_kernel_int8 and _pg_weight_kernel_int8 (pages int8, one f32
// scale per token × KV head, dequantized row by row as in _page_rows).
// One single-token query per slot attends to its own sequence, read
// page by page from the shared pool (n_pages, page_size, KVH, Dh)
// through the slot's block table; the softmax is exact, REXP or 2D-LUT
// (csrc/lut_pipeline.cuh).
//
// What bounds it on the H100: bytes, and the latency of a short walk.
// The least time is the live K+V bytes over 3.35 TB/s — for an int8 pool
// a quarter of the f32 bytes plus 8 bytes of scales per (token, KV head).
//
// The design is csrc/paged_attn.cuh's, with C = 1: a cluster per (slot,
// KV head) holds the KV head's G query heads as its rows (up to 8 a
// cluster, RPT = 1: a warp a query head), so each K and V row is read
// from device memory once for all of them; the live pages are split
// across the cluster's CTAs, which exchange the row max and Σ through
// distributed shared memory and write the output once.
#include "paged_attn.cuh"

extern "C" int paged_decode_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* kv_lens, const void* lut_main,
    const void* lut_aux, void* out, int dtype, int B, int H, int KVH, int Dh,
    int n_pages, int ps, int mp, int n_main, int aux_rows, int aux_cols,
    int method, int round_mode, float scale, float inv_step, float inv_q,
    float inv_ex, float inv_sum, int max_kv_len, int plan_kv_heads,
    void* stream) {
  lutk::Params p = lutk::make_params(
      q, k_pages, v_pages, block_tables, kv_lens, nullptr, lut_main, lut_aux,
      out, B, H, KVH, Dh, n_pages, ps, mp, /*C=*/1, n_main, aux_rows,
      aux_cols, method, round_mode, scale, inv_step, inv_q, inv_ex, inv_sum);
  return int(paged::run<paged::PagedKeys, 1>(
      p, max_kv_len, plan_kv_heads, dtype, static_cast<cudaStream_t>(stream)));
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
    float inv_sum, int max_kv_len, int plan_kv_heads, void* stream) {
  if (!k_scales || !v_scales) return int(cudaErrorInvalidValue);
  lutk::Params p = lutk::make_params(
      q, k_pages, v_pages, block_tables, kv_lens, nullptr, lut_main, lut_aux,
      out, B, H, KVH, Dh, n_pages, ps, mp, /*C=*/1, n_main, aux_rows,
      aux_cols, method, round_mode, scale, inv_step, inv_q, inv_ex, inv_sum,
      k_scales, v_scales);
  return int(paged::run<paged::PagedKeys, 1>(
      p, max_kv_len, plan_kv_heads, q_dtype,
      static_cast<cudaStream_t>(stream)));
}
