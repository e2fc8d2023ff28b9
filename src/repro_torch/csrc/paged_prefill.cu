// Paged-prefill LUT attention for Hopper (sm_90a).
//
// Replaces the TPU kernel paged_prefill_attention of
// src/repro/kernels/lut_attention/paged_prefill.py (its three
// pallas_calls over _pf_rowmax_kernel, _pf_sum_kernel and
// _pf_weight_kernel, masked as in _chunk_logits), and, through the entry
// point paged_prefill_int8_launch, their int8-pool bodies
// _pf_rowmax_kernel_int8, _pf_sum_kernel_int8 and _pf_weight_kernel_int8
// (int8 pages, f32 row scales, each row dequantized before use).  A
// C-token prompt chunk, already scattered into the pool, attends
// causally to its sequence through the block table: key pos is visible
// to chunk row i iff pos < kv_lens[b] and pos <= q_start[b] + i.
//
// What bounds it on the H100: bytes at serving chunk sizes.  A cluster
// reads each live K and V row once and does G·C · Dh multiply-adds per
// row read, still far below the card's ~295 operations per byte; the
// least time is the live K+V bytes (plus the chunk's queries and
// outputs) over 3.35 TB/s.  At the engine's 16-token chunks those
// products take a few microseconds on the CUDA cores, below the walk's
// latency, so they stay there in IEEE f32 (tensor cores would pay only
// at far longer chunks).
//
// The design is csrc/paged_attn.cuh's: a cluster per (slot, KV head,
// block of up to 16 of the KV head's G·C query rows), so K and V are
// read once for every 16 query rows of the chunk (the engine's 16-token
// chunks at G = 8: 8 blocks a KV head); the live pages (only those
// below the block's last causal limit) split across the cluster's CTAs.
// Blocks of 8 or 16 rows (RPT 1, 2): on an H100 (700 W) at the engine's
// chunk on a bf16 pool, 16-row blocks took 0.0369 ms, 8-row blocks
// 0.0383 and 32-row blocks 0.0406 (tools/paged_sweep.py --variants) —
// fewer rows a warp keep each warp's dependent chains short.
#include "paged_attn.cuh"

extern "C" int paged_prefill_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* kv_lens, const void* q_start,
    const void* lut_main, const void* lut_aux, void* out, int dtype, int B,
    int H, int KVH, int Dh, int n_pages, int ps, int mp, int C, int n_main,
    int aux_rows, int aux_cols, int method, int round_mode, float scale,
    float inv_step, float inv_q, float inv_ex, float inv_sum, int max_kv_len,
    int plan_kv_heads, void* stream) {
  lutk::Params p = lutk::make_params(
      q, k_pages, v_pages, block_tables, kv_lens, q_start, lut_main, lut_aux,
      out, B, H, KVH, Dh, n_pages, ps, mp, C, n_main, aux_rows, aux_cols,
      method, round_mode, scale, inv_step, inv_q, inv_ex, inv_sum);
  return int(paged::run<paged::PagedKeys>(
      p, paged::kPrefillRows, max_kv_len, plan_kv_heads, dtype, static_cast<cudaStream_t>(stream)));
}

// The int8-pool entry: k/v pages int8, k/v scales f32 (n_pages, ps, KVH),
// q_dtype 0 = f32, 1 = bf16 queries.
extern "C" int paged_prefill_int8_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_tables,
    const void* kv_lens, const void* q_start, const void* lut_main,
    const void* lut_aux, void* out, int q_dtype, int B, int H, int KVH,
    int Dh, int n_pages, int ps, int mp, int C, int n_main, int aux_rows,
    int aux_cols, int method, int round_mode, float scale, float inv_step,
    float inv_q, float inv_ex, float inv_sum, int max_kv_len,
    int plan_kv_heads, void* stream) {
  if (!k_scales || !v_scales) return int(cudaErrorInvalidValue);
  lutk::Params p = lutk::make_params(
      q, k_pages, v_pages, block_tables, kv_lens, q_start, lut_main, lut_aux,
      out, B, H, KVH, Dh, n_pages, ps, mp, C, n_main, aux_rows, aux_cols,
      method, round_mode, scale, inv_step, inv_q, inv_ex, inv_sum, k_scales,
      v_scales);
  return int(paged::run<paged::PagedKeys>(
      p, paged::kPrefillRows, max_kv_len, plan_kv_heads, q_dtype,
      static_cast<cudaStream_t>(stream)));
}

// The launch plan of a call (csrc/launch_plan.h; the host library
// csrc/launch_plan.cpp exports the same entry): in = dtype, int8, B, H,
// KVH, C, Dh, n_pages, ps, mp, n_main, aux_rows, aux_cols, max_kv_len,
// plan_kv_heads, n_sms; out = plan::kOut int64 fields.
extern "C" int paged_prefill_plan(const int* in, int n_in, long long* out,
                                  int n_out) {
  return plan::paged_entry(paged::kPrefillRows, in, n_in, out, n_out);
}

// The instance a plan's call launches (paged::attrs_entry): in = the
// `paged_prefill_plan` ints; out = registers, local (spill) bytes a thread, CTAs
// a multiprocessor holds at the plan's threads and shared memory.
extern "C" int paged_prefill_attrs(const int* in, int n_in, int* out,
                                   int n_out) {
  return paged::attrs_entry<paged::PagedKeys>(paged::kPrefillRows, in, n_in, out,
                                            n_out);
}
