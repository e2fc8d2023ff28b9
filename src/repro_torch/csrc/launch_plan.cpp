// The launch plans of every CUDA kernel of the port, built by the host
// C++ compiler (kernels/build.py: build_host) so that the kernel guard
// (repro_torch/analysis/kernel_guard.py) reads on the CPU the plans the
// card launches.  The entries have the names, arguments and results of
// the `<name>_plan` entries that each CUDA library compiles from the same
// header (csrc/launch_plan.h): `in` the call's ints, `out` plan::kOut
// int64 fields; 0, or 1 for a call the launcher refuses.
#include "launch_plan.h"

extern "C" {

int paged_decode_plan(const int* in, int n_in, long long* out, int n_out) {
  return plan::paged_entry(paged::kDecodeRows, in, n_in, out, n_out);
}

int paged_prefill_plan(const int* in, int n_in, long long* out, int n_out) {
  return plan::paged_entry(paged::kPrefillRows, in, n_in, out, n_out);
}

int lut_attention_plan(const int* in, int n_in, long long* out, int n_out) {
  return plan::dense_entry(in, n_in, out, n_out);
}

int flash_attention_plan(const int* in, int n_in, long long* out,
                         int n_out) {
  return plan::flash_entry(in, n_in, out, n_out);
}

int lut_softmax_plan(const int* in, int n_in, long long* out, int n_out) {
  return plan::row_entry(in, n_in, out, n_out);
}

// The plans' limits (plan::kConstants, in its order) and the page-id
// arithmetic the paged kernels run on the device: a block-table entry
// clamped into a pool of n_pages, and a slot's live keys.
int launch_plan_constants(long long* out, int n_out) {
  const int n = int(sizeof(plan::kConstants) / sizeof(plan::kConstants[0]));
  if (n_out < n) return 1;
  for (int i = 0; i < n; ++i) out[i] = plan::kConstants[i];
  return 0;
}

int launch_plan_clamp_page(int id, int n_pages) {
  return paged::clamp_page(id, n_pages);
}

int launch_plan_live_keys(int kv_len, int mp, int ps) {
  return paged::live_keys(kv_len, mp, ps);
}

int launch_plan_unit_lo(int rank, int nu, int ns) {
  return paged::unit_lo(rank, nu, ns);
}

int launch_plan_block_rows(int y, int kvh, int rpb, int rows, int* out) {
  const paged::BlockRows r = paged::block_rows(y, kvh, rpb, rows);
  out[0] = r.kvh;
  out[1] = r.row0;
  out[2] = r.nrows;
  return 0;
}

}  // extern "C"
