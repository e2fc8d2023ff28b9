// Row-wise LUT softmax for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/lut_softmax/lut_softmax.py:
// rexp_softmax_pallas (body _rexp_kernel) and lut2d_softmax_pallas (body
// _lut2d_kernel), both launched by the pallas_call of _row_softmax_call.
// x (rows, cols) of f32, bf16 or f16 → σ (rows, cols) f32, REXP
// (Algorithm 1) or 2D-LUT (Algorithm 2) along each row, with the TPU
// kernel's semantics: the row max is taken over the finite entries (0
// when none is finite), and every non-finite entry (−inf, +inf, NaN)
// gives a hard 0.
//
// The per-element arithmetic is csrc/lut_pipeline.cuh's, shared with the
// attention kernels: e_term (the numerator from the row max) and weight
// (σ from the numerator and the row's Σ).  Every rounding step of the
// bin path is an _rn intrinsic, bins round with rintf (half to even) or
// floorf, the f32 reciprocals come from the host, and Σ is an f32 sum of
// integers, exact in any order while it stays below 2^24 — so the output
// is bitwise the plain version's.  Build without --use_fast_math.
//
// What bounds it on the H100: bytes.  Each element is read once and
// written once as f32, with about ten operations between, far below the
// card's operations per byte; the least time is (input bytes + 4 bytes
// out) per element over 3.35 TB/s.
//
// Design: one block per row — one warp for rows of up to 256 columns,
// up to 512 threads for long ones — in three passes: the max over the
// finite entries; the numerators through the LUT in shared memory and
// their Σ; σ written as f32.  The row stays in shared memory between the
// passes (as f32, then as numerators) when it fits kRowSmemBudget;
// longer rows are re-read from global memory (L2) in passes 2 and 3, so
// no column count is refused.  Loads are scalar and coalesced.
#include "lut_pipeline.cuh"

namespace {

constexpr int kMaxThreads = 512;
// Shared memory a block may take for its row; above it the row is
// re-read from global memory instead.
constexpr size_t kRowSmemBudget = 64 * 1024;

__device__ __forceinline__ float block_max(float x, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  x = lutk::warp_max(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float m = -CUDART_INF_F;
  for (int w = 0; w < int(blockDim.x >> 5); ++w) m = fmaxf(m, red[w]);
  return m;
}

__device__ __forceinline__ float block_sum(float x, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  x = lutk::warp_sum(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < int(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    lut_softmax_kernel(const T* __restrict__ x,
                       const int* __restrict__ lut_main,
                       const int* __restrict__ lut_aux,
                       float* __restrict__ out, int cols, lutk::LutParams p,
                       bool cached) {
  extern __shared__ float smem[];
  float* red_max = smem;                  // one per warp
  float* red_sum = smem + 32;
  int* main_s = reinterpret_cast<int*>(smem + 64);
  int* aux_s = main_s + p.n_main;
  float* row_s = reinterpret_cast<float*>(aux_s + p.aux_rows * p.aux_cols);
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t base = size_t(blockIdx.x) * cols;
  const T* xr = x + base;
  for (int i = tid; i < p.n_main; i += nt) main_s[i] = lut_main[i];
  for (int i = tid; i < p.aux_rows * p.aux_cols; i += nt)
    aux_s[i] = lut_aux[i];

  // Pass 1: the max over the finite entries.  A thread reads and writes
  // only its own columns of row_s, so the passes need no barrier for it.
  float m = -CUDART_INF_F;
  for (int c = tid; c < cols; c += nt) {
    const float v = lutk::to_f32(xr[c]);
    if (cached) row_s[c] = v;
    if (isfinite(v)) m = fmaxf(m, v);
  }
  m = block_max(m, red_max);  // its barrier also publishes the tables
  if (!isfinite(m)) m = 0.f;

  // Pass 2: numerators (a hard 0 for a non-finite entry) and their Σ.
  float S = 0.f;
  for (int c = tid; c < cols; c += nt) {
    const float v = cached ? row_s[c] : lutk::to_f32(xr[c]);
    const float e = lutk::e_term(v, m, main_s, p);
    if (cached) row_s[c] = e;
    S += e;
  }
  S = block_sum(S, red_sum);

  // Pass 3: σ from each numerator and the row's Σ.
  for (int c = tid; c < cols; c += nt) {
    const float e = cached ? row_s[c]
                           : lutk::e_term(lutk::to_f32(xr[c]), m, main_s, p);
    out[base + c] = lutk::weight(e, S, aux_s, p);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* lut_main, const void* lut_aux,
                   void* out, int rows, int cols, const lutk::LutParams& p,
                   cudaStream_t stream) {
  int threads = 32;
  while (threads < kMaxThreads && threads * 8 < cols) threads *= 2;
  const size_t fixed =
      4 * (64 + size_t(p.n_main) + size_t(p.aux_rows) * p.aux_cols);
  const bool cached = fixed + 4 * size_t(cols) <= kRowSmemBudget;
  const size_t smem = fixed + (cached ? 4 * size_t(cols) : 0);
  static int reserved = 0;
  auto kernel = lut_softmax_kernel<T>;
  cudaError_t err = lutk::reserve_smem(kernel, smem, reserved);
  if (err != cudaSuccess) return err;
  kernel<<<rows, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(lut_main),
      static_cast<const int*>(lut_aux), static_cast<float*>(out), cols, p,
      cached);
  return cudaGetLastError();
}

int run(int method, const void* x, const void* lut_main, const void* lut_aux,
        void* out, int dtype, int rows, int cols, int n_main, int aux_rows,
        int aux_cols, int round_mode, float inv_step, float inv_q,
        float inv_ex, float inv_sum, void* stream) {
  const bool ok = rows >= 0 && cols >= 1 && n_main >= 1 && aux_rows >= 1 &&
                  aux_cols >= 1 && (method != lutk::kRexp || aux_rows == 1);
  if (!ok) return int(cudaErrorInvalidValue);
  if (rows == 0) return int(cudaSuccess);
  lutk::LutParams p;
  p.n_main = n_main; p.aux_rows = aux_rows; p.aux_cols = aux_cols;
  p.method = method; p.round_mode = round_mode;
  p.inv_step = inv_step; p.inv_q = inv_q; p.inv_ex = inv_ex;
  p.inv_sum = inv_sum;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(launch<float>(x, lut_main, lut_aux, out, rows, cols, p, s));
    case 1:
      return int(launch<__nv_bfloat16>(x, lut_main, lut_aux, out, rows, cols,
                                       p, s));
    case 2: return int(launch<__half>(x, lut_main, lut_aux, out, rows, cols, p, s));
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (rows, cols) contiguous of dtype 0 = f32, 1 = bf16, 2 = f16; out
// (rows, cols) f32.  REXP: lut_main = LUT_1/e (n_main), lut_aux = LUT_α
// as one row (1, aux_cols); inv_q = 1/qmax.  2D-LUT: lut_main = LUT_exp,
// lut_aux = LUT_σ (aux_rows, aux_cols); inv_step, inv_q, inv_ex, inv_sum
// the f32 reciprocals of exp_step, qmax, qmax·scale_ex, qmax·scale_sum.
// round_mode 1 = round half to even, 0 = floor.
extern "C" int lut_softmax_rexp_launch(
    const void* x, const void* lut_main, const void* lut_aux, void* out,
    int dtype, int rows, int cols, int n_main, int aux_rows, int aux_cols,
    int round_mode, float inv_step, float inv_q, float inv_ex, float inv_sum,
    void* stream) {
  return run(lutk::kRexp, x, lut_main, lut_aux, out, dtype, rows, cols,
             n_main, aux_rows, aux_cols, round_mode, inv_step, inv_q, inv_ex,
             inv_sum, stream);
}

extern "C" int lut_softmax_lut2d_launch(
    const void* x, const void* lut_main, const void* lut_aux, void* out,
    int dtype, int rows, int cols, int n_main, int aux_rows, int aux_cols,
    int round_mode, float inv_step, float inv_q, float inv_ex, float inv_sum,
    void* stream) {
  return run(lutk::kLut2d, x, lut_main, lut_aux, out, dtype, rows, cols,
             n_main, aux_rows, aux_cols, round_mode, inv_step, inv_q, inv_ex,
             inv_sum, stream);
}
