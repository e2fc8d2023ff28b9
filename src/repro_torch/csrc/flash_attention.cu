// Exact flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention_pallas of
// src/repro/kernels/flash_attention/flash_attention.py (its pallas_call
// over _flash_kernel): exact softmax attention in one pass over the keys
// with the online recurrence — a running row max m, a running sum l and
// an f32 accumulator rescaled by exp(m_prev − m_new) whenever the max
// moves.  q (B, H, Lq, D), k / v (B, KVH, Lk, D) of one type (f32, bf16
// or f16; query head h reads KV head h / (H / KVH)); out (B, H, Lq, D),
// m and l (B, H, Lq), all f32.  Causal masking is right-aligned: key j
// is visible to query row i iff j ≤ i + (Lk − Lq).  A row with no
// visible key (also every row when Lq > Lk pushes it before key 0)
// returns out 0, m = −inf, l = 0, as the TPU kernel does.
//
// What bounds it on the H100: operations.  Per (sequence, head) it does
// Lq · Lk · D multiply-adds for q·kᵀ and as many for p·V against
// (Lq + 2 Lk) · D elements read; the reference's 2e-5 tolerance rules
// out TF32, and p is f32, so both products run in IEEE f32 on the CUDA
// cores (67 TFLOP/s); the least time counts q·kᵀ at the input type's
// peak (a bf16 product is exact in f32, so bf16 tensor cores could take
// it) and p·V at the f32 peak, halved for causal.
//
// Design — a simple kernel, no tensor cores, TMA or wgmma yet: one
// block of 256 threads per (b, h, tile of kBQ = 64 query rows) holds its
// queries in shared memory as f32 and walks the keys in tiles of BK (64
// for D ≤ 64, 32 above), only as far as the causal mask lets the
// tile's last row see.  Per key tile: K and V rows into shared memory;
// each thread takes a 4 × BK/16 block of the logits (a register tile,
// conflict-free through padded rows); four threads per row update m, l
// and p = exp(s − m) with expf (not __expf); each thread rescales and
// accumulates a 4 × D/16 block of the output.  IEEE f32 throughout:
// fmaf products, expf, and the final division by max(l, 1e-30).
#include "lut_pipeline.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;

template <int DMAX>
struct Tiles {
  static constexpr int BK = DMAX <= 64 ? 64 : 32;
  static constexpr int QS = DMAX + 1;  // padded row strides: no bank
  static constexpr int SS = BK + 1;    // conflicts on the column reads
  static constexpr size_t floats =
      size_t(kBQ) * QS + size_t(BK) * QS + size_t(BK) * DMAX +
      size_t(kBQ) * SS + 3 * kBQ;
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, float* __restrict__ out,
                           float* __restrict__ m_out,
                           float* __restrict__ l_out, int H, int KVH, int Lq,
                           int Lk, int D, int causal, float scale) {
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
  const int off = Lk - Lq;  // right-aligned causal offset
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
  const int jend = causal ? min(Lk, max(0, last + off + 1)) : Lk;

  for (int k0 = 0; k0 < jend; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * DMAX; i += kThreads) {
      const int r = i / DMAX, d = i % DMAX, j = k0 + r;
      const bool in = j < Lk && d < D;
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
        const bool vis = j < Lk && (!causal || j <= row0 + r + off);
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
                   int D, int causal, float scale, cudaStream_t stream) {
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
      causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       void* out, void* m, void* l, int B, int H, int KVH,
                       int Lq, int Lk, int D, int causal, float scale,
                       cudaStream_t s) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, out, m, l, B, H, KVH, Lq, Lk, D, causal,
                         scale, s);
  if (D <= 128)
    return launch<T, 128>(q, k, v, out, m, l, B, H, KVH, Lq, Lk, D, causal,
                          scale, s);
  return launch<T, 256>(q, k, v, out, m, l, B, H, KVH, Lq, Lk, D, causal,
                        scale, s);
}

}  // namespace

// q (B, H, Lq, D), k / v (B, KVH, Lk, D), contiguous, of dtype 0 = f32,
// 1 = bf16, 2 = f16; out (B, H, Lq, D), m and l (B, H, Lq) f32.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* m,
                                      void* l, int dtype, int B, int H,
                                      int KVH, int Lq, int Lk, int D,
                                      int causal, float scale,
                                      void* stream) {
  const bool ok = B >= 1 && KVH >= 1 && H % KVH == 0 && Lq >= 1 &&
                  Lk >= 1 && D >= 1 && D <= 256;
  if (!ok) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return int(dispatch_d<float>(q, k, v, out, m, l, B, H, KVH, Lq, Lk, D,
                                   causal, scale, s));
    case 1:
      return int(dispatch_d<__nv_bfloat16>(q, k, v, out, m, l, B, H, KVH, Lq,
                                           Lk, D, causal, scale, s));
    case 2:
      return int(dispatch_d<__half>(q, k, v, out, m, l, B, H, KVH, Lq, Lk, D,
                                    causal, scale, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}
