// Tensor-core tile engine of the attention kernels (sm_90a), for 16-bit
// q, k, v (bf16 or f16) and head dims up to 128.
//
// Shared by the dense LUT attention's tile route (csrc/lut_attention.cu)
// and the exact flash attention's (csrc/flash_attention.cu).  A block of
// kWarps = 4 warps owns kBM = 64 query rows of one (sequence, query
// head), 16 rows a warp; query head h reads KV head h / (H / KVH).  The
// keys go by in tiles of kBN = 64:
//
//   * operands — the block's Q tile is copied once into shared memory
//     and each warp keeps its 16 × DH slice as mma A fragments in
//     registers (ldmatrix, once); K and V tiles stream through a
//     two-stage ring in shared memory, cp.async.cg at 16 bytes a thread
//     (the next tile's copy is in flight while the current one is used),
//     with rows padded by 16 bytes so that the eight row addresses of
//     every ldmatrix / ldmatrix.trans fall in eight different bank groups;
//   * products — mma.sync.aligned.m16n8k16.row.col with f32 accumulation
//     (the .bf16 or .f16 form), through inline PTX.  S = q·kᵀ of a tile is
//     a warp's 16 × 64 accumulator, 32 f32 a thread;
//   * register reuse — that accumulator has the layout of the A operand of
//     the next product, so whatever a kernel makes of S per element (LUT
//     numerators, weights, or flash's p) is packed to 16 bits in registers
//     and multiplied with V straight away (FlashAttention-2 style); it
//     never goes through shared memory;
//   * accumulation — p·V of each key tile is summed in a fresh mma
//     accumulator and only then added into the running f32 output with
//     one IEEE operation (an add, or flash's rescaling fma).  The tensor
//     cores' own f32 sums truncate rather than round; summing each tile
//     alone keeps that to 4 k-steps of a tile-sized partial instead of a
//     whole row's worth of steps against the full sum;
//   * bounds — rows past Lq and keys past the block's last visible key
//     are zero-filled by the copies (cp.async's src-size 0), head dims
//     past Dh too, so padding adds exact zeros; the kernels mask the
//     logits of key j for row i by the row's limit (j < lim(i)).
//
// A product of two bf16 (or two f16) values is exact in f32, so a tensor-
// core q·kᵀ differs from a CUDA-core f32 dot only in the order and the
// rounding of its sum — which is why the LUT kernels may take it for
// 16-bit inputs (their f32 inputs stay on the CUDA cores: TF32 would
// round the inputs themselves and move bins).
//
// What comes next, and why: every warp re-reads the whole K and V tile
// from shared memory for its 16 rows, and a tile's work is a chain of
// short dependent steps (copy, ldmatrix, mma, per-element work, mma);
// neither a deeper ring nor a register cap for more blocks an SM moved
// the dense route (tools/tile_variants.py).  wgmma (a 64-row warpgroup
// product reading K and V from shared memory once for all four warps),
// TMA copies issued by one producer warp, and warp specialisation that
// overlaps one tile's per-element work with the next tile's products
// are the steps after this one.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tiles {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBM = 64;  // query rows of a block, 16 per warp
constexpr int kBN = 64;  // keys of a tile
// Stages of the K / V ring: the copies of the next kStages − 1 tiles are
// in flight while one is used.
constexpr int kStages = 2;

// Elements of one shared-memory row of a DH-wide tile: 16 bytes of
// padding make ldmatrix's eight rows land in eight bank groups.
template <int DH>
__host__ __device__ constexpr int stride() {
  return DH + 8;
}

// Shared memory of a block: the Q tile and the kStages-stage rings of K
// and V tiles, all 16-bit (the kernels add their tables after it).
template <int DH>
constexpr size_t smem_bytes() {
  return size_t(kBM + 2 * kStages * kBN) * stride<DH>() * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, asynchronously; `valid` false writes 16 zero
// bytes without reading src.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// The 16-bit element types: c += a·b on one m16n8k16 tile, and two f32
// packed into one register (lo in the low half), round to nearest.
template <typename T>
struct Op;

template <>
struct Op<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
  }
};

template <>
struct Op<__half> {
  static __device__ __forceinline__ void mma(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return __half22float2(*reinterpret_cast<__half2*>(&u));
  }
};

// Where a thread's accumulator elements sit.  Element i of n-tile nt of
// a warp's 16 × 64 S tile is row row_of(i) of the warp's 16 and key
// col_of(nt, i) of the tile; the same (row, column) map holds for the
// 16 × DH output, with head-dim tiles for key tiles.
__device__ __forceinline__ int row_of(int lane, int i) {
  return (lane >> 2) + (i >> 1) * 8;
}
__device__ __forceinline__ int col_of(int lane, int nt, int i) {
  return nt * 8 + 2 * (lane & 3) + (i & 1);
}

// Rows [row0, row0 + 64) of a (rows, Dh) 16-bit matrix into a padded
// shared tile; rows at or past `valid` and head dims at or past Dh are
// zero-filled.  Dh is a multiple of 8 (one 16-byte chunk each).
template <typename T, int DH>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int valid, int Dh) {
  constexpr int kChunks = DH / 8;
  for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = row0 + r < valid && c * 8 < Dh;
    cp_async16(dst + r * stride<DH>() + c * 8,
               ok ? src + (size_t(row0) + r) * Dh + c * 8 : src, ok);
  }
}

// This warp's Q rows as A fragments, one per 16 head dims.
template <int DH>
__device__ __forceinline__ void load_q(uint32_t (&qf)[DH / 16][4],
                                       const void* q_s, int warp,
                                       int lane) {
  const uint16_t* q = static_cast<const uint16_t*>(q_s);
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc)
    ldmatrix_x4(qf[kc], q + (warp * 16 + (lane & 15)) * stride<DH>() +
                            kc * 16 + (lane >> 4) * 8);
}

// S = q·kᵀ for this warp's 16 rows against the 64 keys of tile k_s,
// always the same sequence of products, so a pass that recomputes S gets
// the same f32 values bit for bit.
template <typename T, int DH>
__device__ __forceinline__ void qk_tile(float (&S)[8][4],
                                        const uint32_t (&qf)[DH / 16][4],
                                        const T* k_s, int lane) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) S[nt][i] = 0.f;
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, k_s + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                               stride<DH>() +
                           kc * 16 + ((lane >> 3) & 1) * 8);
      Op<T>::mma(S[2 * np], qf[kc], b[0], b[1]);
      Op<T>::mma(S[2 * np + 1], qf[kc], b[2], b[3]);
    }
  }
}

// The A fragments of 16 keys (key chunk kc) from per-element values of
// the S layout.
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4],
                                       const float (&x)[8][4], int kc) {
  a[0] = Op<T>::pack(x[2 * kc][0], x[2 * kc][1]);
  a[1] = Op<T>::pack(x[2 * kc][2], x[2 * kc][3]);
  a[2] = Op<T>::pack(x[2 * kc + 1][0], x[2 * kc + 1][1]);
  a[3] = Op<T>::pack(x[2 * kc + 1][2], x[2 * kc + 1][3]);
}

// acc = finish(acc, Σ_pieces P_piece · V) for every head-dim tile, each
// pair of tiles summed over the key tile in a fresh accumulator first:
// finish(acc, tile) is acc + tile, or flash's acc · corr + tile.
template <typename T, int DH, int NP, typename Finish>
__device__ __forceinline__ void pv_tile(float (&acc)[DH / 8][4],
                                        const uint32_t (&P)[NP][4][4],
                                        const T* v_s, int lane,
                                        Finish finish) {
#pragma unroll
  for (int dp = 0; dp < DH / 16; ++dp) {
    float c[2][4] = {};
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, v_s + (kc * 16 + (lane & 15)) * stride<DH>() +
                               dp * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int piece = 0; piece < NP; ++piece) {
        Op<T>::mma(c[0], P[piece][kc], b[0], b[1]);
        Op<T>::mma(c[1], P[piece][kc], b[2], b[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * dp][i] = finish(acc[2 * dp][i], c[0][i], i);
      acc[2 * dp + 1][i] = finish(acc[2 * dp + 1][i], c[1][i], i);
    }
  }
}

// One sweep over the key tiles [0, jmax) of one (sequence, KV head):
// K (and, with kWithV, V) tiles through the kStages-stage rings, the
// copies of tiles t + 1 … t + kStages − 1 in flight while
// body(k0, k_tile, v_tile) uses tile t.  Every step commits one copy
// group (empty past the last tile), so waiting for all but the newest
// kStages − 1 groups means tile t has landed.  The rings are free again
// when the sweep returns.
template <typename T, int DH, bool kWithV, typename Body>
__device__ __forceinline__ void sweep(const T* kg, const T* vg, int jmax,
                                      int Dh, T* k_ring, T* v_ring,
                                      Body body) {
  constexpr int kTile = kBN * stride<DH>();
  const int n = (jmax + kBN - 1) / kBN;
  if (n <= 0) return;
  auto fetch = [&](int t) {
    if (t < n) {
      const int st = t % kStages;
      load_tile<T, DH>(k_ring + st * kTile, kg, t * kBN, jmax, Dh);
      if (kWithV) load_tile<T, DH>(v_ring + st * kTile, vg, t * kBN, jmax, Dh);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) fetch(t);
  for (int t = 0; t < n; ++t) {
    fetch(t + kStages - 1);  // into the stage that step t − 1 used
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int st = t % kStages;
    body(t * kBN, k_ring + st * kTile, v_ring + st * kTile);
    __syncthreads();  // a later copy overwrites this stage
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace tiles
