// CUDA-core tile engine of the attention kernels (sm_90a): IEEE f32
// products for f32 inputs, and for 16-bit inputs at head dims the
// tensor-core tiles (csrc/attn_tiles.cuh) do not take (above 128, or off
// the 16-byte grid), up to 256.
//
// Shared by the dense LUT attention's "simt" route (csrc/lut_attention.cu)
// and the exact flash attention's (csrc/flash_attention.cu).  A block of
// simt::kThreads = 256 threads owns BM query rows of one (sequence, query
// head) and walks the keys in tiles of BN (launch_plan.h: block_rows,
// key_tile — 96 × 128 at DH 64, 128 × 64 at 128, 64 × 64 at 256).
// Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + kGroups·i (i < TM
// = BM / kGroups, kGroups = kThreads / 16 row groups) and, of each key
// tile, keys tx + 16·jj (jj < TN = BN / 16); of the output, DT head dims
// (Geo::chunk) of the same rows, summed over its slice of each tile's
// keys (at DH 64 the row group's sixteen threads span the 64 dims twice,
// each half over half the keys; the halves are
// added once at the end).  The sixteen threads of a row group are one
// half-warp, so a row's max and sum are four shuffles.
//
//   * operands — everything in shared memory is f32: the block's Q tile
//     (loaded once) and the ring of K and V tiles.  f32
//     inputs go global → shared by cp.async.cg at 16 bytes a thread;
//     16-bit inputs (and f32 rows off the 16-byte grid) are converted on
//     their way in, through registers.  Head dims past D are zero-filled,
//     as are keys past the sweep's last, so padding adds exact zeros.
//     K and V tiles go by as one stream through a kSlots-slot ring, the
//     next item's copy in flight while the current one is used;
//   * layout — K rows are stored with their 16-byte chunk c at c ^ (j & 7)
//     (j the key's row of the tile), so the eight keys tx … tx + 7 that a
//     quarter-warp's float4 reads touch at one chunk fall in eight bank
//     groups; a warp reads two Q rows at once (r and r + 1, one for each
//     of its row groups, by broadcast), padded by 16 bytes into different
//     bank groups; V rows are read by consecutive chunks and stored as
//     they are;
//   * products — S = q·kᵀ is a TM × TN register micro-tile a thread,
//     each logit summed with fmaf from 0 in head-dim order (the split
//     route's and flash's ieee_logit chain, bit for bit): per four head
//     dims TM + TN float4 shared loads feed 4·TM·TN fmaf.  Whatever a
//     kernel makes of S per element (LUT weights, flash's p) goes into a
//     key-major weight tile in shared memory (rows padded by 16 bytes),
//     and the TM × DT output micro-tile takes, per key, SW / 4 broadcast
//     float4 weights and DT / 4 float4 V chunks, summed with fmaf in key
//     order.  At DH 64 both micro-tiles are 6 × 8 (6 rows of 96 a
//     thread): about 14 fmaf per 16-byte shared load in q·k and 12 in
//     p·V, where 8 × 4 (10.7 in both) left q·k a third slower on an
//     H100 (tools/tile_variants.py simt).
//
// What bounds it: the CUDA cores' 67 TFLOP/s (f32 q·k feeds the bins or
// the 2e-5 limit; TF32 or a split-precision tensor-core product moves
// them), with shared-memory bandwidth the next limit — hence the register
// micro-tiles and 16-byte conflict-free reads.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "attn_tiles.cuh"
#include "launch_plan.h"
#include "lut_pipeline.cuh"

namespace simt {

// kThreads, kSlots, tile_dh, block_rows, key_tile, q_stride, p_stride
// and smem_bytes: launch_plan.h.
template <int DH>
struct Geo {
  static constexpr int BM = block_rows(DH), BN = key_tile(DH);
  static constexpr int TM = BM / kGroups, TN = BN / 16;
  // a row group's slots in the weight tile: TM rounded up to float4s
  static constexpr int SW = slot_width(DH);
  static constexpr int C4 = DH / 4;  // float4 chunks of a K or V row
  static constexpr int QS = q_stride(DH), PS = p_stride(DH);
  // The output: a thread's TM rows × DT head dims (TD float4 chunks);
  // NDX threads of a row group span the head dims, so KS = 16 / NDX of
  // them split a tile's keys in the σ·V (p·V) product.
  static constexpr int DT = DH <= 128 ? 8 : DH / 16, TD = DT / 4;
  static constexpr int NDX = DH / DT, KS = 16 / NDX;
  static_assert(SW % 4 == 0 && SW >= TM && BM % kGroups == 0 &&
                    DH % 64 == 0 && NDX * KS == 16,
                "simt tile geometry");
  // the block's row of thread row group ty's i-th row (its slot in the
  // weight tile is ty · SW + i)
  static __device__ __forceinline__ int row(int ty, int i) {
    return ty + kGroups * i;
  }
  // a thread's m-th chunk of head dims, and its slice of a tile's keys
  static __device__ __forceinline__ int chunk(int tx, int m) {
    return tx % NDX + NDX * m;
  }
  static __device__ __forceinline__ int slice(int tx) { return tx / NDX; }
};

// Shared-memory carve-up of a block: Q, the ring, the weight tile; a
// kernel's tables follow at `end`.
template <int DH>
struct Smem {
  float *q, *ring, *p;
  void* end;
  __device__ __forceinline__ explicit Smem(void* base) {
    using G = Geo<DH>;
    q = static_cast<float*>(base);
    ring = q + G::BM * G::QS;
    p = ring + kSlots * G::BN * DH;
    end = p + G::BN * G::PS;
  }
};

// Rows [row0, row0 + N) of a (rows, D) matrix of T into an f32 DH-wide
// shared tile of SR floats a row (kSwz: chunk c of tile row r at
// c ^ (r & 7)); rows at or past `valid` and head dims at or past D are
// zero.  `async`: T is f32, D a multiple of 4 and src 16-byte aligned, so
// cp.async copies it.
template <typename T, int DH, int N, bool kSwz, int SR = DH>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int row0,
                                          int valid, int D, bool async) {
  constexpr int C4 = DH / 4;
  for (int i = threadIdx.x; i < N * C4; i += kThreads) {
    const int r = i / C4, c = i % C4, d = c * 4;
    float* to = dst + r * SR + (kSwz ? (c ^ (r & 7)) : c) * 4;
    const bool row_ok = row0 + r < valid;
    const T* from = src + (size_t(row0) + r) * D + d;
    if (std::is_same<T, float>::value && async) {
      const bool ok = row_ok && d < D;
      tiles::cp_async16(to, ok ? from : src, ok);
    } else {
      float4 x;
      x.x = row_ok && d < D ? lutk::to_f32(from[0]) : 0.f;
      x.y = row_ok && d + 1 < D ? lutk::to_f32(from[1]) : 0.f;
      x.z = row_ok && d + 2 < D ? lutk::to_f32(from[2]) : 0.f;
      x.w = row_ok && d + 3 < D ? lutk::to_f32(from[3]) : 0.f;
      *reinterpret_cast<float4*>(to) = x;
    }
  }
}

// One sweep over the key tiles [0, jmax) of one (sequence, KV head):
// front(k0, k_tile) per tile and, with kWithV, back(k0, v_tile) after it
// (so a front may leave per-element values in the weight tile for its
// back).  The tiles go by as one stream of items — K tile t, then (with
// kWithV) V tile t — through the kSlots-slot ring: the copy of item
// u + kSlots − 1 is in flight while item u is used.  One barrier an item:
// past it item u has landed for every thread, and every thread is done
// with item u − 1, whose slot the next copy then takes.  Every step
// commits one copy group (empty past the last item), so waiting for all
// but the newest kSlots − 2 groups means item u has landed.
template <typename T, int DH, bool kWithV, typename Front, typename Back>
__device__ __forceinline__ void sweep(const T* kg, const T* vg, int jmax,
                                      int D, bool async, const Smem<DH>& sm,
                                      Front front, Back back) {
  using G = Geo<DH>;
  constexpr int kTile = G::BN * DH, kPer = kWithV ? 2 : 1;
  const int items = (jmax + G::BN - 1) / G::BN * kPer;
  if (items <= 0) return;
  auto fetch = [&](int u) {
    if (u < items) {
      float* slot = sm.ring + (u % kSlots) * kTile;
      const int row0 = u / kPer * G::BN;
      if (kWithV && u % kPer)
        load_rows<T, DH, G::BN, false>(slot, vg, row0, jmax, D, async);
      else
        load_rows<T, DH, G::BN, true>(slot, kg, row0, jmax, D, async);
    }
    tiles::cp_async_commit();
  };
#pragma unroll
  for (int u = 0; u < kSlots - 1; ++u) fetch(u);
  for (int u = 0; u < items; ++u) {
    tiles::cp_async_wait<kSlots - 2>();
    __syncthreads();
    fetch(u + kSlots - 1);  // into the slot that item u − 1 used
    const float* slot = sm.ring + (u % kSlots) * kTile;
    if (kWithV && u % kPer)
      back(u / kPer * G::BN, slot);
    else
      front(u / kPer * G::BN, slot);
  }
  __syncthreads();  // the ring and the weight tile are free again
}

// S = q·kᵀ of this thread's TM rows against its TN keys of the tile
// k_s, over the first nc chunks of four head dims: fmaf from 0 in
// head-dim order, always the same sequence, so a sweep that recomputes
// S gets the same f32 values bit for bit.
template <int DH>
__device__ __forceinline__ void qk(float (&s)[Geo<DH>::TM][Geo<DH>::TN],
                                   const float* q_s, const float* k_s,
                                   int ty, int tx, int nc) {
  using G = Geo<DH>;
  constexpr int QC4 = G::QS / 4;
  const float4* q4 = reinterpret_cast<const float4*>(q_s) + ty * QC4;
  const float4* k4 = reinterpret_cast<const float4*>(k_s) + tx * G::C4;
  const int swz = tx & 7;  // (tx + 16·jj) & 7
#pragma unroll
  for (int i = 0; i < G::TM; ++i)
#pragma unroll
    for (int jj = 0; jj < G::TN; ++jj) s[i][jj] = 0.f;
#pragma unroll 2
  for (int c = 0; c < nc; ++c) {
    float4 b[G::TN];
#pragma unroll
    for (int jj = 0; jj < G::TN; ++jj)
      b[jj] = k4[jj * 16 * G::C4 + (c ^ swz)];
#pragma unroll
    for (int i = 0; i < G::TM; ++i) {
      const float4 a = q4[kGroups * i * QC4 + c];  // row ty + kGroups · i
#pragma unroll
      for (int jj = 0; jj < G::TN; ++jj) {
        s[i][jj] = fmaf(a.x, b[jj].x, s[i][jj]);
        s[i][jj] = fmaf(a.y, b[jj].y, s[i][jj]);
        s[i][jj] = fmaf(a.z, b[jj].z, s[i][jj]);
        s[i][jj] = fmaf(a.w, b[jj].w, s[i][jj]);
      }
    }
  }
}

// This thread's per-element values w into the key-major weight tile.
template <int DH>
__device__ __forceinline__ void put_w(float* p_s,
                                      float (&w)[Geo<DH>::TM][Geo<DH>::TN],
                                      int ty, int tx) {
  using G = Geo<DH>;
#pragma unroll
  for (int jj = 0; jj < G::TN; ++jj)
#pragma unroll
    for (int i4 = 0; i4 < G::SW / 4; ++i4) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[e] = 4 * i4 + e < G::TM ? w[min(4 * i4 + e, G::TM - 1)][jj] : 0.f;
      *reinterpret_cast<float4*>(p_s + (tx + 16 * jj) * G::PS + ty * G::SW +
                                 4 * i4) = make_float4(x[0], x[1], x[2], x[3]);
    }
}

// acc += W · V over this thread's slice of the tile's keys (all of them
// when KS = 1), in key order (fmaf); fold() adds the KS slices' partial
// sums up once at the end.
template <int DH>
__device__ __forceinline__ void pv(float (&acc)[Geo<DH>::TM][Geo<DH>::DT],
                                   const float* p_s, const float* v_s,
                                   int ty, int tx) {
  using G = Geo<DH>;
  constexpr int kKeys = G::BN / G::KS;
  const int j0 = G::slice(tx) * kKeys;
  const float* pr = p_s + j0 * G::PS + ty * G::SW;
  const float4* v4 =
      reinterpret_cast<const float4*>(v_s) + j0 * G::C4 + G::chunk(tx, 0);
#pragma unroll 8
  for (int j = 0; j < kKeys; ++j) {
    float w[G::SW];
#pragma unroll
    for (int i4 = 0; i4 < G::SW / 4; ++i4) {
      const float4 x =
          *reinterpret_cast<const float4*>(pr + j * G::PS + 4 * i4);
      w[4 * i4] = x.x;
      w[4 * i4 + 1] = x.y;
      w[4 * i4 + 2] = x.z;
      w[4 * i4 + 3] = x.w;
    }
#pragma unroll
    for (int m = 0; m < G::TD; ++m) {
      const float4 b = v4[j * G::C4 + G::NDX * m];
#pragma unroll
      for (int i = 0; i < G::TM; ++i) {
        acc[i][4 * m] = fmaf(w[i], b.x, acc[i][4 * m]);
        acc[i][4 * m + 1] = fmaf(w[i], b.y, acc[i][4 * m + 1]);
        acc[i][4 * m + 2] = fmaf(w[i], b.z, acc[i][4 * m + 2]);
        acc[i][4 * m + 3] = fmaf(w[i], b.w, acc[i][4 * m + 3]);
      }
    }
  }
}

// A row's max and sum over the sixteen threads of its row group.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The output rows (acc · factor, or acc / denom) into out (rows, D): the
// KS key slices' partial sums added up first (slice 0's thread stores);
// float4 stores when D is a multiple of 4, else element by element.
template <int DH, typename Fin>
__device__ __forceinline__ void store(float* out,
                                      float (&acc)[Geo<DH>::TM][Geo<DH>::DT],
                                      int row0, int rows, int D, int ty,
                                      int tx, Fin fin) {
  using G = Geo<DH>;
#pragma unroll
  for (int off = G::NDX; off < 16; off *= 2)
#pragma unroll
    for (int i = 0; i < G::TM; ++i)
#pragma unroll
      for (int d = 0; d < G::DT; ++d)
        acc[i][d] += __shfl_xor_sync(0xffffffffu, acc[i][d], off);
  if (G::slice(tx) != 0) return;
#pragma unroll
  for (int i = 0; i < G::TM; ++i) {
    const int r = row0 + G::row(ty, i);
    if (r >= rows) continue;
#pragma unroll
    for (int m = 0; m < G::TD; ++m) {
      const int d = 4 * G::chunk(tx, m);
      if (d >= D) continue;
      float* o = out + size_t(r) * D + d;
      const float4 x =
          make_float4(fin(acc[i][4 * m], i), fin(acc[i][4 * m + 1], i),
                      fin(acc[i][4 * m + 2], i), fin(acc[i][4 * m + 3], i));
      if (D % 4 == 0) {
        *reinterpret_cast<float4*>(o) = x;
      } else {
        o[0] = x.x;
        if (d + 1 < D) o[1] = x.y;
        if (d + 2 < D) o[2] = x.z;
        if (d + 3 < D) o[3] = x.w;
      }
    }
  }
}

}  // namespace simt
