// Paged LUT attention for Hopper (sm_90a): the kernel that
// csrc/paged_decode.cu (a single-token query per slot) and
// csrc/paged_prefill.cu (a C-token chunk per slot) both launch.  A decode
// step is a prefill chunk with C = 1 whose query sits at kv_len − 1.
//
// Replaces the TPU kernels paged_decode_attention and
// paged_prefill_attention of src/repro/kernels/lut_attention/
// (paged_decode.py, paged_prefill.py: three pallas_calls each, the row
// max, the integer Σ and the per-element σ·V, over f32/bf16 pages or, in
// their *_int8 bodies, int8 pages with one f32 scale per row).  Query row
// i of slot b sees key j iff j < kv_lens[b] and j ≤ q0 + c, where c is
// the row's chunk position and q0 = q_start[b] (prefill) or kv_len − 1
// (decode).
//
// What bounds it on the H100: bytes and latency.  Per (slot, KV head)
// the kernel reads each live K and V row once and does G·C · Dh
// multiply-adds per row read, far below the ~295 operations per byte
// where the card turns compute-bound; at serving sizes a call moves a
// few MB at most, so the chain of dependent memory round trips
// (kv_len → block table → pages) and the three passes' barriers set the
// time as much as the bytes do.
//
// The design:
//   * rows per KV head — one cluster serves one (slot, KV head, block of
//     query rows), the rows being the G query heads × C chunk rows of the
//     KV head (flattened g·C + c, at most 8·RPT a block), as the TPU
//     kernel groups them: K and V are read from device memory once per
//     KV head, not G times.  Warp w owns rows w, w + 8, …: it computes
//     their logits, max, Σ and weights by itself, so those never need a
//     block barrier;
//   * the block table in shared memory — a CTA loads its slot's block-
//     table row once, clamped into the pool (as XLA clamps a gather), in
//     the same round of loads as its queries, the LUTs and kv_len (the
//     counterpart of the TPU kernel's scalar prefetch); no pass reads
//     block_tables per key;
//   * pages through an asynchronous ring — K and V rows (Dh elements at a
//     row stride of KVH·Dh in the pool) go into a kStages-deep ring of
//     32-key tiles by cp.async (16 bytes a thread; 8 for int8 rows not a
//     multiple of 16 bytes; an int8 row's scale by a 4-byte copy), rows
//     padded to an odd number of 16-byte units so that the lanes' 16-byte
//     reads of 8 different key rows fall in 8 bank groups.  The walk is
//     one sequence of tiles across the passes (K for the logits, V for
//     σ·V), so the next pass's first tiles are in flight during the
//     cluster exchange.  Rows past the live range are zero-filled
//     (src-size 0) and never multiplied: junk pages, even NaN scales,
//     never reach an output;
//   * keys split across a thread-block cluster — n_split CTAs (a cluster
//     of up to 8, launched with cudaLaunchKernelEx) take contiguous
//     ranges of the slot's live pages.  Each CTA stores its partial row
//     max, then its partial Σ, into every CTA's shared memory
//     (map_shared_rank), and its σ·V partials into the CTA that owns
//     each share of the output; after each of the three cluster
//     barriers the values are read locally, Σ and the output summed over
//     the ranks in rank order, and the output written once.  No CTA
//     stores into another before the cluster's start-up barrier says
//     that every CTA of the cluster runs (arrived after the first round
//     of loads, awaited just before the first store).  One launch a
//     call, no combine kernel;
//   * the logits cache — a CTA keeps its range's logits, then numerators,
//     in shared memory when they fit (cache_keys), so K is read once;
//     past that every pass recomputes q·k by the same instruction
//     sequence, bit for bit the same logits.
// Everything runs on the CUDA cores in IEEE f32: the bin path
// (lut_pipeline.cuh's lut_e_term, clamp_bin, sigma_col, sigma_int,
// weight) is shared with the other LUT kernels, and a masked key gives a
// hard 0.
//
// The dense LUT-attention kernel's few-row calls (csrc/lut_attention.cu,
// route "split": decode steps and short prefill chunks against a
// contiguous cache) run the same body as lut_attention_split_kernel.  A
// key walk is then a run of rows of one (sequence, KV head) at stride Dh
// (DenseKeys instead of PagedKeys), split in units of one 32-key tile,
// with the dense kernel's mask (one kv_len for every sequence, causal
// rows right-aligned to it) and, for REXP, its fused α form: pass 1 is
// skipped, the last pass sums the integer Σ beside U = Σ e·v, and both
// partials go to the cluster in one exchange; the output is U · α(Σ) /
// qmax².  A block with fewer rows than warps also splits its keys across
// its warps (Split::warp_split key slices: warp w takes row slot
// w % slots and every slice-th 32-key tile of a ring stage of
// warp_split tiles), so that a one-row block — Whisper's MHA decode step
// — keeps all eight warps busy; the slices' partials enter the cluster
// exchange as entries of their own and are combined in rank, then slice
// order.  The paged kernels keep one slice (their plan).
#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "launch_plan.h"
#include "lut_pipeline.cuh"

namespace paged {
// Internal linkage: paged_decode.cu and paged_prefill.cu each build a
// library of these templates, and a launcher's static `reserved` (the
// shared-memory limit its own kernel was given) must not be one object
// shared by both libraries in a process.
namespace {

namespace cg = cooperative_groups;
using lutk::kThreads;
using lutk::kWarps;

// Where the keys of a walk live, and what a query row sees.
//
// PagedKeys: the slot's pages through its block-table row (in shared
// memory), the live length kv_lens[b], query rows at q_start[b] + c
// (prefill) or kv_len − 1 (decode); the split's unit is a page.
struct PagedKeys {
  static constexpr bool kDense = false;
  static __device__ __forceinline__ int unit(const lutk::Params& p) {
    return p.ps;
  }
  static __device__ __forceinline__ int kv_len(const lutk::Params& p, int b) {
    return live_keys(p.kv_lens[b], p.mp, p.ps);
  }
  static __device__ __forceinline__ int q0(const lutk::Params& p, int b,
                                           int kv_len) {
    return p.q_start ? p.q_start[b] : kv_len - 1;
  }
  static __device__ __forceinline__ size_t row(const lutk::Params& p,
                                               const int* bt_s, int, int kvh,
                                               int j) {
    return (size_t(bt_s[j / p.ps]) * p.ps + j % p.ps) * p.KVH + kvh;
  }
};

// DenseKeys: contiguous (B, KVH, Lk, Dh) k and v (lut_pipeline.cuh's
// DenseRows: mp = 1, ps = Lk), one kv_len for every sequence; row c sees
// j < kv_len and, if causal, j ≤ c + (kv_len − C); the split's unit is
// one ring tile of 32 keys.
struct DenseKeys {
  static constexpr bool kDense = true;
  static __device__ __forceinline__ int unit(const lutk::Params&) {
    return kTile;
  }
  static __device__ __forceinline__ int kv_len(const lutk::Params& p, int b) {
    return lutk::DenseRows::valid(p, b);
  }
  static __device__ __forceinline__ int q0(const lutk::Params& p, int,
                                           int kv_len) {
    return p.causal ? kv_len - p.C : kv_len;
  }
  static __device__ __forceinline__ size_t row(const lutk::Params& p,
                                               const int*, int b, int kvh,
                                               int j) {
    return lutk::DenseRows::index(p, b, kvh, j);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// N bytes global → shared, asynchronously; `valid` false writes N zero
// bytes without reading src.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(N), "r"(valid ? N : 0)
                 : "memory");
}
// Send a row's partial to every CTA of the cluster: lane l < n_split
// stores it into rank l's table (rank × rows) at this rank's slot, so
// that after the next cluster barrier each CTA reads every rank's value
// from its own shared memory.  Stores to another SM's shared memory go
// out without waiting; nothing on the critical path loads remotely.
__device__ __forceinline__ void send_row(cg::cluster_group& cluster,
                                         float* table, int rows, int rank,
                                         int row, int lane, int ns,
                                         float value) {
  if (lane < ns)
    cluster.map_shared_rank(table, lane)[rank * rows + row] = value;
}

// The first element (a float4 index) of rank r's share of n4 outputs;
// element e4 belongs to rank e4 · ns / n4.
__device__ __forceinline__ int share_lo(int r, int n4, int ns) {
  return int((static_cast<long long>(r) * n4 + ns - 1) / ns);
}

// The cluster's barrier in two halves: arrive (relaxed: it orders no
// memory, it only says that this CTA runs) and wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four consecutive elements of a ring row as f32 (16-, 8- or 4-byte
// aligned for f32, bf16, int8).
__device__ __forceinline__ void load4(const float* src, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* src,
                                      float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void load4(const int8_t* src, float (&v)[4]) {
  const char4 c = *reinterpret_cast<const char4*>(src);
  v[0] = float(c.x); v[1] = float(c.y); v[2] = float(c.z); v[3] = float(c.w);
}

// Dependent chains a thread keeps apart when it has few rows: σ·V goes
// to kAcc partial accumulators (key kk to kk % kAcc), combined in a fixed
// order at the end, so that a lane with one row does not wait on one
// chain of 32 fused multiply-adds a tile.  (The q·k dot stays one chain
// in head-dim order, the order of the kernels before this design: a
// logit that moves by an ulp can cross a LUT bin edge, and with it Σ's
// column of the weight table, a whole row's weights.)
template <int RPT>
constexpr int kAcc = RPT >= 4 ? 1 : 4 / RPT;

// Masked logits s_i = (q_r·k) · scale of this lane's key row `krow` (in
// the ring) for the warp's rows r = rs + slots·i (rows w + 8i without key
// slices); rows that do not see key j, and lanes past the range, get
// −inf.  Every pass computes them by this same instruction sequence: fmaf
// from 0 in head-dim order.  An int8 row's codes are dequantized by its
// scale first, one rounded multiply each, as the reference's _page_rows
// does.
template <typename TK, int RPT, int NV>
__device__ __forceinline__ void tile_logits(const lutk::Params& p,
                                            const TK* krow, float ksc,
                                            const float* q_s, int rs,
                                            int slots, int j, bool live,
                                            const int (&lim)[RPT],
                                            float (&s)[RPT]) {
  float dot[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) dot[i] = 0.f;
  // two chunks an iteration, the loads of both before their products:
  // the code stays short
#pragma unroll 2
  for (int c0 = 0; c0 < 16 * NV; c0 += 2) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int d = (c0 + a) * 8;
      if (d >= p.Dh) break;
      lutk::Chunk<TK> kc;
      kc.load(krow + d);
      float k[8];
      kc.get(k);
      if constexpr (lutk::kQuantized<TK>) {
#pragma unroll
        for (int e = 0; e < 8; ++e) k[e] = __fmul_rn(k[e], ksc);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        lutk::Chunk<float> qc;
        qc.load(q_s + (rs + slots * i) * p.Dh + d);
        float q[8];
        qc.get(q);
#pragma unroll
        for (int e = 0; e < 8; ++e) dot[i] = fmaf(q[e], k[e], dot[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i)
    s[i] = live && j < lim[i] ? __fmul_rn(dot[i], p.scale) : -CUDART_INF_F;
}

// The kernel body, for the paged kernels (Keys = PagedKeys) and the dense
// kernel's split route (DenseKeys).  Warps are ws = warp_split key slices
// × `slots` row slots: warp w takes rows rs + slots·i (rs = w % slots) of
// the keys of slice ks = w / slots, the ks-th tile of every ring stage;
// its entry in the per-warp tables (partial max and Σ, weights) is
// w + 8i, which is its row when ws = 1.  Warps past ws·slots are idle
// (they still load and wait with the others).
template <typename TQ, typename TK, int RPT, int NV, typename Keys>
__device__ __forceinline__ void attention_body(const lutk::Params& p,
                                               const Split& sp) {
  constexpr int kRowsPad = kWarps * RPT;
  constexpr bool kInt8 = lutk::kQuantized<TK>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ns = sp.n_split, rank = int(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // (the paged kernels' plan has one slice and a kStages-deep ring: as
  // constants here, their code is what it was before the dense route; a
  // runtime `active` alone cost paged decode 7 %)
  const int ws = Keys::kDense ? sp.warp_split : 1, slots = kWarps / ws;
  const int rs = Keys::kDense ? warp % slots : warp;
  const int ks = Keys::kDense ? warp / slots : 0;
  const bool active = !Keys::kDense || ks < ws;
  const int span = ws * kTile;  // keys of a ring stage
  const int depth = Keys::kDense ? sp.stages : kStages;
  const int b = blockIdx.z, G = p.H / p.KVH;
  const BlockRows br =
      block_rows(blockIdx.y, p.KVH, sp.rows_per_block, G * p.C);
  const int kvh = br.kvh, row0 = br.row0, nrows = br.nrows;
  const bool fused = Keys::kDense && p.fused;  // REXP's α form: dense only
  const Layout L = layout<int(sizeof(TK))>(
      p, kRowsPad, Split{sp.n_split, sp.rows_per_block, sp.cache_keys, ws,
                         depth});
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  int* bt_s = reinterpret_cast<int*>(smem + L.bt);
  int* main_s = reinterpret_cast<int*>(smem + L.tables);
  int* aux_s = main_s + p.n_main;
  float* mx_s = reinterpret_cast<float*>(smem + L.stats);  // ranks × rows
  float* sx_s = mx_s + kMaxSplit * kRowsPad;
  float* w_s = reinterpret_cast<float*>(smem + L.w);
  unsigned char* ring = smem + L.ring;
  float* cache_s = reinterpret_cast<float*>(smem + L.cache);
  float* part_s = reinterpret_cast<float*>(smem + L.part);

  // One round of loads before anything waits: the query rows as f32,
  // eight elements a load (row r of this block: g = (row0 + r) / C, c =
  // its remainder; padded rows 0), the slot's whole block-table row (page
  // ids clamped into the pool), the LUTs, and the slot's cursors (read
  // below).  Dense keys need no table: their first stages go out first.
  auto load_inputs = [&]() {
    const TQ* q = static_cast<const TQ*>(p.q);
    const int q8 = p.Dh / 8;
    for (int i = tid; i < kRowsPad * q8; i += kThreads) {
      const int r = i / q8, d = (i - r * q8) * 8, flat = row0 + r;
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (r < nrows) {
        lutk::Chunk<TQ> qc;
        qc.load(q + ((size_t(b) * p.H + kvh * G + flat / p.C) * p.C +
                     flat % p.C) * p.Dh + d);
        qc.get(x);
      }
      float4* dst = reinterpret_cast<float4*>(q_s + r * p.Dh + d);
      dst[0] = make_float4(x[0], x[1], x[2], x[3]);
      dst[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
    if constexpr (!Keys::kDense) {
      for (int i = tid; i < p.mp; i += kThreads)
        bt_s[i] = clamp_page(p.block_tables[size_t(b) * p.mp + i], p.n_pages);
    }
    for (int i = tid; i < p.n_main; i += kThreads) main_s[i] = p.lut_main[i];
    for (int i = tid; i < p.aux_rows * p.aux_cols; i += kThreads)
      aux_s[i] = p.lut_aux[i];
  };
  if constexpr (!Keys::kDense) load_inputs();

  // Valid keys, the rows' limits, and this CTA's range of live units
  // (pages; 32-key tiles for dense keys).
  const int kv_len = Keys::kv_len(p, b);
  const int q0 = Keys::q0(p, b, kv_len);
  int lim[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rs + slots * i;
    lim[i] = r < nrows ? max(min(kv_len, q0 + (row0 + r) % p.C + 1), 0) : 0;
  }
  // the block's largest chunk position: every row's limit is below its
  // (the limit grows with c)
  const int c_first = row0 % p.C;
  const int c_last = c_first + nrows - 1 < p.C ? c_first + nrows - 1 : p.C - 1;
  const int jmax = max(min(kv_len, q0 + c_last + 1), 0);
  const int unit = Keys::unit(p);
  const int nu = (jmax + unit - 1) / unit;
  const int u_lo = unit_lo(rank, nu, ns), u_hi = unit_lo(rank + 1, nu, ns);
  const int j0 = u_lo * unit, j1 = min(u_hi * unit, jmax);
  const int nkeys = max(j1 - j0, 0), nt = (nkeys + span - 1) / span;
  const bool cached = nkeys <= sp.cache_keys;
  const int ck = sp.cache_keys;
  // The walk, in ring stages of `span` keys: K stages for the logits
  // (pass 0; without the cache again in pass 1 — not for the fused form,
  // which has none — and before each V stage in pass 2), V stages for
  // σ·V.
  const int n_k = cached || fused ? nt : 2 * nt;  // K stages before pass 2
  const int n_items = cached ? 2 * nt : n_k + 2 * nt;
  const int row_bytes = p.Dh * int(sizeof(TK));
  const bool wide = row_bytes % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(p.k_pages) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(p.v_pages) % 16 == 0;
  auto fetch = [&](int item) {
    if (item >= n_items) return;
    bool is_v;
    int t;
    if (cached) {
      is_v = item >= nt;
      t = is_v ? item - nt : item;
    } else if (item < n_k) {
      is_v = false;
      t = item % nt;
    } else {
      is_v = (item - n_k) & 1;
      t = (item - n_k) >> 1;
    }
    const unsigned char* base =
        static_cast<const unsigned char*>(is_v ? p.v_pages : p.k_pages);
    unsigned char* st = ring + (item % depth) * L.stage;
    const int gran = wide ? 16 : 8, per_row = row_bytes / gran;
    for (int c = tid; c < span * per_row; c += kThreads) {
      const int kk = c / per_row, piece = c - kk * per_row;
      const int j = j0 + t * span + kk;
      const bool live = j < j1;
      const size_t row = live ? Keys::row(p, bt_s, b, kvh, j) : 0;
      const unsigned char* src = base + row * row_bytes + piece * gran;
      unsigned char* dst = st + kk * L.stride + piece * gran;
      if (wide)
        cp_async<16>(dst, src, live);
      else
        cp_async<8>(dst, src, live);
    }
    if constexpr (kInt8) {
      if (tid < span) {
        const int j = j0 + t * span + tid;
        const bool live = j < j1;
        const size_t row = live ? Keys::row(p, bt_s, b, kvh, j) : 0;
        cp_async<4>(st + span * L.stride + 4 * tid,
                    (is_v ? p.v_scales : p.k_scales) + row, live);
      }
    }
  };
  int item = 0;
  // wait for stage `item` (depth − 2 younger copies may stay in flight),
  // and let every warp be done with the stage before it, which the next
  // copy refills
  auto acquire = [&]() -> const unsigned char* {
    if (depth == 2)
      cp_async_wait<0>();
    else if (depth == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<kStages - 2>();
    __syncthreads();
    fetch(item + depth - 1);
    cp_async_commit();
    return ring + (item++ % depth) * L.stage;
  };
  auto prologue = [&]() {
#pragma unroll 1
    for (int i = 0; i < depth - 1; ++i) {
      fetch(i);
      cp_async_commit();
    }
  };
  if constexpr (Keys::kDense) {
    prologue();
    load_inputs();
  }

  // Start-up: the first store into another CTA's shared memory (the
  // partial max, after pass 0) waits for every CTA of the cluster to
  // arrive here, which it does while its own keys stream in.
  cluster_arrive_relaxed();
  __syncthreads();

  if constexpr (!Keys::kDense) prologue();
  const int sub = ks * kTile;  // this warp's tile of a stage
  auto key_row = [&](const unsigned char* st) {
    return reinterpret_cast<const TK*>(st + (sub + lane) * L.stride);
  };
  auto key_scale = [&](const unsigned char* st) {
    return kInt8 ? reinterpret_cast<const float*>(st + span * L.stride)[sub +
                                                                       lane]
                 : 1.f;
  };

  // The three passes in one loop, so that each step's code exists once
  // (the logits at one call site: every pass gets them by the same
  // instructions):
  //   pass 0  logits of K tiles → partial row max; the cluster's max;
  //   pass 1  numerators → partial Σ (an integer for the LUT policies,
  //           exact in any order below 2^24); the cluster's Σ, summed
  //           over the ranks in rank order (skipped by the fused form);
  //   pass 2  per-element weights (the warp's rows × the tile's keys, in
  //           w_s; the fused form's are the numerators, whose Σ it sums
  //           here), then σ·V over the V tile, lanes over the head dim
  //           four at a time.
  // With the cache, passes 1 and 2 read the logits, then (faithful
  // forms) the numerators, from it; without, they recompute the logits
  // from K tiles.
  constexpr int A = kAcc<RPT>;
  float part[RPT], m_row[RPT], S_row[RPT];
  int col[RPT];
  float acc[A][RPT][NV][4];
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int u = 0; u < NV; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][i][u][e] = 0.f;
  // σ·V's lanes: four head-dim elements each; with dense keys and
  // Dh ≤ 64 the two half-warps take alternate keys, so that no lane
  // idles (their sums are added once, at the end)
  const int halves = Keys::kDense && NV == 1 && p.Dh <= 64 ? 2 : 1;
  const int half = halves == 2 ? lane >> 4 : 0;
  const int dlane = halves == 2 ? lane & 15 : lane;
  // what the cache holds for a dead key in pass 2: a numerator (faithful)
  // or a logit (fused)
  const float dead2 = fused ? -CUDART_INF_F : 0.f;
#pragma unroll 1
  for (int pass = 0; pass < 3; ++pass) {
    if (pass == 1 && fused) continue;
#pragma unroll
    for (int i = 0; i < RPT; ++i) part[i] = pass == 0 ? -CUDART_INF_F : 0.f;
#pragma unroll 1
    for (int t = 0; t < nt; ++t) {
      const int jt = j0 + t * span + sub;  // this warp's first key
      const int j = jt + lane;
      const bool live = active && j < j1;
      float x[RPT];  // logits, or (pass 2 with the cache) numerators
      if (pass == 0 || !cached) {
        const unsigned char* st = acquire();
        if (active) {
          tile_logits<TK, RPT, NV>(p, key_row(st), key_scale(st), q_s, rs,
                                   slots, j, live, lim, x);
        } else {
#pragma unroll
          for (int i = 0; i < RPT; ++i) x[i] = -CUDART_INF_F;
        }
      } else {
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          x[i] = live ? cache_s[(rs + slots * i) * ck + j - j0]
                      : (pass == 1 ? -CUDART_INF_F : dead2);
      }
      if (pass == 0) {
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          if (cached && live) cache_s[(rs + slots * i) * ck + j - j0] = x[i];
          part[i] = fmaxf(part[i], x[i]);
        }
        continue;
      }
      float e[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        e[i] = pass == 2 && cached && !fused
                   ? x[i]
                   : lutk::e_term(x[i], m_row[i], main_s, p);
      if (pass == 1 || fused) {
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          if (pass == 1 && cached && live)
            cache_s[(rs + slots * i) * ck + j - j0] = e[i];
          part[i] += e[i];
        }
        if (pass == 1) continue;
      }
      __syncwarp();  // the warp's lanes are done with the last tile's weights
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        w_s[(warp + kWarps * i) * kTile + lane] =
            fused ? e[i]
            : p.method == lutk::kExact
                ? lutk::weight(e[i], S_row[i], aux_s, p)
                : __fmul_rn(lutk::sigma_int(e[i], col[i], aux_s, p), p.inv_q);
      const unsigned char* vt = acquire();  // also publishes w_s
      if (!active) continue;
      const int n = min(kTile, j1 - jt);
      const float* vsc =
          reinterpret_cast<const float*>(vt + span * L.stride) + sub;
      for (int k0 = 0; k0 < n; k0 += A * halves) {
#pragma unroll
        for (int a = 0; a < A; ++a) {
          const int kk = k0 + a * halves + half;
          if (kk >= n) break;
          const TK* vr = reinterpret_cast<const TK*>(vt + (sub + kk) *
                                                              L.stride);
          const float vs = kInt8 ? vsc[kk] : 1.f;
          float v[NV][4];
#pragma unroll
          for (int u = 0; u < NV; ++u) {
            const int d = (u * 32 + dlane) * 4;
            if (d < p.Dh) {
              load4(vr + d, v[u]);
            } else {
#pragma unroll
              for (int y = 0; y < 4; ++y) v[u][y] = 0.f;
            }
            if constexpr (kInt8) {
#pragma unroll
              for (int y = 0; y < 4; ++y) v[u][y] = __fmul_rn(v[u][y], vs);
            }
          }
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float w = w_s[(warp + kWarps * i) * kTile + kk];
#pragma unroll
            for (int u = 0; u < NV; ++u)
#pragma unroll
              for (int y = 0; y < 4; ++y)
                acc[a][i][u][y] = fmaf(w, v[u][y], acc[a][i][u][y]);
          }
        }
      }
    }
    if (pass == 0) {
      cluster_wait();  // every CTA of the cluster runs
#pragma unroll
      for (int i = 0; i < RPT; ++i) {  // (warp reductions outside branches)
        const float m = lutk::warp_max(part[i]);
        if (active)
          send_row(cluster, mx_s, kRowsPad, rank, warp + kWarps * i, lane, ns,
                   m);
      }
      cluster.sync();
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        float m = -CUDART_INF_F;
        for (int rk = 0; rk < ns; ++rk)
          for (int k = 0; k < ws; ++k)
            m = fmaxf(m, mx_s[rk * kRowsPad + k * slots + rs + slots * i]);
        m_row[i] = isfinite(m) ? m : 0.f;
      }
    } else if (pass == 1) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float S = lutk::warp_sum(part[i]);
        if (active)
          send_row(cluster, sx_s, kRowsPad, rank, warp + kWarps * i, lane, ns,
                   S);
      }
      cluster.sync();
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        float S = 0.f;  // in rank order, then slice order
        for (int rk = 0; rk < ns; ++rk)
          for (int k = 0; k < ws; ++k)
            S += sx_s[rk * kRowsPad + k * slots + rs + slots * i];
        S_row[i] = S;
        col[i] = p.method == lutk::kExact ? 0 : lutk::sigma_col(S, p);
      }
    }
  }

  // The σ·V partials: rank r owns a share of the block's outputs (float4
  // elements [share_lo(r), share_lo(r + 1))); every CTA (every key slice
  // of it) stores its partial of each element into the owner's table at
  // its own entry, rank · ws + slice, and the fused form its partial Σ of
  // each row into every CTA's; after one cluster barrier each owner sums
  // its share over the entries in rank, then slice order (the fused form
  // times α(Σ)·(1/qmax)², Σ summed in the same order) and writes it to
  // the output once.
  const int n4 = nrows * p.Dh / 4;
  const int share = (n4 + ns - 1) / ns;  // the longest share
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int r = rs + slots * i, d = (u * 32 + dlane) * 4;
      float o[4];
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        o[y] = acc[0][i][u][y];
#pragma unroll
        for (int a = 1; a < A; ++a) o[y] = __fadd_rn(o[y], acc[a][i][u][y]);
        if (halves == 2)  // the odd keys' half-warp, in a fixed order
          o[y] = __fadd_rn(o[y], __shfl_xor_sync(0xffffffffu, o[y], 16));
      }
      if (active && r < nrows && d < p.Dh && half == 0) {
        const int e4 = (r * p.Dh + d) / 4;
        const int owner = int(static_cast<long long>(e4) * ns / n4);
        float4* dst = reinterpret_cast<float4*>(
            cluster.map_shared_rank(part_s, owner));
        dst[(rank * ws + ks) * share + e4 - share_lo(owner, n4, ns)] =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
    if (fused) {
      const float S = lutk::warp_sum(part[i]);
      if (active)
        send_row(cluster, sx_s, kRowsPad, rank, warp + kWarps * i, lane, ns,
                 S);
    }
  }
  cluster.sync();
  const int e_lo = share_lo(rank, n4, ns), e_hi = share_lo(rank + 1, n4, ns);
  const float4* part4 = reinterpret_cast<const float4*>(part_s);
  for (int e4 = e_lo + tid; e4 < e_hi; e4 += kThreads) {
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int rk = 0; rk < ns * ws; ++rk) {
      const float4 x = part4[rk * share + e4 - e_lo];
      o.x += x.x; o.y += x.y; o.z += x.z; o.w += x.w;
    }
    const int r = e4 * 4 / p.Dh, d = e4 * 4 - r * p.Dh, flat = row0 + r;
    if (fused) {
      float S = 0.f;
      for (int rk = 0; rk < ns; ++rk)
        for (int k = 0; k < ws; ++k) S += sx_s[rk * kRowsPad + k * slots + r];
      const float f = lutk::alpha_factor(S, aux_s, p);
      o = make_float4(__fmul_rn(o.x, f), __fmul_rn(o.y, f),
                      __fmul_rn(o.z, f), __fmul_rn(o.w, f));
    }
    const size_t orow =
        (size_t(b) * p.H + kvh * G + flat / p.C) * p.C + flat % p.C;
    *reinterpret_cast<float4*>(p.out + orow * p.Dh + d) = o;
  }
}

// The paged kernels' entry (profiled under this name).
template <typename TQ, typename TK, int RPT, int NV>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(lutk::Params p, Split sp) {
  attention_body<TQ, TK, RPT, NV, PagedKeys>(p, sp);
}

// The dense kernel's split route (csrc/lut_attention.cu, route 2): the
// same body over contiguous keys, q, k, v of one type.
template <typename TQ, typename TK, int RPT, int NV>
__global__ void __launch_bounds__(kThreads)
    lut_attention_split_kernel(lutk::Params p, Split sp) {
  attention_body<TQ, TK, RPT, NV, DenseKeys>(p, sp);
}

// The card's multiprocessor count, asked once per device.
inline cudaError_t multiprocessors(int& n) {
  static int sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!sms[dev]) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
  }
  n = sms[dev];
  return cudaSuccess;
}

// Launch the instance on the plan; with `attrs`, launch nothing and
// report the instance instead: its registers a thread, its local (spill)
// bytes a thread, and the CTAs of the plan's threads and shared memory a
// multiprocessor holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
template <typename TQ, typename TK, int RPT, int NV, typename Keys>
cudaError_t launch(const lutk::Params& p, const Launch& pl,
                   cudaStream_t stream, int* attrs) {
  void (*kernel)(lutk::Params, Split);
  if constexpr (Keys::kDense)
    kernel = lut_attention_split_kernel<TQ, TK, RPT, NV>;
  else
    kernel = paged_attention_kernel<TQ, TK, RPT, NV>;
  static int reserved = 0;
  cudaError_t err = lutk::reserve_smem(kernel, pl.smem, reserved);
  if (err != cudaSuccess) return err;
  if (attrs) {
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) return err;
    attrs[0] = fa.numRegs;
    attrs[1] = int(fa.localSizeBytes);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &attrs[2], kernel, pl.threads, pl.smem);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.grid_x, pl.grid_y, pl.grid_z);
  cfg.blockDim = dim3(pl.threads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, p, pl.split);
}

// The instance of the plan's row count RPT (8·RPT rows a block).
template <typename TQ, typename TK, typename Keys, int NV, int RPT,
          int... More>
cudaError_t launch_rows(const lutk::Params& p, const Launch& pl,
                        cudaStream_t stream, int* attrs) {
  if (pl.rpt == RPT)
    return launch<TQ, TK, RPT, NV, Keys>(p, pl, stream, attrs);
  if constexpr (sizeof...(More) > 0)
    return launch_rows<TQ, TK, Keys, NV, More...>(p, pl, stream, attrs);
  return cudaErrorInvalidValue;
}

template <typename TQ, typename TK, typename Keys, int... RPTs>
cudaError_t launch_dh(const lutk::Params& p, const Launch& pl,
                      cudaStream_t stream, int* attrs) {
  if (p.Dh <= 128)
    return launch_rows<TQ, TK, Keys, 1, RPTs...>(p, pl, stream, attrs);
  return launch_rows<TQ, TK, Keys, 2, RPTs...>(p, pl, stream, attrs);
}

// Check the shapes, plan the launch (launch_plan.h's launch_plan: the
// KV head's G·C query rows go in the fewest blocks of at most
// 8·max(RPTs) rows, evened out, the split and the shared memory follow
// max_kv_len and plan_kv_heads), then launch the instance for the keys:
// int8 pages (k_scales set) with f32 (q_dtype 0) or bf16 (1) queries, or
// pages (Keys = PagedKeys; dense keys: DenseKeys) of the queries' own
// type, f32 (0) or bf16 (1).  max_kv_len is the caller's bound on the
// slots' kv_lens (0: none, the block table's whole width) — the split
// follows it, and a slot past it is still computed in full, only split
// less well.  plan_kv_heads is the KV-head count the split is planned
// for (0: the call's own, p.KVH): a tensor-parallel rank that launches
// its share of a model's KV heads passes the model's count, and each of
// its heads then runs the single-device launch's split and summation
// order.  A plan past 227 KB is refused.  With `attrs` the instance is
// reported, not launched (launch()).
template <typename Keys, int... RPTs>
cudaError_t run(const lutk::Params& p, Rows<RPTs...> rows, int max_kv_len,
                int plan_kv_heads, int q_dtype, cudaStream_t stream,
                int* attrs = nullptr) {
  const bool ok = p.B >= 1 && p.KVH >= 1 && p.H % p.KVH == 0 && p.C >= 1 &&
                  p.Dh >= 8 && p.Dh <= 256 && p.Dh % 8 == 0 && p.ps >= 1 &&
                  p.mp >= 1 && p.n_pages >= 1 && max_kv_len >= 0 &&
                  plan_kv_heads >= 0 &&
                  (p.k_scales == nullptr) == (p.v_scales == nullptr) &&
                  (!Keys::kDense || p.k_scales == nullptr) &&
                  (q_dtype == 0 || q_dtype == 1);
  if (!ok) return cudaErrorInvalidValue;
  int n_sms = 0;
  cudaError_t err = multiprocessors(n_sms);
  if (err != cudaSuccess) return err;
  const bool int8 = !Keys::kDense && p.k_scales;
  Launch pl;
  if (int8)
    pl = launch_plan<1>(p, Keys::kDense, rows, max_kv_len, plan_kv_heads,
                        n_sms);
  else if (q_dtype == 0)
    pl = launch_plan<4>(p, Keys::kDense, rows, max_kv_len, plan_kv_heads,
                        n_sms);
  else
    pl = launch_plan<2>(p, Keys::kDense, rows, max_kv_len, plan_kv_heads,
                        n_sms);
  if (!pl.rpt || pl.smem > kSmemLimit) return cudaErrorInvalidValue;
  if constexpr (!Keys::kDense) {
    if (int8) {
      if (q_dtype == 0)
        return launch_dh<float, int8_t, Keys, RPTs...>(p, pl, stream, attrs);
      return launch_dh<__nv_bfloat16, int8_t, Keys, RPTs...>(p, pl, stream,
                                                             attrs);
    }
  }
  if (q_dtype == 0)
    return launch_dh<float, float, Keys, RPTs...>(p, pl, stream, attrs);
  return launch_dh<__nv_bfloat16, __nv_bfloat16, Keys, RPTs...>(p, pl,
                                                                stream, attrs);
}

// The instance a plan entry's call (plan::kPagedIn ints) would launch,
// reported (run() with attrs): out = registers, local bytes, CTAs a
// multiprocessor.  Dense keys take the dense entry's ints (plan::kDenseIn;
// the split route only).
template <typename Keys, int... RPTs>
int attrs_entry(Rows<RPTs...> rows, const int* in, int n_in, int* out,
                int n_out) {
  static const float no_scales = 0.f;
  if (n_out < 3) return int(cudaErrorInvalidValue);
  if constexpr (Keys::kDense) {
    if (n_in != plan::kDenseIn || in[0] != 2)
      return int(cudaErrorInvalidValue);
    lutk::Params p = lutk::make_params(
        nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
        nullptr, nullptr, in[2], in[3], in[4], in[7], in[2] * in[4], in[6],
        1, in[5], in[10], in[11], in[12], lutk::kRexp, 1, 1.f, 1.f, 1.f, 1.f,
        1.f);
    p.kv_len = in[8];
    p.fused = in[9];
    return int(run<Keys>(p, rows, in[8] > 0 ? in[8] : 1, 0, in[1], nullptr,
                         out));
  } else {
    if (n_in != plan::kPagedIn) return int(cudaErrorInvalidValue);
    const void* sc = in[1] ? &no_scales : nullptr;
    lutk::Params p = lutk::make_params(
        nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
        nullptr, nullptr, in[2], in[3], in[4], in[6], in[7], in[8], in[9],
        in[5], in[10], in[11], in[12], lutk::kRexp, 1, 1.f, 1.f, 1.f, 1.f,
        1.f, sc, sc);
    return int(run<Keys>(p, rows, in[13], in[14], in[0], nullptr, out));
  }
}

}  // namespace
}  // namespace paged
