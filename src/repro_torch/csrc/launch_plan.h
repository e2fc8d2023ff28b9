// The launch plans of the port's CUDA kernels: host-only C++17, no CUDA
// header, so that the kernels (nvcc) and the kernel guard's host library
// (csrc/launch_plan.cpp, built by the host C++ compiler and loaded by
// ctypes: kernels/build.py) compile the same arithmetic.  Each launcher
// takes its grid, cluster, threads and shared memory from here, and each
// CUDA library exports `<name>_plan` (the entries at the end of this
// file) beside the host library's, so a check on the CPU reads the plan
// the card launches (repro_torch/analysis/kernel_guard.py), and
// chip_smoke.py's phase 14 holds the two libraries' plans equal.
//
// Everything here is integer arithmetic over the call's shapes: no float,
// and no size of a device type (a key element's bytes are a template
// argument: 4 f32, 2 bf16, 1 int8 — the one quantized type).  Functions
// the kernels also run on the device carry LP_HD.
#pragma once

#include <stddef.h>

#include <algorithm>
#include <initializer_list>

#ifdef __CUDACC__
#define LP_HD __host__ __device__
#else
#define LP_HD
#endif

namespace lutk {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// Shared memory a block may take with the logits cache; above it every
// pass recomputes q·k from the pages instead, as the TPU kernel does.
constexpr size_t kCacheSmemBudget = 96 * 1024;
// Query rows of a block of the dense kernel's rows route (csrc/
// lut_attention.cu) for chunks of more than one row; one row takes 1.
constexpr int kDenseRows = 8;
inline int dense_rows(int C) { return C == 1 ? 1 : kDenseRows; }

// Shared memory of one block serving R query rows of lut_rows: per-warp
// row offsets and weight tiles of 32 keys, q rows, per-warp partials, m
// and Σ, per-warp output partials, the tables, and (when `cached`) the
// R × (mp·ps) logits/numerators cache.
template <typename P>
inline size_t smem_bytes(const P& p, int R, bool cached) {
  size_t floats = size_t(kWarps) * R * 32 + size_t(R) * p.Dh +
                  size_t(kWarps) * R + 2 * size_t(R) +
                  size_t(kWarps) * R * p.Dh;
  if (cached) floats += size_t(R) * p.mp * p.ps;
  return 8 * size_t(kWarps) * 32 +
         4 * (floats + size_t(p.n_main) + size_t(p.aux_rows) * p.aux_cols);
}

}  // namespace lutk

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
LP_HD constexpr int stride() {
  return DH + 8;
}

// Shared memory of a block: the Q tile and the kStages-stage rings of K
// and V tiles, all 16-bit (the kernels add their tables after it).
template <int DH>
constexpr size_t smem_bytes() {
  return size_t(kBM + 2 * kStages * kBN) * stride<DH>() * 2;
}

// The tile width a head dim takes: 64 up to 64, else 128.
inline int tile_dh(int dh) { return dh <= 64 ? 64 : 128; }

// The LUT-attention tile kernel's: the tiles, then the tables (int32).
template <int DH, typename P>
inline size_t lut_smem(const P& p) {
  return smem_bytes<DH>() +
         4 * (size_t(p.n_main) + size_t(p.aux_rows) * p.aux_cols);
}

}  // namespace tiles

namespace flash {

// The CUDA-core (simt) route of csrc/flash_attention.cu.
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

// The instance a head dim takes: DMAX 64, 128 or 256.
inline int dmax(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 256; }

inline size_t simt_smem(int d) {
  switch (dmax(d)) {
    case 64: return 4 * Tiles<64>::floats;
    case 128: return 4 * Tiles<128>::floats;
    default: return 4 * Tiles<256>::floats;
  }
}

}  // namespace flash

namespace rowsm {

// csrc/lut_softmax.cu's routes: the threads and the blocks an SM must
// hold (the __launch_bounds__ minimum) of each, and the warp route's
// prefetch rule (elements of at most this many bytes).
constexpr int kWarpThreads = 256, kWarpBlocks = 2;
constexpr int kCtaThreads = 512, kCtaBlocks = 2;
constexpr int kPrefetchMaxBytes = 2;
// Shared memory a CTA may take (227 KB).
constexpr size_t kSmemLimit = 232448;

// Shared memory is laid out in 16-byte units.
LP_HD inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// The tables in shared memory as f32: the main table replicated across
// the 32 banks, the aux table once.
template <typename P>
LP_HD inline size_t table_bytes(const P& p) {
  return 4 * (32 * size_t(p.n_main) + size_t(p.aux_rows) * p.aux_cols);
}

// Shared memory of the CTA route before its row buffers: two mbarriers,
// two per-warp reduction arrays, the tables rounded up to 16 bytes.
constexpr size_t kCtaHead = 16 + 2 * 32 * 4;
template <typename P>
LP_HD inline size_t cta_fixed_smem(const P& p) {
  return kCtaHead + round16(table_bytes(p));
}

// The least shared memory a launch of `route` (0 warp, 1 cta) with
// vectors of `vec` elements of `esize` bytes, `threads` a CTA and
// `stages` row buffers takes over rows of `cols` elements: what the
// launcher checks the host's plan against (lut_softmax.row_plan).
template <typename P>
inline size_t smem_floor(const P& p, int route, int vec, int stages,
                         int threads, int esize, int cols) {
  const size_t in_bytes = size_t(vec) * esize;
  if (route == 0)
    return round16(table_bytes(p)) +
           (esize <= kPrefetchMaxBytes && in_bytes >= 4
                ? size_t(threads / 32) * round16(size_t(cols) * esize)
                : 0);
  return cta_fixed_smem(p) + size_t(stages) * size_t(cols) * esize;
}

}  // namespace rowsm

namespace paged {

constexpr int kTile = 32;     // keys of a ring tile: one a lane
constexpr int kStages = 4;    // deepest ring: kStages − 1 tiles in flight
constexpr int kMaxSplit = 8;  // the portable cluster size
// Shared memory: the logits cache stops where a CTA would take more than
// kCacheTarget (two CTAs an SM); no CTA may take more than kSmemLimit.
constexpr size_t kCacheTarget = 112 * 1024;
constexpr size_t kSmemLimit = 232448;  // 227 KB, Hopper's most a CTA
// The dense split route's grid: clusters of at most kDenseMaxSplit CTAs,
// at most kDensePerSm CTAs a multiprocessor on average, kDenseTarget
// bytes of shared memory a CTA where it can; and a multiprocessor's
// shared memory (228 KB) with what the system reserves of it for each
// CTA (1 KB).
constexpr int kDenseMaxSplit = 4;
constexpr int kDensePerSm = 3;
constexpr size_t kDenseTarget = 64 * 1024;
constexpr size_t kSmPool = 233472, kCtaReserve = 1024;

// The launch plan (see plan() below), computed on the host from what it
// knows: the shapes, the block table's width and the caller's bound on
// the live lengths, never the device's kv_lens.
struct Split {
  int n_split;         // CTAs of a cluster, each a range of live pages
  int rows_per_block;  // query rows (G·C flattened) of one cluster
  int cache_keys;      // logits cache per row, in keys (0: recompute)
  int warp_split;      // key slices of a CTA's warps (1: rows only)
  int stages;          // ring depth, 2 … kStages (stages − 1 in flight)
};

LP_HD constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// The shared memory a CTA may take for a grid of `ctas` CTAs to run in
// one wave on `n_sms` multiprocessors: a multiprocessor's pool over the
// CTAs it then holds, less what the system reserves for each.
inline size_t wave_smem(long long ctas, int n_sms) {
  const long long per_sm = (ctas + n_sms - 1) / n_sms;
  return kSmPool / size_t(per_sm) - kCtaReserve;
}

// Byte offsets of a CTA's shared memory: the query rows (as f32), the
// slot's block-table row, the LUTs, every rank's partial max and Σ of
// each row (of each warp's entry, with key slices), the warps' weight
// tiles, the σ·V partials every rank (and slice) sends this CTA for its
// share of the output, then the ring (stages of warp_split tiles) and the
// logits cache (the rows a slice holds).  KB: bytes of a key element
// (1 is int8, whose ring rows carry a 4-byte scale each).
struct Layout {
  size_t q, bt, tables, stats, w, part, ring, cache, total, stage;
  int stride;  // bytes of one ring row
};

template <int KB, typename P>
LP_HD inline Layout layout(const P& p, int rows_pad, const Split& s) {
  Layout L;
  const size_t rb = align16(size_t(p.Dh) * KB);
  const int span = s.warp_split * kTile;  // keys of a ring stage
  L.stride = int((rb / 16) % 2 ? rb : rb + 16);
  L.stage = size_t(span) * L.stride + (KB == 1 ? span * 4 : 0);
  size_t o = 0;
  L.q = o;
  o += align16(size_t(rows_pad) * p.Dh * 4);
  L.bt = o;
  o += align16(size_t(p.mp) * 4);
  L.tables = o;
  o += align16((size_t(p.n_main) + size_t(p.aux_rows) * p.aux_cols) * 4);
  L.stats = o;
  o += size_t(2) * kMaxSplit * rows_pad * 4;
  L.w = o;
  o += size_t(rows_pad) * kTile * 4;
  L.part = o;  // ranks × slices × the longest share (slices · rows ≤ 8)
  o += (size_t(rows_pad) * p.Dh / 4 + size_t(s.warp_split) * kMaxSplit) * 16;
  L.ring = o;
  o += s.stages * L.stage;
  L.cache = o;
  L.total = o + size_t(rows_pad / s.warp_split) * s.cache_keys * 4;
  return L;
}

// The first unit (page; 32-key tile for dense keys) of cluster rank
// `rank`'s range of `nu` live units split `ns` ways: rank r takes
// [unit_lo(r), unit_lo(r + 1)).
LP_HD inline int unit_lo(int rank, int nu, int ns) {
  return int(static_cast<long long>(rank) * nu / ns);
}

// A block's KV head and query rows: grid row y of a call of `kvh` KV
// heads serves KV head y % kvh and the rows [row0, row0 + nrows) of its
// `rows` (G·C flattened), `rpb` a block.
struct BlockRows {
  int kvh, row0, nrows;
};
LP_HD inline BlockRows block_rows(int y, int kvh, int rpb, int rows) {
  const int row0 = (y / kvh) * rpb, left = rows - row0;
  return {y % kvh, row0, rpb < left ? rpb : left};
}

// A block-table entry clamped into the pool (as XLA clamps a gather), and
// a slot's live keys: its kv_len clamped to the block table's width, so
// key j < live_keys reads table entry j / ps < mp.
LP_HD inline int clamp_page(int id, int n_pages) {
  return id < 0 ? 0 : id > n_pages - 1 ? n_pages - 1 : id;
}
LP_HD inline int live_keys(int kv_len, int mp, int ps) {
  const int cap = mp * ps, n = kv_len < cap ? kv_len : cap;
  return n > 0 ? n : 0;
}

// The plan of one call, from what the host knows: the shapes, the
// longest live length, `live` keys (the caller's bound on kv_lens, or
// the block table's whole width), and `kvh`, the KV heads the CTAs are
// counted for (the call's own, or the whole model's when a
// tensor-parallel rank launches its share of them, so that each head
// is split, and sums, as in the single-device launch); `rpt` the rows a
// warp of the instance (8·rpt a block, padded).
//   * split: doubled from 1 while the doubled grid still holds no more
//     CTAs than two a multiprocessor for the light one-row-a-warp CTAs,
//     one for heavier ones (every CTA pays a fixed chain of memory trips
//     and cluster barriers, so a second wave costs a whole CTA's
//     latency), or while a CTA's range would not fit the logits cache;
//     up to a cluster of kMaxSplit, never past the live pages (a CTA
//     takes whole pages);
//   * cache: the logits of a CTA's range while the CTA stays within
//     kCacheTarget bytes, else as many keys as fit there, in whole tiles
//     (a CTA whose range is longer recomputes q·k in every pass).
template <int KB, typename P>
inline Split plan(const P& p, int rpt, int rows_per_block, int blocks,
                  int live, int kvh, int n_sms) {
  using lutk::kWarps;
  Split s{1, rows_per_block, 0, 1, kStages};
  auto bytes = [&](int keys) {
    s.cache_keys = keys;
    return layout<KB>(p, kWarps * rpt, s).total;
  };
  const int pages = std::max((live + p.ps - 1) / p.ps, 1);
  auto range_keys = [&](int ns) { return (pages + ns - 1) / ns * p.ps; };
  const long long ctas = static_cast<long long>(p.B) * kvh * blocks;
  const int per_sm = rpt == 1 ? 2 : 1;
  while (s.n_split < kMaxSplit && 2 * s.n_split <= pages &&
         (2 * ctas * s.n_split <= static_cast<long long>(per_sm) * n_sms ||
          bytes(range_keys(s.n_split)) > kCacheTarget))
    s.n_split *= 2;
  int keys = range_keys(s.n_split);
  if (bytes(keys) > kCacheTarget) {
    const size_t base = bytes(0);
    keys = base < kCacheTarget
               ? int((kCacheTarget - base) / (kWarps * rpt * 4)) / kTile * kTile
               : 0;
  }
  s.cache_keys = keys;
  return s;
}

// The dense split route's plan.  The host knows the live length exactly
// (the call's kv_len), so
//   * split: doubled from 1 while every rank keeps two 32-key tiles or
//     more and the doubled grid still holds no more than kDensePerSm
//     CTAs a multiprocessor on average, up to a cluster of
//     kDenseMaxSplit (on an H100 (700 W) at Whisper's cross-attention
//     decode step, clusters of 8 took 0.0386–0.0539 ms, of 4
//     0.0240–0.0423, of 2 0.0259–0.0310: tools/tile_variants.py);
//   * key slices: the fewest ring stages a rank's range takes with as
//     many slices as the block's rows leave warps for (8 / rows), then
//     the fewest slices that still take that few (no warp left idle in
//     the last stage when it can be helped);
//   * ring and cache: the whole range's logits where they fit, and the
//     deepest ring (at most the walk's items, K and V stages of every
//     pass, and kStages) within kDenseTarget bytes a CTA and the grid's
//     average share of a multiprocessor (so that it runs in one wave);
//     past that, fewer slices, then no cache.
template <int KB, typename P>
inline Split plan_dense(const P& p, int rpt, int rows_per_block, int blocks,
                        int live, int kvh, int n_sms) {
  using lutk::kWarps;
  Split s{1, rows_per_block, 0, 1, 2};
  const int tiles = std::max((live + kTile - 1) / kTile, 1);
  const long long ctas = static_cast<long long>(p.B) * kvh * blocks;
  while (s.n_split < kDenseMaxSplit && 4 * s.n_split <= tiles &&
         2 * ctas * s.n_split <= static_cast<long long>(kDensePerSm) * n_sms)
    s.n_split *= 2;
  const int range = (tiles + s.n_split - 1) / s.n_split;  // the longest
  const size_t limit =
      std::min<size_t>(kDenseTarget, wave_smem(ctas * s.n_split, n_sms));
  auto bytes = [&](int ws, int depth, bool cache) {
    s.warp_split = ws;
    s.stages = depth;
    s.cache_keys = cache ? range * kTile : 0;
    return layout<KB>(p, kWarps * rpt, s).total;
  };
  const int ws_max = rpt == 1 ? std::min(kWarps / rows_per_block, range) : 1;
  const int steps_min = (range + ws_max - 1) / ws_max;
  for (int cache = 1; cache >= 0; --cache)
    for (int ws = (range + steps_min - 1) / steps_min; ws >= 1; --ws) {
      const int steps = (range + ws - 1) / ws;
      const int items = (cache ? 2 : p.fused ? 3 : 4) * steps;
      for (int depth = std::min(kStages, std::max(items, 2)); depth >= 2;
           --depth)
        if (bytes(ws, depth, cache) <= limit) return s;
    }
  bytes(1, 2, false);
  return s;
}

// The query-row instances a launcher holds (RPT: 8·RPT rows a block), in
// ascending order: a call takes the smallest that holds its blocks' rows.
template <int... RPTs>
struct Rows {};
constexpr Rows<1> kDecodeRows{};      // csrc/paged_decode.cu
constexpr Rows<1, 2> kPrefillRows{};  // csrc/paged_prefill.cu
constexpr Rows<1, 2> kSplitRows{};    // csrc/lut_attention.cu, route split

// A whole launch of the split-key body (paged::run): the rows and blocks,
// the instance, the plan, the grid (n_split, blocks · KVH, B) launched as
// clusters of n_split, the threads and the shared memory.  `rpt` is 0
// when no instance holds the rows (the launcher refuses the call).
struct Launch {
  Split split;
  int rpt, rows, blocks, live, kvh;
  int grid_x, grid_y, grid_z, cluster, threads;
  size_t smem;
};

template <int KB, typename P, int... RPTs>
inline Launch launch_plan(const P& p, bool dense, Rows<RPTs...>,
                          int max_kv_len, int plan_kv_heads, int n_sms) {
  using lutk::kWarps;
  constexpr int kCap = kWarps * std::max({RPTs...});
  Launch L{};
  L.rows = p.H / p.KVH * p.C;
  // the KV head's rows in the fewest blocks of at most kCap, evened out
  const int blocks = (L.rows + kCap - 1) / kCap;
  const int rpb = (L.rows + blocks - 1) / blocks;
  const int cap = p.mp * p.ps;
  L.live = max_kv_len > 0 && max_kv_len < cap ? max_kv_len : cap;
  L.kvh = plan_kv_heads > 0 ? plan_kv_heads : p.KVH;
  for (int r : {RPTs...})
    if (!L.rpt && rpb <= kWarps * r) L.rpt = r;
  if (!L.rpt) return L;
  L.blocks = (L.rows + rpb - 1) / rpb;
  L.split = dense ? plan_dense<KB>(p, L.rpt, rpb, L.blocks, L.live, L.kvh,
                                   n_sms)
                  : plan<KB>(p, L.rpt, rpb, L.blocks, L.live, L.kvh, n_sms);
  L.smem = layout<KB>(p, kWarps * L.rpt, L.split).total;
  L.grid_x = L.split.n_split;
  L.grid_y = L.blocks * p.KVH;
  L.grid_z = p.B;
  L.cluster = L.split.n_split;
  L.threads = lutk::kThreads;
  return L;
}

}  // namespace paged

namespace plan {

// The shapes a plan reads (the fields of lutk::Params it uses).
struct Shape {
  int B, H, KVH, C, Dh, n_pages, ps, mp, n_main, aux_rows, aux_cols, fused;
};

// A plan as the `<name>_plan` entries return it: kOut int64 fields.
enum Field {
  kNSplit, kRowsPerBlock, kCacheKeys, kWarpSplit, kStagesOut, kSmem, kGridX,
  kGridY, kGridZ, kCluster, kThreadsOut, kRpt, kOut
};

inline void put(long long* out, int n_split, int rpb, int cache_keys,
                int warp_split, int stages, size_t smem, int gx, int gy,
                int gz, int cluster, int threads, int rpt) {
  const long long v[kOut] = {n_split, rpb, cache_keys, warp_split, stages,
                             static_cast<long long>(smem), gx, gy, gz,
                             cluster, threads, rpt};
  for (int i = 0; i < kOut; ++i) out[i] = v[i];
}

// The split-key body's launch for key elements of `kb` bytes; 1 (the
// cudaErrorInvalidValue of the launchers) when no instance takes it.
template <int... RPTs>
inline int split_plan(const Shape& s, bool dense, paged::Rows<RPTs...> rows,
                      int kb, int max_kv_len, int plan_kv_heads, int n_sms,
                      long long* out) {
  paged::Launch L;
  if (kb == 1)
    L = paged::launch_plan<1>(s, dense, rows, max_kv_len, plan_kv_heads,
                              n_sms);
  else if (kb == 2)
    L = paged::launch_plan<2>(s, dense, rows, max_kv_len, plan_kv_heads,
                              n_sms);
  else if (kb == 4)
    L = paged::launch_plan<4>(s, dense, rows, max_kv_len, plan_kv_heads,
                              n_sms);
  else
    return 1;
  if (!L.rpt) return 1;
  put(out, L.split.n_split, L.split.rows_per_block, L.split.cache_keys,
      L.split.warp_split, L.split.stages, L.smem, L.grid_x, L.grid_y,
      L.grid_z, L.cluster, L.threads, L.rpt);
  return 0;
}

// The `<name>_plan` entries' bodies.  `in` holds the call's ints in the
// order each names; `out` kOut fields.  Return 0, or 1 for a call the
// launcher refuses.
//
// Paged decode / prefill: dtype (0 f32, 1 bf16), int8, B, H, KVH, C, Dh,
// n_pages, ps, mp, n_main, aux_rows, aux_cols, max_kv_len, plan_kv_heads,
// n_sms.
constexpr int kPagedIn = 16;
template <int... RPTs>
inline int paged_entry(paged::Rows<RPTs...> rows, const int* in, int n_in,
                       long long* out, int n_out) {
  if (n_in != kPagedIn || n_out < kOut) return 1;
  const Shape s{in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9],
                in[10], in[11], in[12], 0};
  const int kb = in[1] ? 1 : in[0] == 0 ? 4 : 2;
  return split_plan(s, false, rows, kb, in[13], in[14], in[15], out);
}

// Dense LUT attention: route (0 rows, 1 tiles, 2 split), dtype, B, H,
// KVH, Lq, Lk, Dh, kv_len, fused, n_main, aux_rows, aux_cols, n_sms.  The
// split route is the paged body over contiguous keys (lut_attention_
// launch: n_pages B·KVH, ps Lk, mp 1, C Lq), planned for kv_len keys (an
// empty cache as one).
constexpr int kDenseIn = 14;
inline int dense_entry(const int* in, int n_in, long long* out, int n_out) {
  if (n_in != kDenseIn || n_out < kOut) return 1;
  const int route = in[0], dtype = in[1], kv_len = in[8];
  const Shape s{in[2], in[3], in[4], in[5], in[7], in[2] * in[4], in[6], 1,
                in[10], in[11], in[12], in[9]};
  if (route == 2)
    return split_plan(s, true, paged::kSplitRows, dtype == 0 ? 4 : 2,
                      kv_len > 0 ? kv_len : 1, 0, in[13], out);
  if (route == 1) {
    const size_t smem = tiles::tile_dh(s.Dh) == 64
                            ? tiles::lut_smem<64>(s)
                            : tiles::lut_smem<128>(s);
    put(out, 1, tiles::kBM, 0, 1, tiles::kStages, smem,
        (s.C + tiles::kBM - 1) / tiles::kBM, s.H, s.B, 1, tiles::kThreads, 0);
    return 0;
  }
  if (route != 0) return 1;
  const int R = lutk::dense_rows(s.C);
  const bool cached = lutk::smem_bytes(s, R, true) <= lutk::kCacheSmemBudget;
  put(out, 1, R, cached ? s.mp * s.ps : 0, 1, 0,
      lutk::smem_bytes(s, R, cached), (s.C + R - 1) / R, s.H, s.B, 1,
      lutk::kThreads, 0);
  return 0;
}

// Exact flash attention: route (0 simt, 1 tiles), B, H, Lq, D.
constexpr int kFlashIn = 5;
inline int flash_entry(const int* in, int n_in, long long* out, int n_out) {
  if (n_in != kFlashIn || n_out < kOut) return 1;
  const int route = in[0], B = in[1], H = in[2], Lq = in[3], D = in[4];
  if (route == 1) {
    put(out, 1, tiles::kBM, 0, 1, tiles::kStages,
        tiles::tile_dh(D) == 64 ? tiles::smem_bytes<64>()
                                : tiles::smem_bytes<128>(),
        (Lq + tiles::kBM - 1) / tiles::kBM, H, B, 1, tiles::kThreads, 0);
    return 0;
  }
  if (route != 0) return 1;
  put(out, 1, flash::kBQ, 0, 1, 0, flash::simt_smem(D),
      (Lq + flash::kBQ - 1) / flash::kBQ, H, B, 1, flash::kThreads, 0);
  return 0;
}

// Row softmax: route (0 warp, 1 cta), vec, stages, threads, esize, cols,
// n_main, aux_rows, aux_cols (the host's plan: lut_softmax.row_plan).
// kSmem is the least shared memory the launcher accepts for that plan.
constexpr int kRowIn = 9;
struct RowTables {
  int n_main, aux_rows, aux_cols;
};
inline int row_entry(const int* in, int n_in, long long* out, int n_out) {
  if (n_in != kRowIn || n_out < kOut) return 1;
  const RowTables t{in[6], in[7], in[8]};
  put(out, 1, 0, 0, 1, in[2],
      rowsm::smem_floor(t, in[0], in[1], in[2], in[3], in[4], in[5]), 0, 0,
      0, 1, in[3], 0);
  return 0;
}

// The limits the plans keep, in this order (launch_plan_constants).
constexpr long long kConstants[] = {
    static_cast<long long>(paged::kSmemLimit),
    static_cast<long long>(paged::kSmPool),
    static_cast<long long>(paged::kCtaReserve),
    paged::kMaxSplit,
    paged::kDenseMaxSplit,
    static_cast<long long>(paged::kCacheTarget),
    static_cast<long long>(paged::kDenseTarget),
    static_cast<long long>(rowsm::kSmemLimit),
    static_cast<long long>(rowsm::kCtaHead),
    static_cast<long long>(lutk::kCacheSmemBudget),
};

}  // namespace plan
