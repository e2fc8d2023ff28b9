#!/usr/bin/env python3
"""A/B variants of the port's tensor-core tile kernels on one NVIDIA GPU.

    PYTHONPATH=src python3 tools/tile_variants.py [WORD]

Builds the committed kernels (``build.build``) and, beside them, variants
made from copies of ``src/repro_torch/csrc`` with one textual change each
(``VARIANTS``), all ``nvcc`` processes at once; then, on the same inputs,
times each variant's tile route against the committed one and holds its
results to the plain versions:

* flash attention (bf16) at ``chip_smoke.FLASH_CASES``' shapes — out,
  m and l against ``flash_attention_plain``, plus a causal case whose
  rows see a few far-apart logits (out within 2e-5 is the limit there);
  times at the Whisper encoder's and Qwen3-32B's causal prefill shapes;
* dense LUT attention (bf16, every mode) at the Whisper encoder's shape
  (B=4, H=12, L=1500, Dh=64) — times, and the tile route against the simt
  route;
* the dense kernel's split route (variants named "split") at the
  few-row shapes of ``chip_smoke.DENSE_CASES`` and 4- and 8-row cross calls —
  times (fused REXP without a kv_len, faithful with one), and the
  distance from the plain version;
* the row-wise LUT softmax (variants named "rows") at ``chip_smoke.
  ROW_SHAPES`` (Whisper's encoder logits, Qwen3-32B's causal prefill
  logits; the warp route) and at 4096 rows of 16 384 columns (the cta
  route) in f32 and bf16, REXP and 2D-LUT uint8 — the parent commit's
  kernel against this tree's in the order parent, change, change,
  parent on the same tensors, each output ``torch.equal`` to the
  other's, beside ``torch.softmax`` and the bound; then each variant's
  time and whether it is still ``torch.equal`` to the committed build;
* the CUDA-core routes (word "simt", no variants): the parent commit's
  dense route 0 and flash route 0 (the dense row engine and flash's
  first simt kernel before the CUDA-core tile engine took both) against
  this tree's simt routes, and the parent's route 0 with int16 tables
  against this tree's tile route, in the order parent, change, change,
  parent on the same tensors (``SIMT_CALLS``: the Whisper encoder in f32
  in every dense mode and in flash, the eval step's call in bf16 with
  int16 tables, Jamba's prompt call in f32, flash f32 at
  ``chip_smoke.FLASH_CASES``), with the largest difference between the
  two outputs, exact SDPA on the same inputs (f32: TF32 off) and the
  bound; then the simt variants (``"simt: …"``: ring slots, unrolling;
  what-ifs that take the exp, a product, the copies or the LUT work out)
  at the Whisper encoder in f32, flash and fused / faithful REXP.

With WORD, only the variants whose name holds it are built and run, and
only the sections they belong to.  A variant whose text is not found in
the source fails the run: the variants name the committed choices they
replace.  Times are medians of 20 L2-cold calls (``chip_smoke.device_ms``).

The parent's kernels are built from ``build/parent_rows/`` (the parent
commit's whole ``src/repro_torch/csrc``), which ``--fetch-parent [REV]``
fills with ``git show REV:...`` (REV defaults to ``HEAD~1``, the parent
of a committed change; ``HEAD`` for a change not yet committed), and
called through this tree's wrappers (their C entry points take the same
arguments).  It needs git and no card, so run it before copying the tree
to a machine without ``.git``:

    python3 tools/tile_variants.py --fetch-parent HEAD
    PYTHONPATH=src python3 tools/tile_variants.py rows
    PYTHONPATH=src python3 tools/tile_variants.py simt
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.core.policies import SoftmaxPolicy  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.common import kernel_tables  # noqa: E402
from repro_torch.kernels.lut_softmax import lut_softmax as LSM  # noqa: E402

FLASH_BOUNDS = ("__launch_bounds__(tiles::kThreads, DH <= 64 ? 3 : 1)\n"
                "    flash_attention_tiles_kernel")
DENSE_BOUNDS = ("__launch_bounds__(tiles::kThreads)\n"
                "    lut_attention_tiles_kernel")

RING = "constexpr int kStages = 2;"
ATTN = "paged_attn.cuh"
#: the launch plans' header (the constants and plans the launchers read)
PLAN = "launch_plan.h"
MAX_SPLIT = "constexpr int kDenseMaxSplit = 4;"
SHARE = "const long long per_sm = (ctas + n_sms - 1) / n_sms;"
HALVES = "Keys::kDense && NV == 1 && p.Dh <= 64 ? 2 : 1;"
RANKS = "4 * s.n_split <= tiles &&"
TARGET = "constexpr size_t kDenseTarget = 64 * 1024;"
ROWS = "lut_softmax.cu"
PREFETCH = "constexpr int kPrefetchMaxBytes = 2;"
SIMT = "simt_tiles.cuh"
SIMT_BOUNDS = "__launch_bounds__(simt::kThreads, 1)"
BOTH = ("lut_attention", "flash_attention")
QK_LOOP = "#pragma unroll 2\n  for (int c = 0; c < nc; ++c) {"
PV_LOOP = "#pragma unroll 8\n  for (int j = 0; j < kKeys; ++j) {"
#: where the parent's kernel sources go (``--fetch-parent``)
PARENT_ROWS = Path(__file__).resolve().parents[1] / "build" / "parent_rows"


#: variant → (kernel, [(source file, committed text, variant text), ...]
#: [, {name in kernels/lut_softmax/lut_softmax.py: value for the
#: variant}])
VARIANTS = {
    "flash: 2 pieces of p": ("flash_attention", [
        ("flash_attention.cu", "constexpr int kPieces = 3;",
         "constexpr int kPieces = 2;")]),
    "flash: registers uncapped": ("flash_attention", [
        ("flash_attention.cu", FLASH_BOUNDS,
         FLASH_BOUNDS.replace("DH <= 64 ? 3 : 1", "1"))]),
    "flash: 3-stage ring": ("flash_attention", [
        (PLAN, RING, RING.replace("2", "3"))]),
    "flash: 4-stage ring": ("flash_attention", [
        (PLAN, RING, RING.replace("2", "4"))]),
    "dense: 3 blocks an SM": ("lut_attention", [
        ("lut_attention.cu", DENSE_BOUNDS,
         DENSE_BOUNDS.replace("kThreads)", "kThreads, 3)"))]),
    "dense: 3-stage ring": ("lut_attention", [
        (PLAN, RING, RING.replace("2", "3"))]),
    "dense: 4-stage ring": ("lut_attention", [
        (PLAN, RING, RING.replace("2", "4"))]),
    # what-ifs that take work out to see what it costs: their results are
    # wrong by design, so read only their times
    "what-if, flash: 1 piece of p": ("flash_attention", [
        ("flash_attention.cu", "constexpr int kPieces = 3;",
         "constexpr int kPieces = 1;")]),
    "what-if, flash: no exp": ("flash_attention", [
        ("flash_attention.cu", "expf(__fsub_rn(s, m_safe[i >> 1]))",
         "__fsub_rn(s, m_safe[i >> 1])")]),
    # the dense kernel's split route (paged_attn.cuh's plan_dense)
    "split: clusters of at most 8": ("lut_attention", [
        (PLAN, MAX_SPLIT, MAX_SPLIT.replace("4", "8"))]),
    "split: clusters of at most 2": ("lut_attention", [
        (PLAN, MAX_SPLIT, MAX_SPLIT.replace("4", "2"))]),
    "split: a spare CTA slot an SM": ("lut_attention", [
        (PLAN, SHARE, SHARE.replace("n_sms;", "n_sms + 1;"))]),
    "split: σ·V on 16 lanes at Dh 64": ("lut_attention", [
        (ATTN, HALVES, HALVES.replace("p.Dh <= 64", "p.Dh < 0"))]),
    "split: ranks of one tile or more": ("lut_attention", [
        (PLAN, RANKS, RANKS.replace("4 *", "2 *"))]),
    "split: CTAs of up to 112 KB": ("lut_attention", [
        (PLAN, TARGET, TARGET.replace("64", "112"))]),
    # the committed build, timed without the L2 flush
    "what-if, split: L2 warm": ("lut_attention", []),
    "what-if, split: no keys (the fixed cost)": ("lut_attention", [
        (ATTN, "nt = (nkeys + span - 1) / span;", "nt = 0;")]),
    "what-if, split: no exchange between CTAs": ("lut_attention", [
        (ATTN, "cluster.map_shared_rank(table, lane)", "table"),
        (ATTN, "cluster.map_shared_rank(part_s, owner)", "part_s")]),
    "what-if, split: no q·k": ("lut_attention", [
        (ATTN, "for (int c0 = 0; c0 < 16 * NV; c0 += 2) {",
         "for (int c0 = 0; c0 < 0; c0 += 2) {")]),
    "what-if, split: no σ·V": ("lut_attention", [
        (ATTN, "for (int k0 = 0; k0 < n; k0 += A * halves) {",
         "for (int k0 = 0; k0 < 0; k0 += A * halves) {")]),
    "what-if, split: no copies": ("lut_attention", [
        (ATTN, "if (item >= n_items) return;", "return;")]),
    # the CUDA-core tile engine (csrc/simt_tiles.cuh, both simt routes)
    "simt: 128 rows a block at Dh 64": (BOTH, [
        (PLAN, "return DH <= 64 ? 96 : DH <= 128 ? 128 : 64;",
         "return DH <= 128 ? 128 : 64;")]),
    "simt: 2 blocks an SM at Dh 64, 96 rows × 64 keys": (BOTH, [
        (PLAN, "return DH <= 64 ? 128 : 64; }", "return 64; }"),
        ("lut_attention.cu", SIMT_BOUNDS, SIMT_BOUNDS.replace(
            "1)", "DH <= 64 ? 2 : 1)")),
        ("flash_attention.cu", SIMT_BOUNDS, SIMT_BOUNDS.replace(
            "1)", "DH <= 64 ? 2 : 1)"))]),
    "simt: 2 blocks an SM at Dh 64, 64 rows × 96 keys": (BOTH, [
        (PLAN, "return DH <= 64 ? 96 : DH <= 128 ? 128 : 64;",
         "return DH <= 128 ? (DH <= 64 ? 64 : 128) : 64;"),
        (PLAN, "return DH <= 64 ? 128 : 64; }",
         "return DH <= 64 ? 96 : 64; }"),
        ("lut_attention.cu", SIMT_BOUNDS, SIMT_BOUNDS.replace(
            "1)", "DH <= 64 ? 2 : 1)")),
        ("flash_attention.cu", SIMT_BOUNDS, SIMT_BOUNDS.replace(
            "1)", "DH <= 64 ? 2 : 1)"))]),
    "simt: 384 threads, 96 rows a block at Dh 64": (BOTH, [
        (PLAN, "constexpr int kThreads = 256;",
         "constexpr int kThreads = 384;"),
        (PLAN, "return DH <= 64 ? 96 : DH <= 128 ? 128 : 64;",
         "return DH <= 64 ? 96 : DH <= 128 ? 144 : 48;")]),
    "simt: 384 threads, 144 rows a block at Dh 64": (BOTH, [
        (PLAN, "constexpr int kThreads = 256;",
         "constexpr int kThreads = 384;"),
        (PLAN, "return DH <= 64 ? 96 : DH <= 128 ? 128 : 64;",
         "return DH <= 64 ? 144 : DH <= 128 ? 144 : 48;")]),
    "simt: a ring of 3 slots": (BOTH, [
        (PLAN, "constexpr int kSlots = 2;", "constexpr int kSlots = 3;")]),
    "simt: q·k unrolled by 4": (BOTH, [
        (SIMT, QK_LOOP, QK_LOOP.replace("unroll 2", "unroll 4"))]),
    "simt: q·k not unrolled": ("flash_attention", [
        (SIMT, QK_LOOP, QK_LOOP.replace("unroll 2", "unroll 1"))]),
    "simt: p·V unrolled by 4": ("flash_attention", [
        (SIMT, PV_LOOP, PV_LOOP.replace("unroll 8", "unroll 4"))]),
    "what-if, simt: no exp": ("flash_attention", [
        ("flash_attention.cu", "expf(__fsub_rn(S[i][jj], m_safe))",
         "__fsub_rn(S[i][jj], m_safe)")]),
    "what-if, simt: no q·k": ("flash_attention", [
        (SIMT, QK_LOOP, QK_LOOP.replace("c < nc", "c < 0"))]),
    "what-if, simt: no p·V": ("flash_attention", [
        (SIMT, PV_LOOP, PV_LOOP.replace("j < kKeys", "j < 0"))]),
    "what-if, simt: no copies": ("flash_attention", [
        (SIMT, "    if (u < items) {", "    if (u < 0) {")]),
    "what-if, simt: no σ lookup": ("lut_attention", [
        ("lut_pipeline.cuh", "  const bool rexp = p.method == kRexp;",
         "  return e;\n  const bool rexp = p.method == kRexp;")]),
    "what-if, simt: no LUT work": ("lut_attention", [
        ("lut_pipeline.cuh", "  const float e = float(lut_main[",
         "  return fminf(d, 1.f);\n  const float e = float(lut_main["),
        ("lut_pipeline.cuh", "  const bool rexp = p.method == kRexp;",
         "  return e;\n  const bool rexp = p.method == kRexp;")]),
    # the row softmax (csrc/lut_softmax.cu); a third entry patches
    # kernels/lut_softmax/lut_softmax.py's plan constants for the variant
    "rows: 1 warp-route block an SM": ("lut_softmax", [],
                                       {"WARP_BLOCKS": 1}),
    "rows: one register bucket of 64": ("lut_softmax", [],
                                        {"PER_LANE": (64,)}),
    "rows: 128 threads a CTA": ("lut_softmax", [],
                                {"WARP_THREADS": 128, "WARP_BLOCKS": 4}),
    "rows: no prefetch": ("lut_softmax", [
        (PLAN, PREFETCH, PREFETCH.replace("2", "0"))],
        {"PREFETCH_MAX_ESIZE": 0}),
    "rows: f32 rows prefetched too": ("lut_softmax", [
        (PLAN, PREFETCH, PREFETCH.replace("2", "4"))],
        {"PREFETCH_MAX_ESIZE": 4}),
    "rows: long rows re-read, not staged": ("lut_softmax", [
        (ROWS, "  const int tid = threadIdx.x, nt = blockDim.x;\n  const "
         "unsigned row_bytes", "  stages = 0;\n  const int tid = "
         "threadIdx.x, nt = blockDim.x;\n  const unsigned row_bytes")]),
    # the committed build, timed without the L2 flush
    "what-if, rows: L2 warm": ("lut_softmax", []),
    "what-if, rows: no stores": ("lut_softmax", [
        (ROWS, "        st_stream<V>(outr + (lane + 32 * i) * V, w);",
         "        if (w[0] == -1.f) st_stream<V>(outr + (lane + 32 * i) * "
         "V, w);")]),
    "what-if, rows: no table reads": ("lut_softmax", [
        (ROWS, "  const float e = main_rep[bin_index(d, p.round_mode, 0, "
         "p.n_main - 1) * 32 +\n                           lane];",
         "  const float e = float(bin_index(d, p.round_mode, 0, "
         "p.n_main - 1));"),
        (ROWS, "    s = aux[i * p.aux_cols + rs.col];",
         "    s = float(i + rs.col);")]),
    "what-if, dense: no LUT work": ("lut_attention", [
        ("lut_pipeline.cuh", "  const float e = float(lut_main[",
         "  return fminf(d, 1.f);\n  const float e = float(lut_main["),
        ("lut_pipeline.cuh", "  const bool rexp = p.method == kRexp;",
         "  return e;\n  const bool rexp = p.method == kRexp;")]),
}


def build_variants(out_dir: Path, variants) -> dict[str, dict]:
    """Build each variant ``{name: (kernels, [(file, committed text,
    variant text), ...])}`` — ``kernels`` one name of ``build.KERNELS`` or
    a tuple of them — from its own copy of ``csrc/``, one ``nvcc`` per
    kernel and variant, all at once; returns ``{name: {kernel: library}}``
    with every entry point's argument types set.  A substitution whose
    committed text is not in the file fails the run."""
    procs = {}
    for i, (name, (kernels, subs, *_)) in enumerate(variants.items()):
        d = out_dir / f"v{i}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        for file, old, new in subs:
            src = (d / file).read_text()
            if old not in src:
                raise SystemExit(f"{name}: {old!r} not in {file}")
            (d / file).write_text(src.replace(old, new))
        for kernel in (kernels,) if isinstance(kernels, str) else kernels:
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o",
                   str(d / f"lib{kernel}.so"), str(d / f"{kernel}.cu")]
            procs[(name, kernel)] = (d, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for (name, kernel), (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(d / f"lib{kernel}.so"))
        for fn, argtypes in build.KERNELS[kernel].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs.setdefault(name, {})[kernel] = lib
    return libs


def section(name: str) -> str:
    """The section of ``main`` that times variant ``name``."""
    kernel = VARIANTS[name][0]
    if "simt" in name:
        return "simt"
    if kernel == "lut_softmax":
        return "rows"
    if kernel == "flash_attention":
        return "flash"
    return "split" if "split" in name else "dense"


def fetch_parent(rev: str) -> None:
    """Write the parent commit's kernel sources into :data:`PARENT_ROWS`
    (``git show REV:...``; needs the git checkout)."""
    PARENT_ROWS.mkdir(parents=True, exist_ok=True)
    csrc = "src/repro_torch/csrc"
    names = subprocess.run(
        ["git", "ls-tree", "--name-only", f"{rev}:{csrc}"], cwd=cs.ROOT,
        check=True, capture_output=True, text=True).stdout.split()
    for name in names:
        src = subprocess.run(
            ["git", "show", f"{rev}:{csrc}/{name}"], cwd=cs.ROOT, check=True,
            capture_output=True, text=True).stdout
        (PARENT_ROWS / name).write_text(src)
    print(f"[variants] {rev}'s kernel sources in {PARENT_ROWS}")


def parent_libraries(kernels) -> dict[str, ctypes.CDLL]:
    """The parent's ``kernels``, built from :data:`PARENT_ROWS` with the
    tree's nvcc flags, all at once, with this tree's entry points'
    argument types."""
    if not (PARENT_ROWS / "launch_plan.h").exists():
        raise SystemExit(f"no parent sources in {PARENT_ROWS}: run "
                         f"tools/tile_variants.py --fetch-parent first")
    procs = {k: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o",
         str(PARENT_ROWS / f"lib{k}.so"), str(PARENT_ROWS / f"{k}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k in kernels}
    libs = {}
    for kernel, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"parent {kernel}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(PARENT_ROWS / f"lib{kernel}.so"))
        for fn, argtypes in build.KERNELS[kernel].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[kernel] = lib
    return libs


def p_c_c_p(kernel, lib, fn):
    """``fn``'s time with the parent's ``kernel`` library loaded, then
    with this tree's twice, then the parent's again (ms)."""
    mine = build._loaded[kernel]
    order = []
    for who in ("parent", "change", "change", "parent"):
        build._loaded[kernel] = lib if who == "parent" else mine
        order.append(cs.device_ms(fn))
    build._loaded[kernel] = mine
    return order


def rows_section(names, use):
    """The parent's row kernel against this tree's (P C C P) at the
    smoke's full-width row shapes, then the row variants."""
    lib = parent_libraries(("lut_softmax",))["lut_softmax"]
    shapes = {**cs.ROW_SHAPES, "long rows": ((4096, 16384), False)}
    inputs = {(name, dt): cs.row_logits(shape, causal, dt, seed=8)
              for name, (shape, causal) in shapes.items()
              for dt in (torch.float32, torch.bfloat16)}
    pols = {impl: SoftmaxPolicy(impl=impl, precision="uint8")
            for impl in cs.ROW_KERNELS}
    use("committed")
    mine = build._loaded["lut_softmax"]
    for (name, dt), x in inputs.items():
        b_ms, b_by = cs.row_bound(x.numel(), dt)
        lib_ms = cs.device_ms(lambda: torch.softmax(x, dim=-1))
        for impl, (kernel, _) in cs.ROW_KERNELS.items():
            tables = cs.ops._tables_for(pols[impl])
            # the plan for an output at a fresh allocation's alignment
            plan = LSM.plan_for(x, torch.empty(1, device="cuda"),
                                *kernel_tables(impl, tables, "round",
                                               x.device)[:2])
            build._loaded["lut_softmax"] = lib
            theirs = kernel(x, tables)
            build._loaded["lut_softmax"] = mine
            same = torch.equal(kernel(x, tables), theirs)
            order = p_c_c_p("lut_softmax", lib,
                            lambda: kernel(x, tables))
            print(f"[variants] rows {impl} {name} {str(dt)[6:]}: parent "
                  f"{order[0]:.4f} / {order[3]:.4f} ms, change "
                  f"{order[1]:.4f} / {order[2]:.4f} ms (route {plan.route},"
                  f" vec {plan.vec}, per_lane {plan.per_lane}, grid "
                  f"{plan.grid}); torch.softmax {lib_ms:.4f} ms; bound "
                  f"{b_ms:.4f} ms ({b_by}), change at "
                  f"{b_ms / min(order[1:3]):.1%} of it; torch.equal to the "
                  f"parent {same}")
    refs = {key: {impl: cs.ROW_KERNELS[impl][0](
        x, cs.ops._tables_for(pols[impl])) for impl in pols}
        for key, x in inputs.items()}
    for name in [n for n in names if section(n) == "rows"]:
        use(name)
        line = []
        for (case, dt), x in inputs.items():
            for impl, (kernel, _) in cs.ROW_KERNELS.items():
                tables = cs.ops._tables_for(pols[impl])
                ms = cs.device_ms(lambda: kernel(x, tables),
                                  cold="L2 warm" not in name)
                same = torch.equal(kernel(x, tables), refs[(case, dt)][impl])
                line.append(f"{impl} {case} {str(dt)[6:]} {ms:.4f} ms"
                            f"{'' if same else ' (not equal)'}")
        print(f"[variants] rows, {name}: " + ", ".join(line))
    use("committed")


def flash_section(names, use, rng):
    """Flash's tile route: the committed build and its variants."""
    flash = {}
    for name, b, h, kvh, lq, lk, dh, causal in cs.FLASH_CASES:
        qkv = [torch.as_tensor(rng.standard_normal(s, dtype=np.float32),
                               device="cuda").to(torch.bfloat16)
               for s in ((b, h, lq, dh), (b, kvh, lk, dh), (b, kvh, lk, dh))]
        flash[name] = (qkv, causal,
                       cs.flash_attention_plain(*qkv, causal=causal))
    # rows that see a few far-apart logits: p·V leans on few p
    q = torch.zeros(1, 1, 64, 64, device="cuda")
    k = torch.zeros(1, 1, 64, 64, device="cuda")
    q[..., 0] = 1.0
    k[0, 0, :, 0] = torch.linspace(-8, 8, 64, device="cuda")
    v = torch.as_tensor(rng.standard_normal((1, 1, 64, 64),
                                            dtype=np.float32) * 4,
                        device="cuda")
    peaked = [x.to(torch.bfloat16) for x in (q, k, v)]
    flash["few far-apart logits"] = (
        peaked, True, cs.flash_attention_plain(*peaked, causal=True))
    for name in ["committed"] + [n for n in names
                                 if VARIANTS[n][0] == "flash_attention"]:
        use(name)
        errs = []
        for case, (qkv, causal, (ro, rm, rl)) in flash.items():
            o, m, l = cs.flash_attention_cuda(*qkv, causal=causal,
                                              route="tiles")
            seen = torch.isfinite(rm)
            m_rel = ((m - rm).abs() / rm.abs().clamp(min=1e-30))[seen]
            l_rel = ((l - rl).abs() / rl)[seen]
            errs.append(f"{case} {float((o - ro).abs().max()):.3g} / "
                        f"{float(m_rel.max()):.3g} / {float(l_rel.max()):.3g}")
        times = {case: cs.device_ms(lambda: cs.flash_attention_cuda(
            *flash[case][0], causal=flash[case][1], route="tiles"))
            for case in ("whisper encoder", "qwen3 prefill")}
        print(f"[variants] flash tiles, {name}: "
              + ", ".join(f"{c} {t:.4f} ms" for c, t in times.items())
              + "; out max|err| / m rel / l rel: " + "; ".join(errs))

def split_section(names, use, rng):
    """The dense kernel's split route at its few-row shapes."""
    split_cases = {}
    for case in [c for c in cs.DENSE_CASES if c[4] < cs.MIN_TILE_ROWS] + [
            ("cross, 4 rows", cs.W_BATCH, cs.W_H, cs.W_H, 4, cs.W_LENC,
             cs.W_DH, False, None),
            ("cross, 8 rows", cs.W_BATCH, cs.W_H, cs.W_H, 8, cs.W_LENC,
             cs.W_DH, False, None)]:
        name, b, h, kvh, lq, lk, dh, causal, kv_len = case
        split_cases[name] = (cs.dense_problem(rng, b, h, kvh, lq, lk, dh,
                                              torch.bfloat16, False),
                             causal, kv_len)
    for name in ["committed"] + [n for n in names if "split" in n]:
        use(name)
        line = []
        for case, (qkv, causal, kv_len) in split_cases.items():
            mode = "rexp_fused" if kv_len is None else "rexp"
            ms = cs.device_ms(lambda: cs.dense_call(
                cs.lut_attention_cuda, mode, *qkv, causal, kv_len,
                route="split"), cold="L2 warm" not in name)
            err = float((cs.dense_call(cs.lut_attention_cuda, mode, *qkv,
                                       causal, kv_len, route="split")
                         - cs.dense_call(cs.lut_attention_plain, mode, *qkv,
                                         causal, kv_len)).abs().max())
            line.append(f"{case} {ms:.4f} ms (– plain {err:.3g})")
        print(f"[variants] dense split, {name}: " + ", ".join(line))

def dense_section(names, use, rng):
    """The dense kernel's tile route at the Whisper encoder."""
    q, k, v = cs.dense_problem(rng, cs.W_BATCH, cs.W_H, cs.W_H, cs.W_LENC,
                               cs.W_LENC, cs.W_DH, torch.bfloat16, False)
    for name in ["committed"] + [n for n in names
                                 if VARIANTS[n][0] == "lut_attention"
                                 and "split" not in n]:
        use(name)
        line = []
        for mode in cs.MODES:
            def call(route):
                return cs.dense_call(cs.lut_attention_cuda, mode, q, k, v,
                                     False, None, route=route)
            ms = cs.device_ms(lambda: call("tiles"))
            err = float((call("tiles") - call("simt")).abs().max())
            line.append(f"{mode} {ms:.4f} ms (tiles – simt {err:.3g})")
        print(f"[variants] dense tiles at the Whisper encoder, {name}: "
              + ", ".join(line))

#: (name, B, H, KVH, Lq, Lk, Dh, causal, kv_len, dtype, precision) — the
#: dense calls of the simt section: the parent's route 0 (its row engine)
#: against the route this tree's dispatcher picks
SIMT_CALLS = [
    ("encoder f32", cs.W_BATCH, cs.W_H, cs.W_H, cs.W_LENC, cs.W_LENC,
     cs.W_DH, False, None, torch.float32, "uint8"),
    ("eval int16", cs.T_BATCH, cs.H, cs.KVH, cs.T_SEQ, cs.T_SEQ, cs.DH,
     True, cs.T_SEQ, torch.bfloat16, "int16"),
    ("jamba prompt f32", 4, 32, 8, 64, 96, 128, True, 64, torch.float32,
     "uint8"),
]


def simt_section(names, use, rng):
    """The parent's dense route 0 and flash route 0 against this tree's
    routes, P C C P on the same tensors (``SIMT_CALLS``; flash f32 at the
    Whisper encoder and ``chip_smoke.FLASH_CASES``); then the simt
    variants at the Whisper encoder in f32."""
    use("committed")
    libs = parent_libraries(("lut_attention", "flash_attention"))
    for name, b, h, kvh, lq, lk, dh, causal, kv_len, dt, prec in SIMT_CALLS:
        q, k, v = cs.dense_problem(rng, b, h, kvh, lq, lk, dh, dt, False)
        pairs = cs.dense_pairs(lq, lk, causal, kv_len)
        live = lk if kv_len is None else kv_len
        b_ms, b_by = cs.dense_bound(b, h, kvh, lq, live, dh, dt, pairs)
        sdpa = cs.dense_sdpa_ms(q, k, v, causal, kv_len)
        modes = cs.MODES if prec == "uint8" else ("rexp", "lut2d")
        for mode in modes:
            route = cs.dense_route(dt, dh, lq, mode)

            def call(r):
                return cs.dense_call(cs.lut_attention_cuda, mode, q, k, v,
                                     causal, kv_len, precision=prec,
                                     route=r)
            # the parent's route 0 is its row engine
            mine = build._loaded["lut_attention"]
            build._loaded["lut_attention"] = libs["lut_attention"]
            theirs = call("simt")
            build._loaded["lut_attention"] = mine
            diff = float((call(route) - theirs).abs().max())
            del theirs
            order = p_c_c_p("lut_attention", libs["lut_attention"],
                            lambda: call(route if build._loaded[
                                "lut_attention"] is mine else "simt"))
            print(f"[variants] simt dense {name} {mode} {prec} "
                  f"B={b} H={h}/{kvh} Lq={lq} Lk={lk} kv_len={kv_len} "
                  f"Dh={dh}: parent rows {order[0]:.4f} / {order[3]:.4f} "
                  f"ms, change {route} {order[1]:.4f} / {order[2]:.4f} ms "
                  f"({min(order[0], order[3]) / min(order[1:3]):.2f}× the "
                  f"parent); exact SDPA {sdpa:.4f} ms; bound {b_ms:.4f} ms "
                  f"({b_by}), change at {b_ms / min(order[1:3]):.1%} of it;"
                  f" max|change – parent| {diff:.3g}")
        del q, k, v
    for name, b, h, kvh, lq, lk, dh, causal in cs.FLASH_CASES:
        q, k, v = (torch.as_tensor(rng.standard_normal(s, dtype=np.float32),
                                   device="cuda")
                   for s in ((b, h, lq, dh), (b, kvh, lk, dh),
                             (b, kvh, lk, dh)))
        pairs = cs.causal_pairs(lq, lk, causal)
        b_ms, b_by = cs.flash_bound(b, h, kvh, lq, lk, dh, torch.float32,
                                    pairs)
        kx, vx = (t.repeat_interleave(h // kvh, dim=1) for t in (k, v))
        sdpa = cs.device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, kx, vx, is_causal=causal))
        del kx, vx

        def call():
            return cs.flash_attention_cuda(q, k, v, causal=causal)
        mine = build._loaded["flash_attention"]
        build._loaded["flash_attention"] = libs["flash_attention"]
        theirs = call()
        build._loaded["flash_attention"] = mine
        diff = max(float((a - t).abs().max())
                   for a, t in zip(call(), theirs))
        del theirs
        order = p_c_c_p("flash_attention", libs["flash_attention"], call)
        print(f"[variants] simt flash {name} f32 B={b} H={h}/{kvh} Lq={lq} "
              f"Lk={lk} Dh={dh} causal={causal}: parent {order[0]:.4f} / "
              f"{order[3]:.4f} ms, change {order[1]:.4f} / {order[2]:.4f} "
              f"ms ({min(order[0], order[3]) / min(order[1:3]):.2f}× the "
              f"parent); SDPA f32 {sdpa:.4f} ms; bound {b_ms:.4f} ms "
              f"({b_by}), change at {b_ms / min(order[1:3]):.1%} of it; "
              f"max|change – parent| (out, m, l) {diff:.3g}")
        del q, k, v
    b, h, lq, dh = cs.W_BATCH, cs.W_H, cs.W_LENC, cs.W_DH
    q, k, v = cs.dense_problem(rng, b, h, h, lq, lq, dh, torch.float32, False)
    calls = {"flash": lambda: cs.flash_attention_cuda(q, k, v)[0],
             **{mode: (lambda mode=mode: cs.dense_call(
                 cs.lut_attention_cuda, mode, q, k, v, False, None))
                for mode in ("rexp_fused", "rexp")}}
    refs = {c: fn() for c, fn in calls.items()}
    for name in ["committed"] + [n for n in names if section(n) == "simt"]:
        use(name)
        kernels = VARIANTS.get(name, (BOTH,))[0]
        line = []
        for c, fn in calls.items():
            if ("flash" if c == "flash" else "lut") not in str(kernels):
                continue
            ms = cs.device_ms(fn)
            err = float((fn() - refs[c]).abs().max())
            line.append(f"{c} {ms:.4f} ms (– committed {err:.3g})")
        print(f"[variants] simt f32 at the Whisper encoder, {name}: "
              + ", ".join(line))
    use("committed")


def main(word: str = "", rev: str = "HEAD~1") -> int:
    if word == "--fetch-parent":
        fetch_parent(rev)
        return 0
    if not torch.cuda.is_available():
        print("tile_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[variants] {cs.gpu_line()}")
    build.build()
    committed = {k: build.load(k, next(iter(build.KERNELS[k])))
                 and build._loaded[k]
                 for k in ("flash_attention", "lut_attention", "lut_softmax")}
    plan_defaults = {k: getattr(LSM, k)
                     for k in ("PER_LANE", "WARP_THREADS", "WARP_BLOCKS",
                               "PREFETCH_MAX_ESIZE")}
    names = [n for n in VARIANTS if word in n]
    libs = build_variants(cs.ROOT / "build" / "variants",
                          {n: VARIANTS[n] for n in names})

    def use(name):
        build._loaded.update(committed)
        build._loaded.update(libs.get(name, {}))
        patch = VARIANTS[name][2] if len(VARIANTS.get(name, ())) > 2 else {}
        for key, value in {**plan_defaults, **patch}.items():
            setattr(LSM, key, value)

    sections = ({section(n) for n in names} if word
                else {"flash", "split", "dense", "rows", "simt"})
    rng = np.random.default_rng(0)
    if "simt" in sections:
        simt_section(names, use, rng)
    if "flash" in sections:
        flash_section(names, use, rng)
    if "split" in sections:
        split_section(names, use, rng)
    if "dense" in sections:
        dense_section(names, use, rng)
    if "rows" in sections:
        rows_section(names, use)
    use("committed")
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
