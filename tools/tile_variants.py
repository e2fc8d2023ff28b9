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
  (B=4, H=12, L=1500, Dh=64) — times, and the tile route against the row
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
  time and whether it is still ``torch.equal`` to the committed build.

With WORD, only the variants whose name holds it are built and run, and
only the sections they belong to.  A variant whose text is not found in
the source fails the run: the variants name the committed choices they
replace.  Times are medians of 20 L2-cold calls (``chip_smoke.device_ms``).

The parent's row kernel is built from ``build/parent_rows/`` (its
``lut_softmax.cu`` and ``lut_pipeline.cuh``), which ``--fetch-parent
[REV]`` fills from ``git show REV:src/repro_torch/csrc/...`` (REV
defaults to ``HEAD~1``, the parent of a committed change; ``HEAD`` for
a change not yet committed).  It needs git and no card, so run it before
copying the tree to a machine without ``.git``:

    python3 tools/tile_variants.py --fetch-parent HEAD
    PYTHONPATH=src python3 tools/tile_variants.py rows
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
from repro_torch.kernels.common import (FLOAT_DTYPES,  # noqa: E402
                                        kernel_tables)
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
#: where the parent's row kernel sources go (``--fetch-parent``)
PARENT_ROWS = Path(__file__).resolve().parents[1] / "build" / "parent_rows"
PARENT_FILES = ("lut_softmax.cu", "lut_pipeline.cuh")


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
    if kernel == "lut_softmax":
        return "rows"
    if kernel == "flash_attention":
        return "flash"
    return "split" if "split" in name else "dense"


def fetch_parent(rev: str) -> None:
    """Write the parent commit's row kernel sources into
    :data:`PARENT_ROWS` (``git show REV:...``; needs the git checkout)."""
    PARENT_ROWS.mkdir(parents=True, exist_ok=True)
    for name in PARENT_FILES:
        src = subprocess.run(
            ["git", "show", f"{rev}:src/repro_torch/csrc/{name}"],
            cwd=cs.ROOT, check=True, capture_output=True, text=True).stdout
        (PARENT_ROWS / name).write_text(src)
    print(f"[variants] {rev}'s row kernel sources in {PARENT_ROWS}")


def parent_rows_library() -> ctypes.CDLL:
    """The parent's row kernel, built from :data:`PARENT_ROWS` with the
    tree's nvcc flags; its entry points take no launch plan."""
    missing = [n for n in PARENT_FILES if not (PARENT_ROWS / n).exists()]
    if missing:
        raise SystemExit(f"{missing} not in {PARENT_ROWS}: run "
                         f"tools/tile_variants.py --fetch-parent first")
    lib_path = PARENT_ROWS / "liblut_softmax.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(PARENT_ROWS / "lut_softmax.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    for method in ("rexp", "lut2d"):
        fn = getattr(lib, f"lut_softmax_{method}_launch")
        fn.argtypes = build.KERNELS["lut_softmax"][fn.__name__][:15] + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def parent_rows_call(lib, method, x, tables):
    """The parent's wrapper call (one block a row, no plan) on ``x``."""
    main_t, aux, ints, floats = kernel_tables(method, tables, "round",
                                              x.device)
    n_main, aux_rows, aux_cols, _, round_mode = ints
    cols = x.shape[-1]
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    err = getattr(lib, f"lut_softmax_{method}_launch")(
        x.data_ptr(), main_t.data_ptr(), aux.data_ptr(), out.data_ptr(),
        FLOAT_DTYPES[x.dtype], x.numel() // cols, cols, n_main, aux_rows,
        aux_cols, round_mode, *floats,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent row kernel: CUDA error {err}")
    return out


def rows_section(names, use):
    """The parent's row kernel against this tree's (P C C P) at the
    smoke's full-width row shapes, then the row variants."""
    lib = parent_rows_library()
    shapes = {**cs.ROW_SHAPES, "long rows": ((4096, 16384), False)}
    inputs = {(name, dt): cs.row_logits(shape, causal, dt, seed=8)
              for name, (shape, causal) in shapes.items()
              for dt in (torch.float32, torch.bfloat16)}
    pols = {impl: SoftmaxPolicy(impl=impl, precision="uint8")
            for impl in cs.ROW_KERNELS}
    use("committed")
    for (name, dt), x in inputs.items():
        b_ms, b_by = cs.row_bound(x.numel(), dt)
        lib_ms = cs.device_ms(lambda: torch.softmax(x, dim=-1))
        for impl, (kernel, _) in cs.ROW_KERNELS.items():
            tables = cs.ops._tables_for(pols[impl])
            # the plan for an output at a fresh allocation's alignment
            plan = LSM.plan_for(x, torch.empty(1, device="cuda"),
                                *kernel_tables(impl, tables, "round",
                                               x.device)[:2])
            same = torch.equal(kernel(x, tables),
                               parent_rows_call(lib, impl, x, tables))
            order = []
            for who in ("parent", "change", "change", "parent"):
                fn = ((lambda: parent_rows_call(lib, impl, x, tables))
                      if who == "parent" else (lambda: kernel(x, tables)))
                order.append(cs.device_ms(fn))
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
            err = float((call("tiles") - call("rows")).abs().max())
            line.append(f"{mode} {ms:.4f} ms (tiles – rows {err:.3g})")
        print(f"[variants] dense tiles at the Whisper encoder, {name}: "
              + ", ".join(line))

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
                else {"flash", "split", "dense", "rows"})
    rng = np.random.default_rng(0)
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
