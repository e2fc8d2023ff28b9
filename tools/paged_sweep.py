#!/usr/bin/env python3
"""Times the paged LUT-attention kernels on one NVIDIA GPU.

    python3 tools/paged_sweep.py [--root DIR] [--label NAME] [--out FILE]
                                 [--host | --smoke]
    python3 tools/paged_sweep.py --variants [WORD]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout) before
``chip_smoke``, whose timing helpers then time that tree's wrappers: a
``git archive`` copy of another commit, unpacked into a directory that
``.gitignore`` lists, is timed by the same code on the same inputs — run
it as parent, change, change, parent in one chip call and compare within
that call.  (A tree whose wrappers do not take ``max_kv_len`` is called
without it.)  It builds the two paged kernels of that tree and prints,
for REXP uint8 on a bf16 and on an int8 pool at Qwen3-32B's attention
widths:

* the smoke's main shapes (``chip_smoke.smoke_cases``) under exact, REXP
  and 2D-LUT uint8, timed by ``chip_smoke.device_ms`` (L2 flushed,
  median of 20);
* the host's microseconds per wrapper call there
  (``chip_smoke.host_times``: median, lowest and highest of 30 rounds of
  100 calls);
* the sweep (``chip_smoke.sweep``) and the harness's floor (one empty
  launch).

With ``--host`` only the host's microseconds are taken, with ``--smoke``
only the smoke's main shapes (quick processes, for interleaving several
trees).  With ``--out`` the numbers also go to
a JSON file.

``--variants`` instead times A/B variants of this tree's paged kernels
(``VARIANTS``: each a textual change to a copy of ``csrc/``, built by
``tile_variants.build_variants``) against the committed build, at the
smoke's main shapes, REXP uint8, bf16 and int8 pools; with WORD only the
variants whose name holds it.  The what-ifs take work out to see what it
costs: their results are wrong by design, so read only their times.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

ATTN = "paged_attn.cuh"
#: the launch plans' header (the plans and the row instances)
PLAN = "launch_plan.h"
PREFILL_ROWS = "constexpr Rows<1, 2> kPrefillRows{};"
#: variant → (kernels it changes, [(file, committed text, variant text)])
VARIANTS = {
    "split for 2 CTAs an SM, prefill too": (
        ("paged_decode", "paged_prefill"),
        [(PLAN, "const int per_sm = rpt == 1 ? 2 : 1;",
          "const int per_sm = 2;")]),
    "split for 1 CTA an SM": (
        ("paged_decode", "paged_prefill"),
        [(PLAN, "const int per_sm = rpt == 1 ? 2 : 1;",
          "const int per_sm = 1;")]),
    "split at most 2": (("paged_decode", "paged_prefill"), [
        (PLAN, "while (s.n_split < kMaxSplit &&", "while (s.n_split < 2 &&")]),
    "no split": (("paged_decode", "paged_prefill"), [
        (PLAN, "while (s.n_split < kMaxSplit &&", "while (s.n_split < 1 &&")]),
    "prefill blocks of 32 rows": ("paged_prefill", [
        (PLAN, PREFILL_ROWS, "constexpr Rows<1, 2, 4> kPrefillRows{};")]),
    "prefill blocks of 8 rows": ("paged_prefill", [
        (PLAN, PREFILL_ROWS, "constexpr Rows<1> kPrefillRows{};")]),
    "2-stage ring": (("paged_decode", "paged_prefill"), [
        (PLAN, "kStages = 4;", "kStages = 2;")]),
    "3-stage ring": (("paged_decode", "paged_prefill"), [
        (PLAN, "kStages = 4;", "kStages = 3;")]),
    "start-up barrier arrived at the kernel's start": (
        ("paged_decode", "paged_prefill"), [
            (ATTN, "  cluster_arrive_relaxed();\n  __syncthreads();",
             "  __syncthreads();"),
            (ATTN, "  cg::cluster_group cluster = cg::this_cluster();\n",
             "  cg::cluster_group cluster = cg::this_cluster();\n"
             "  cluster_arrive_relaxed();\n")]),
    "what-if: no start-up cluster barrier": (
        ("paged_decode", "paged_prefill"), [
            (ATTN, "  cluster_arrive_relaxed();\n  __syncthreads();",
             "  __syncthreads();"),
            (ATTN, "      cluster_wait();  // every CTA of the cluster runs\n",
             "")]),
    "what-if: no exchange between CTAs": (
        ("paged_decode", "paged_prefill"), [
            (ATTN, "cluster.map_shared_rank(table, lane)", "table"),
            (ATTN, "cluster.map_shared_rank(part_s, owner)", "part_s")]),
    "what-if: no q·k": (("paged_decode", "paged_prefill"), [
        (ATTN, "for (int c0 = 0; c0 < 16 * NV; c0 += 2) {",
         "for (int c0 = 0; c0 < 0; c0 += 2) {")]),
    "what-if: no σ·V": (("paged_decode", "paged_prefill"), [
        (ATTN, "for (int k0 = 0; k0 < n; k0 += A * halves) {",
         "for (int k0 = 0; k0 < 0; k0 += A * halves) {")]),
    "what-if: no keys (the fixed cost of a CTA)": (
        ("paged_decode", "paged_prefill"), [
            (ATTN, "nt = (nkeys + span - 1) / span;", "nt = 0;")]),
    "what-if: no page copies": (("paged_decode", "paged_prefill"), [
        (ATTN, "if (item >= n_items) return;", "return;")]),
    "what-if: no LUT work": (("paged_decode", "paged_prefill"), [
        ("lut_pipeline.cuh", "  const float e = float(lut_main[",
         "  return fminf(d, 1.f);\n  const float e = float(lut_main["),
        ("lut_pipeline.cuh", "  const bool rexp = p.method == kRexp;",
         "  return e;\n  const bool rexp = p.method == kRexp;")]),
    # the committed build, timed without the L2 flush
    "what-if: L2 warm (no flush before a call)": ((), []),
}


def takes_bound(fn) -> bool:
    return "max_kv_len" in inspect.signature(fn).parameters


def without_bound(fn):
    """A wrapper of a tree that predates ``max_kv_len``, called as this
    tree's is."""
    def call(*args, max_kv_len=None, **kw):
        return fn(*args, **kw)
    return call


def smoke_times(cs, decode, prefill, kind, only=None, cold=True,
                log=print):
    """Both kernels at the smoke's main shapes, every policy (or ``only``
    the one named): ``{"<kernel> <policy>": ms}``."""
    pool = cs.SweepPool(kind, len(cs.DECODE_KV_LENS), cs.MP, seed=7)
    suffix = "_int8" if kind == "int8" else ""
    out = {}
    for pol_name, pol in cs.POLICIES.items():
        if only and pol_name != only:
            continue
        for name, fn in cs.smoke_cases(pool, decode, prefill, pol).items():
            ms = out[f"{name}{suffix} {pol_name}"] = cs.device_ms(fn,
                                                                 cold=cold)
            log(f"[paged] {name}{suffix} {pol_name} smoke shape: {ms:.4f} ms")
    return out


def run_variants(word, cs, decode, prefill, build, log):
    """Build every variant whose name holds ``word`` and time it against
    the committed build, REXP uint8 at the smoke's main shapes."""
    from tile_variants import build_variants
    names = [n for n in VARIANTS if word in n]
    libs = build_variants(ROOT / "build" / "variants",
                          {n: VARIANTS[n] for n in names if VARIANTS[n][0]})
    committed = {k: build.load(k) and build._loaded[k]
                 for k in ("paged_decode", "paged_prefill")}
    for name in ["committed", *names, "committed"]:
        build._loaded.update(committed)
        build._loaded.update(libs.get(name, {}))
        times = {}
        for kind in ("bf16", "int8"):
            for case, ms in smoke_times(
                    cs, decode, prefill, kind, only=cs.MAIN_POLICY,
                    cold="L2 warm" not in name, log=lambda line: None).items():
                times[case.split()[0]] = ms
        log(f"[variants] {name}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in times.items()))
    build._loaded.update(committed)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="the tree whose repro_torch is timed")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", help="also write the numbers to this JSON file")
    ap.add_argument("--host", action="store_true",
                    help="only the host's microseconds per call")
    ap.add_argument("--smoke", action="store_true",
                    help="only the smoke's main shapes")
    ap.add_argument("--variants", nargs="?", const="", metavar="WORD",
                    help="time the VARIANTS whose name holds WORD instead")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("paged_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import repro_torch  # noqa: F401  (the timed tree's, before chip_smoke)
    sys.path.insert(1, str(ROOT))
    sys.path.insert(2, str(ROOT / "tools"))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.lut_attention.paged_decode import (
        paged_decode_attention as decode)
    from repro_torch.kernels.lut_attention.paged_prefill import (
        paged_prefill_attention as prefill)
    if not takes_bound(decode):
        decode, prefill = without_bound(decode), without_bound(prefill)
    t0 = time.perf_counter()
    build.build(("paged_decode", "paged_prefill"))

    def log(line):
        print(f"[{args.label}] {line}", flush=True)

    log(f"{cs.gpu_line()}; built in {time.perf_counter() - t0:.1f}s from "
        f"{build.CSRC}")
    if args.variants is not None:
        run_variants(args.variants, cs, decode, prefill, build, log)
        return 0
    pol = cs.POLICIES[cs.MAIN_POLICY]
    result = dict(label=args.label, card=cs.gpu_line())
    if not args.host:
        result["empty_launch_ms"] = cs.empty_launch_ms()
        log(f"[floor] one empty launch: {result['empty_launch_ms']:.4f} ms")
    for kind in ("bf16", "int8"):
        if not args.smoke:
            result[f"host_{kind}"] = cs.host_times(decode, prefill, pol,
                                                   kind, log)
        if args.host:
            continue
        result[f"smoke_{kind}"] = smoke_times(cs, decode, prefill, kind,
                                              log=log)
        if not args.smoke:
            result[f"sweep_{kind}"] = cs.sweep(decode, prefill, pol, kind,
                                               log)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({k: v for k, v in result.items()
                      if not k.startswith("sweep")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
