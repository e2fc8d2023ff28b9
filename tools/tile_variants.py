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
  distance from the plain version.

With WORD, only the variants whose name holds it are built and run.  A
variant whose text is not found in the source fails the run: the
variants name the committed choices they replace.  Times are medians of
20 L2-cold calls (``chip_smoke.device_ms``).
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
from repro_torch.kernels import build  # noqa: E402

FLASH_BOUNDS = ("__launch_bounds__(tiles::kThreads, DH <= 64 ? 3 : 1)\n"
                "    flash_attention_tiles_kernel")
DENSE_BOUNDS = ("__launch_bounds__(tiles::kThreads)\n"
                "    lut_attention_tiles_kernel")

RING = "constexpr int kStages = 2;"
ATTN = "paged_attn.cuh"
MAX_SPLIT = "constexpr int kDenseMaxSplit = 4;"
SHARE = "(ctas * s.n_split + n_sms - 1) / n_sms;"
HALVES = "Keys::kDense && NV == 1 && p.Dh <= 64 ? 2 : 1;"
RANKS = "4 * s.n_split <= tiles &&"
TARGET = "constexpr size_t kDenseTarget = 64 * 1024;"


#: variant → (kernel, [(source file, committed text, variant text), ...])
VARIANTS = {
    "flash: 2 pieces of p": ("flash_attention", [
        ("flash_attention.cu", "constexpr int kPieces = 3;",
         "constexpr int kPieces = 2;")]),
    "flash: registers uncapped": ("flash_attention", [
        ("flash_attention.cu", FLASH_BOUNDS,
         FLASH_BOUNDS.replace("DH <= 64 ? 3 : 1", "1"))]),
    "flash: 3-stage ring": ("flash_attention", [
        ("attn_tiles.cuh", RING, RING.replace("2", "3"))]),
    "flash: 4-stage ring": ("flash_attention", [
        ("attn_tiles.cuh", RING, RING.replace("2", "4"))]),
    "dense: 3 blocks an SM": ("lut_attention", [
        ("lut_attention.cu", DENSE_BOUNDS,
         DENSE_BOUNDS.replace("kThreads)", "kThreads, 3)"))]),
    "dense: 3-stage ring": ("lut_attention", [
        ("attn_tiles.cuh", RING, RING.replace("2", "3"))]),
    "dense: 4-stage ring": ("lut_attention", [
        ("attn_tiles.cuh", RING, RING.replace("2", "4"))]),
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
        (ATTN, MAX_SPLIT, MAX_SPLIT.replace("4", "8"))]),
    "split: clusters of at most 2": ("lut_attention", [
        (ATTN, MAX_SPLIT, MAX_SPLIT.replace("4", "2"))]),
    "split: a spare CTA slot an SM": ("lut_attention", [
        (ATTN, SHARE, SHARE.replace("n_sms;", "n_sms + 1;"))]),
    "split: σ·V on 16 lanes at Dh 64": ("lut_attention", [
        (ATTN, HALVES, HALVES.replace("p.Dh <= 64", "p.Dh < 0"))]),
    "split: ranks of one tile or more": ("lut_attention", [
        (ATTN, RANKS, RANKS.replace("4 *", "2 *"))]),
    "split: CTAs of up to 112 KB": ("lut_attention", [
        (ATTN, TARGET, TARGET.replace("64", "112"))]),
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
    for i, (name, (kernels, subs)) in enumerate(variants.items()):
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


def main(word: str = "") -> int:
    if not torch.cuda.is_available():
        print("tile_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[variants] {cs.gpu_line()}")
    build.build()
    committed = {k: build.load(k) and build._loaded[k]
                 for k in ("flash_attention", "lut_attention")}
    names = [n for n in VARIANTS if word in n]
    libs = build_variants(cs.ROOT / "build" / "variants",
                          {n: VARIANTS[n] for n in names})

    def use(name):
        build._loaded.update(committed)
        build._loaded.update(libs.get(name, {}))

    rng = np.random.default_rng(0)
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
    use("committed")
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
