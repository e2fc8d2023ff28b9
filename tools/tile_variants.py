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
  route.

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
    q, k, v = cs.dense_problem(rng, cs.W_BATCH, cs.W_H, cs.W_H, cs.W_LENC,
                               cs.W_LENC, cs.W_DH, torch.bfloat16, False)
    for name in ["committed"] + [n for n in names
                                 if VARIANTS[n][0] == "lut_attention"]:
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
