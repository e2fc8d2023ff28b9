#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises (exit code ≠ 0):

1. device and build — needs ``torch.cuda.is_available()``; prints the
   card's name and power limit, then builds every CUDA kernel of the
   serving path from ``src/repro_torch/csrc`` (one ``nvcc`` per source,
   all at once) and prints the build seconds and ptxas's report;
2. kernel against plain version — each paged kernel × {exact,
   rexp-uint8, lut2d-uint8} at Qwen3-32B width (H=64, KVH=8, Dh=128,
   page_size=16, ragged kv_lens up to 512, permuted block tables, finite
   junk in null and unused pages):
   (a) exact-logit inputs (q, k small integers × 2^-2, so every dot order
       gives the same logits): outputs within 2e-6 — a LUT bin that moved
       would shift a weight by ≥ 1/qmax, far above that;
   (b) random inputs in bf16 and f32: the max error and the share of rows
       beyond 1e-4, held to one LUT step (2/qmax · max|v|; 1e-4 · max|v|
       for exact), since the kernel and cuBLAS sum the dots in different
       orders and a logit on a bin edge may land in the neighbouring bin;
   then the kernel's time, the plain version's, SDPA on the gathered
   view for exact (a yardstick only: the port never calls it) and the
   least time the card could take;
3. engine — Qwen3-32B widths (d_model 5120, 64/8 heads, d_ff 25600,
   vocab 151936, qk-norm), depth cut to 4 of 64 layers, seeded random
   bf16 weights, REXP uint8, ``paged_backend="auto"``: 8 requests with
   16–300-token prompts and 32 new tokens each through the paged
   ``ServingEngine``; both kernels' launch counters must move.  One
   more drive under torch.profiler splits its device time by kernel.
   The same run again with every kernel call held to its plain version
   on the engine's own inputs (one LUT step), and the same requests with
   ``paged_backend="dense"``: under the exact policy the first-token
   logits must agree within 2% (see :func:`phase_engine` for why REXP's
   free-running streams are only printed).

The line before the last is the card's name and power limit, the one
before it a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import ARCHS, RunConfig  # noqa: E402
from repro_torch.core.policies import SoftmaxPolicy  # noqa: E402
from repro_torch.core.precision import get_precision  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.lut_attention import ops  # noqa: E402
from repro_torch.kernels.lut_attention.paged_decode import (  # noqa: E402
    paged_decode_attention, paged_decode_plain)
from repro_torch.kernels.lut_attention.paged_prefill import (  # noqa: E402
    paged_prefill_attention, paged_prefill_plain)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as LAYERS  # noqa: E402
from repro_torch.models.convert import cast_params  # noqa: E402
from repro_torch.runtime.engine import (EngineConfig,  # noqa: E402
                                        ServingEngine)
from repro_torch.runtime.paged_cache import PagedCacheConfig  # noqa: E402

#: H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
#: the operation rate for each input type (bf16 tensor cores; f32
#: outside the tensor cores, since TF32 would change the logits).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

POLICIES = {
    "exact": SoftmaxPolicy(),
    "rexp-uint8": SoftmaxPolicy(impl="rexp", precision="uint8"),
    "lut2d-uint8": SoftmaxPolicy(impl="lut2d", precision="uint8"),
}
MAIN_POLICY = "rexp-uint8"

# Qwen3-32B attention widths and the engine's paging.
H, KVH, DH, PS, MP = 64, 8, 128, 16, 32
N_SLOTS, CHUNK = 4, 16
DECODE_KV_LENS = (512, 301, 77, 1)
PREFILL_MAIN = dict(q_start=(288,), chunk_lens=(12,))     # the engine's B=1
PREFILL_RAGGED = dict(q_start=(0, 100, 480), chunk_lens=(16, 7, 16))
EXACT_TOL = 2e-6


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Problems, timing, bounds
# ---------------------------------------------------------------------------


def paged_problem(rng, *, kv_lens, c, q_start, dtype, exact_logits):
    """Pool + permuted block tables; slot i owns ceil(kv_lens[i]/PS)
    pages; every page (the null page and unowned pages too) holds finite
    junk, so only the masks keep it out."""
    b = len(kv_lens)
    n_pages = 1 + b * MP
    if exact_logits:
        q = rng.integers(-4, 5, size=(b, H, c, DH)) * 0.25
        k = rng.integers(-4, 5, size=(n_pages, PS, KVH, DH)) * 0.25
    else:
        q = rng.normal(size=(b, H, c, DH))
        k = rng.normal(size=(n_pages, PS, KVH, DH))
    v = rng.normal(size=(n_pages, PS, KVH, DH))
    phys = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((b, MP), np.int32)
    for i, kl in enumerate(kv_lens):
        n_owned = -(-int(kl) // PS)
        bt[i, :n_owned] = phys[i * MP:i * MP + n_owned]

    def dev(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), device="cuda").to(dt)

    return dict(q=dev(q), k_pages=dev(k), v_pages=dev(v),
                block_tables=dev(bt, torch.int32),
                kv_lens=dev(np.asarray(kv_lens, np.int32), torch.int32),
                q_start=dev(np.asarray(q_start, np.int32), torch.int32))


def decode_args(p):
    return (p["q"], p["k_pages"], p["v_pages"], p["block_tables"],
            p["kv_lens"])


def prefill_args(p):
    return (p["q"], p["k_pages"], p["v_pages"], p["block_tables"],
            p["q_start"], p["kv_lens"])


def device_ms(fn, iters=20) -> float:
    """Median device time of one call, L2 cold: before each call a
    256 MiB write evicts the 50 MB L2 and a spin keeps the device busy
    while the host enqueues the call, so the events bracket device work
    only."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def visible_pairs(kv_lens, q_start, c) -> int:
    """(query row, key) pairs the masks let through, summed over slots."""
    return sum(max(min(kl, qs + i + 1), 0) for kl, qs in zip(kv_lens, q_start)
               for i in range(c))


def bound(p, kv_lens, q_start, c, dtype):
    """Least time the card could take: each live K/V row, each query and
    each output read or written once, against q·k and σ·v over the
    visible (row, key) pairs at the input type's peak."""
    esize = torch.empty((), dtype=dtype).element_size()
    b = len(kv_lens)
    live_rows = sum(min(kl, MP * PS) for kl in kv_lens)
    nbytes = (2 * live_rows * KVH * DH * esize      # K and V pages
              + b * H * c * DH * esize              # queries
              + b * H * c * DH * 4                  # f32 outputs
              + p["block_tables"].numel() * 4 + 2 * b * 4)
    ops_count = 4 * H * DH * visible_pairs(kv_lens, q_start, c)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_count / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_ms(p, c, q_start_t):
    """Exact attention by one library call on the gathered view (the
    gather and the GQA head repeat stay outside the timed call)."""
    k = ops.gather_pages(p["k_pages"], p["block_tables"])
    v = ops.gather_pages(p["v_pages"], p["block_tables"])
    k = k.repeat_interleave(H // KVH, dim=1)
    v = v.repeat_interleave(H // KVH, dim=1)
    lk = k.shape[2]
    ki = torch.arange(lk, device="cuda")[None, None, None, :]
    qi = (q_start_t[:, None] + torch.arange(c, device="cuda")[None, :]
          )[:, None, :, None]
    mask = (ki <= qi) & (ki < p["kv_lens"][:, None, None, None])
    return device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        p["q"], k, v, attn_mask=mask))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_build():
    t0 = time.perf_counter()
    report = build.build(force=True)
    secs = time.perf_counter() - t0
    print(f"[build] {len(report)} kernels in {secs:.1f}s (parallel nvcc): "
          + ", ".join(f"{n} {r['seconds']:.1f}s" for n, r in report.items()))
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    for name in report:
        build.load(name)


def check_kernel(name, kernel, plain, args_of, rng, cases):
    """Hold ``kernel`` to ``plain`` on every case; returns the max error
    of the exact-logit cases."""
    worst_exact = 0.0
    for pol_name, pol in POLICIES.items():
        qmax = (get_precision(pol.precision).qmax
                if pol.impl != "exact" else None)
        for dtype in (torch.float32, torch.bfloat16):
            for exact_logits in (True, False):
                for case in cases:
                    p = paged_problem(rng, dtype=dtype,
                                      exact_logits=exact_logits, **case)
                    out = kernel(*args_of(p), pol)
                    ref = plain(*args_of(p), pol)
                    torch.cuda.synchronize()
                    err = (out - ref).abs()
                    max_err = float(err.max())
                    tag = (f"[kernel] {name} {pol_name} {str(dtype)[6:]} "
                           f"B={len(case['kv_lens'])} "
                           f"{'exact-logit' if exact_logits else 'random'}")
                    if exact_logits:
                        worst_exact = max(worst_exact, max_err)
                        print(f"{tag}: max|err| {max_err:.3g} "
                              f"(limit {EXACT_TOL})")
                        if not max_err <= EXACT_TOL:
                            raise AssertionError(f"{tag}: {max_err} > "
                                                 f"{EXACT_TOL}")
                    else:
                        vmax = float(p["v_pages"].float().abs().max())
                        limit = (2.0 / qmax if qmax else 1e-4) * vmax
                        rows = err.amax(dim=-1)
                        share = float((rows > 1e-4).float().mean())
                        print(f"{tag}: max|err| {max_err:.3g} (limit "
                              f"{limit:.3g}), rows beyond 1e-4: "
                              f"{share:.4%}")
                        if not max_err <= limit:
                            raise AssertionError(f"{tag}: {max_err} > "
                                                 f"{limit}")
    return worst_exact


def time_kernel(name, kernel, plain, args_of, rng, case):
    """Time the kernel, its plain version and (exact) SDPA at the main
    path's shapes in bf16; returns the main policy's row."""
    rows = {}
    c = case["c"]
    for pol_name, pol in POLICIES.items():
        p = paged_problem(rng, dtype=torch.bfloat16, exact_logits=False,
                          **case)
        ms = device_ms(lambda: kernel(*args_of(p), pol))
        plain_ms = device_ms(lambda: plain(*args_of(p), pol))
        lib = (sdpa_ms(p, c, p["q_start"]) if pol.impl == "exact" else None)
        b_ms, b_by = bound(p, case["kv_lens"], case["q_start"], c,
                           torch.bfloat16)
        print(f"[time] {name} {pol_name} bf16 B={len(case['kv_lens'])} "
              f"C={c} kv_lens={list(case['kv_lens'])}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, "
              f"library {'n/a' if lib is None else f'{lib:.4f} ms'}, "
              f"bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of bound")
        rows[pol_name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by, library_ms=lib)
    return rows[MAIN_POLICY]


def phase_kernels():
    rng = np.random.default_rng(0)
    dec_case = dict(kv_lens=DECODE_KV_LENS, c=1,
                    q_start=tuple(kl - 1 for kl in DECODE_KV_LENS))

    def pf_case(q_start, chunk_lens):
        return dict(kv_lens=tuple(q + n for q, n in zip(q_start, chunk_lens)),
                    c=CHUNK, q_start=q_start)

    pf_main, pf_ragged = pf_case(**PREFILL_MAIN), pf_case(**PREFILL_RAGGED)
    results = {}
    for name, kernel, plain, args_of, cases, main in (
            ("paged_decode", paged_decode_attention, paged_decode_plain,
             decode_args, [dec_case], dec_case),
            ("paged_prefill", paged_prefill_attention, paged_prefill_plain,
             prefill_args, [pf_main, pf_ragged], pf_main)):
        err = check_kernel(name, kernel, plain, args_of, rng, cases)
        results[name] = dict(max_abs_err=err,
                             **time_kernel(name, kernel, plain, args_of, rng,
                                           main))
    return results


def run_engine(model, params, policy, backend, requests, shadow=None,
               around=None):
    """Serve ``requests`` through a fresh bf16 engine; returns the
    results, each request's first-token logits, the kernels' launches
    during the drive and its wall seconds.  ``around`` is a context
    manager entered around the drive only (a profiler).

    ``shadow`` (a list) makes every paged-attention call of the engine
    also run the plain version (``backend="dense"``) on the same inputs,
    appending ``(max error, one-LUT-step bound, share of rows beyond
    1e-4)``; the model's dispatchers are restored after.
    """
    run = RunConfig(dtype="bfloat16", softmax_policy=policy,
                    paged_backend=backend)
    eng = ServingEngine(model, params, run, EngineConfig(
        n_slots=N_SLOTS, prefill_chunk=CHUNK,
        cache=PagedCacheConfig(n_pages=128, page_size=PS,
                               max_pages_per_seq=MP)), device="cuda")
    first_logits = {}
    sample = eng._sample

    def recording_sample(seq, row):
        if not seq.generated:
            first_logits.setdefault(seq.request.id, row.copy())
        return sample(seq, row)

    eng._sample = recording_sample
    step = (2.0 / get_precision(policy.precision).qmax
            if policy.impl != "exact" else 1e-4)

    def shadowed(dispatch):
        def call(*args, **kw):
            out = dispatch(*args, **kw)
            ref = dispatch(*args, **{**kw, "backend": "dense"})
            rows = (out - ref).abs().amax(dim=-1)
            shadow.append((float(rows.max()),
                           step * float(args[2].float().abs().max()),
                           float((rows > 1e-4).float().mean())))
            return out
        return call

    if shadow is not None:
        LAYERS.lut_attention_paged_decode = shadowed(
            ops.lut_attention_paged_decode)
        LAYERS.lut_attention_paged_prefill = shadowed(
            ops.lut_attention_paged_prefill)
    try:
        for prompt, n_new in requests:
            eng.add_request(prompt, n_new)
        torch.cuda.synchronize()
        paged_decode_attention.launches = 0
        paged_prefill_attention.launches = 0
        with around or contextlib.nullcontext():
            t0 = time.perf_counter()
            results = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        LAYERS.lut_attention_paged_decode = ops.lut_attention_paged_decode
        LAYERS.lut_attention_paged_prefill = ops.lut_attention_paged_prefill
    launches = {"paged_decode": paged_decode_attention.launches,
                "paged_prefill": paged_prefill_attention.launches}
    for rid, res in results.items():
        if len(res.tokens) != 32:
            raise AssertionError(f"{backend}: request {rid} gave "
                                 f"{len(res.tokens)} tokens")
    ttft = np.mean([r.ttft_s for r in results.values()])
    name = (policy.impl if policy.impl == "exact"
            else f"{policy.impl}-{policy.precision}")
    print(f"[engine] {name} paged_backend={backend}"
          f"{' (shadowed)' if shadow is not None else ''}: {len(results)} "
          f"requests, {eng.stats.tokens} tokens in {wall:.2f}s "
          f"({eng.stats.tokens / wall:.1f} tok/s), mean TTFT {ttft:.3f}s, "
          f"{eng.stats.steps} decode steps, {eng.stats.prefill_steps} "
          f"prefill chunks, {eng.stats.preemptions} preemptions, kernel "
          f"launches {launches}")
    return results, first_logits, launches, wall


def profile_drive(model, params, requests):
    """Where the main path's device time goes: torch.profiler's kernel
    times over one drive, grouped, and the device's busy share of the
    drive's wall time (the profiler's own cost lengthens the wall time,
    so the share is a lower bound).  Prints "not measured" when the
    profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    try:  # can the profiler trace this card at all?
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
    except (RuntimeError, AssertionError) as err:
        print(f"[profile] the profiler did not run ({err}): not measured")
        return
    prof = profile(activities=[ProfilerActivity.CUDA])
    wall = run_engine(model, params, POLICIES[MAIN_POLICY], "auto",
                      requests, around=prof)[3]
    kernels = []
    for e in prof.key_averages():
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            kernels.append((us, e.count, e.key))
    if not kernels:
        print("[profile] the profiler recorded no device time: not measured")
        return
    busy = sum(us for us, _, _ in kernels) / 1e6
    groups = {"paged attention kernels": ("paged_decode_kernel",
                                          "paged_prefill_kernel"),
              "matmuls": ("gemm", "gemv", "nvjet", "cutlass", "xmma",
                          "sm90_")}
    shares = {g: sum(us for us, _, k in kernels
                     if any(n in k for n in names)) / 1e6
              for g, names in groups.items()}
    shares["everything else"] = busy - sum(shares.values())
    print(f"[profile] {MAIN_POLICY} drive, profiled: device busy "
          f"{busy * 1e3:.1f} ms of {wall * 1e3:.1f} ms wall "
          f"({busy / wall:.1%}); "
          + "; ".join(f"{g} {t * 1e3:.1f} ms ({t / busy:.1%})"
                      for g, t in shares.items()))
    for us, count, key in sorted(kernels, reverse=True)[:8]:
        print(f"[profile]   {us / 1e3:8.2f} ms  {count:5d} calls  {key[:90]}")


def compare_runs(label, a, b):
    """First-token logits max|Δ|/max|logit| and the share of generated
    tokens that agree between two engine runs."""
    worst = max(float(np.abs(row - b[1][rid]).max()
                      / np.abs(b[1][rid]).max()) for rid, row in a[1].items())
    agree = float(np.mean([np.mean(a[0][r].tokens == b[0][r].tokens)
                           for r in a[0]]))
    print(f"[engine] {label}: first-token logits max|Δ|/max|logit| "
          f"{worst:.4g}; tokens agreeing {agree:.1%}")
    return worst


def phase_engine():
    """The main path (REXP uint8, ``auto``) timed and counted; the same
    run shadowed, every kernel call held to its plain version on the
    engine's own inputs; then the dense runs.

    The dense comparison that is asserted uses the exact policy: REXP's
    numerators are piecewise constant, so a logit that moves by one ulp
    across a bin edge moves a weight by a whole LUT step, and once the
    bf16 rounding of the attention output differs anywhere, the two
    free-running REXP streams part.  Exact softmax is continuous, so its
    kernel and dense runs can only differ by roundoff that the bf16
    layers carry forward: first-token logits within 2% of their largest
    magnitude.  The REXP pair is printed beside it.
    """
    arch = ARCHS["qwen3-32b"].with_layers(4)
    model = build_model(arch)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = cast_params(model.init(gen, "cuda"), torch.bfloat16)
    torch.cuda.synchronize()
    print(f"[engine] {arch.name}: d_model {arch.d_model}, heads "
          f"{arch.n_heads}/{arch.n_kv_heads}, d_ff {arch.d_ff}, vocab "
          f"{arch.vocab_size}, qk_norm {arch.qk_norm}, {arch.n_layers} of "
          f"64 layers: {arch.param_count() / 1e9:.2f}B params bf16, init "
          f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(1)
    requests = [(rng.integers(0, arch.vocab_size, size=int(n)).tolist(), 32)
                for n in rng.integers(16, 301, size=8)]
    main = POLICIES[MAIN_POLICY]
    main_run = run_engine(model, params, main, "auto", requests)
    launches = main_run[2]
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"main path skipped a kernel: {launches}")

    profile_drive(model, params, requests)
    shadow = []
    run_engine(model, params, main, "auto", requests, shadow=shadow)
    worst = max(e for e, _, _ in shadow)
    beyond = max(s for _, _, s in shadow)
    print(f"[engine] shadowed main path: {len(shadow)} kernel calls held to "
          f"the plain version on the same inputs: max|err| {worst:.3g}, "
          f"largest share of rows beyond 1e-4 in one call {beyond:.4%}")
    for err, limit, _ in shadow:
        if not err <= limit:
            raise AssertionError(f"kernel call off its plain version by "
                                 f"{err} > one LUT step {limit}")

    dense = run_engine(model, params, main, "dense", requests)
    if any(dense[2].values()):
        raise AssertionError(f"dense run launched kernels: {dense[2]}")
    compare_runs(f"{MAIN_POLICY} kernel vs dense (free-running)", main_run,
                 dense)
    exact = POLICIES["exact"]
    worst = compare_runs(
        "exact kernel vs dense",
        run_engine(model, params, exact, "auto", requests),
        run_engine(model, params, exact, "dense", requests))
    if not worst <= 0.02:
        raise AssertionError(f"exact-policy first-token logits differ by "
                             f"{worst:.3g} > 0.02")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the plain versions are the reference: full f32 products, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    print(f"[device] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    phase_build()
    kernels = phase_kernels()
    launches = phase_engine()
    summary = {"kernels": [
        dict(name=name, route="cuda",
             source=f"src/repro_torch/csrc/{name}.cu",
             replaces=replaces, launches=launches[name], **kernels[name])
        for name, replaces in (
            ("paged_decode",
             "src/repro/kernels/lut_attention/paged_decode.py:419"),
            ("paged_prefill",
             "src/repro/kernels/lut_attention/paged_prefill.py:427"))]}
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
