"""Serving launcher: batched generation with the LUT softmax.

Random-initializes an attention-only dense arch or Whisper-small
(seeded ``torch.Generator``; depth cut by ``--layers``, widths
optionally cut by ``--scale-down``) and serves ``--batch`` requests,
two ways:

* ``--engine continuous`` (default) — the paged ``ServingEngine``,
  requests of mixed prompt lengths sharing the decode batch;
* ``--engine lockstep`` — ``serve_loop.generate`` over contiguous
  caches, every request one prompt length, finishing together.

The engine serves decoder-only LMs: an encoder-decoder
(``--arch whisper-small``) falls back to lockstep, as in the JAX
package, with seeded random stub frames ``(batch, encoder_seq,
d_model)`` from ``--seed`` as its audio.

Runs on the card by default: ``--device cuda`` needs a CUDA device and
raises without one; ``--device cpu`` runs the plain PyTorch versions on
the CPU.

``--kv-dtype int8`` stores the engine's KV pool as int8 pages with one
f32 scale per token × KV head (the int8 CUDA kernels dequantize them in
place); the lockstep path fake-quantizes its caches with the same
rounding instead.

``--paged-backend`` selects the paged attention of BOTH phases (decode
steps and prefill chunks): ``auto`` launches the CUDA kernels on the card
and the plain versions on the CPU, ``cuda`` forces the kernels (raises on
the CPU), ``dense`` the plain versions everywhere.  ``--attention-backend``
does the same for the lockstep and encoder attentions and the dense
LUT-attention kernel (``auto`` | ``cuda`` | ``naive``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-32b \\
      --layers 4 --softmax rexp --precision uint8 --batch 4 \\
      --prompt-len 64 --new-tokens 32 --kv-dtype int8 --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \\
      --scale-down 64,4,128 --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, RunConfig, get_arch
from repro_torch.core.policies import SoftmaxPolicy
from repro_torch.kernels.lut_attention.ops import (
    resolve_attention_backend, resolve_paged_backend,
    resolve_paged_prefill_backend)
from repro_torch.models import build_model
from repro_torch.models.convert import cast_params
from repro_torch.models.model_zoo import resolve_device
from repro_torch.runtime.engine import EngineConfig, ServingEngine
from repro_torch.runtime.paged_cache import KV_DTYPES, PagedCacheConfig
from repro_torch.runtime.serve_loop import generate


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (periods)")
    ap.add_argument("--scale-down", default=None,
                    help="d_model,heads,vocab: reduced widths for CPU runs")
    ap.add_argument("--softmax", default="rexp",
                    choices=["exact", "rexp", "lut2d"])
    ap.add_argument("--precision", default="uint8",
                    choices=["int16", "uint8", "uint4", "uint2"])
    ap.add_argument("--batch", type=int, default=4,
                    help="requests served, and decode slots")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", default="continuous",
                    choices=["continuous", "lockstep"])
    ap.add_argument("--paged-backend", default="auto",
                    choices=["auto", "cuda", "dense"])
    ap.add_argument("--attention-backend", default="auto",
                    choices=["auto", "cuda", "naive"],
                    help="lockstep and encoder attention: the dense "
                         "LUT-attention kernel or its plain version")
    ap.add_argument("--kv-dtype", default="f32", choices=list(KV_DTYPES),
                    help="KV storage: int8 pages with f32 per-token × "
                         "KV-head scales, or pages in the run dtype")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--n-pages", type=int, default=256)
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    if args.scale_down:
        d, h, v = (int(x) for x in args.scale_down.split(","))
        arch = arch.scaled_down(d_model=d, n_heads=h, vocab=v,
                                n_periods=args.layers or 2)
    elif args.layers:
        arch = arch.with_layers(args.layers)
    model = build_model(arch)
    policy = (SoftmaxPolicy(impl=args.softmax, precision=args.precision)
              if args.softmax != "exact" else SoftmaxPolicy())
    run = RunConfig(dtype="bfloat16" if device.type == "cuda" else "float32",
                    softmax_policy=policy,
                    attention_backend=args.attention_backend,
                    paged_backend=args.paged_backend,
                    kv_dtype=args.kv_dtype)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen, device)
    if device.type == "cuda":
        params = cast_params(params, torch.bfloat16)
    rng = np.random.default_rng(args.seed)
    engine = args.engine
    if engine == "continuous" and model.is_encdec:
        print("the continuous engine serves decoder-only LMs; falling back "
              "to lockstep")
        engine = "lockstep"
    if engine == "lockstep":
        prompt = torch.as_tensor(
            rng.integers(0, arch.vocab_size, size=(args.batch,
                                                   args.prompt_len)),
            dtype=torch.int32, device=device)
        frames = None
        if model.is_encdec:
            frames = torch.as_tensor(
                rng.standard_normal((args.batch, arch.encoder_seq,
                                     arch.d_model), dtype=np.float32),
                device=device)
        t0 = time.time()
        out = generate(model, params, prompt, run,
                       max_new_tokens=args.new_tokens, encoder_input=frames)
        if device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.time() - t0
        toks = args.batch * args.new_tokens
        layers = (f"{arch.encoder_layers}+{arch.n_layers}" if model.is_encdec
                  else f"{arch.n_layers}")
        print(f"{arch.name} x{layers} layers on {device} "
              f"policy={policy.impl}/{policy.precision} lockstep "
              f"[attention: "
              f"{resolve_attention_backend(args.attention_backend, device)}]"
              f" kv_dtype={args.kv_dtype}: {toks} tokens in {dt:.2f}s "
              f"({toks / dt:.1f} tok/s)")
        print("sample token ids:", out[0, :16].tolist())
        return
    mp = -(-(args.prompt_len + args.new_tokens) // args.page_size)
    cache = PagedCacheConfig(n_pages=args.n_pages, page_size=args.page_size,
                             max_pages_per_seq=mp)
    eng = ServingEngine(model, params, run, EngineConfig(
        n_slots=args.batch, cache=cache, prefill_chunk=args.prefill_chunk),
        device=device)
    tokens_in_pool = args.n_pages * args.page_size
    print(f"kv_dtype={args.kv_dtype}: {eng.stats.pool_bytes_per_layer} KV "
          f"pool bytes per layer, "
          f"{eng.stats.pool_bytes_per_layer / tokens_in_pool:g} per token")

    handles = []
    for _ in range(args.batch):
        plen = max(1, int(rng.integers(args.prompt_len // 2,
                                       args.prompt_len + 1)))
        handles.append(eng.add_request(
            rng.integers(0, arch.vocab_size, size=plen), args.new_tokens))
    t0 = time.time()
    results = {int(h): h.result() for h in handles}
    dt = time.time() - t0
    ttfts = [r.ttft_s for r in results.values() if r.ttft_s is not None]
    toks = eng.stats.tokens
    print(f"{arch.name} x{arch.n_layers} layers on {device} "
          f"policy={policy.impl}/{policy.precision} [decode attention: "
          f"{resolve_paged_backend(args.paged_backend, device)}; prefill "
          f"attention: "
          f"{resolve_paged_prefill_backend(args.paged_backend, device)}]: "
          f"{toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s incl. kernel "
          f"build; {eng.stats.steps} decode steps, "
          f"{eng.stats.prefill_steps} prefill chunks of "
          f"{args.prefill_chunk}, {eng.stats.preemptions} preemptions, "
          f"mean TTFT {np.mean(ttfts):.3f}s)")
    print("sample token ids:", results[0].tokens[:16].tolist())


if __name__ == "__main__":
    main()
