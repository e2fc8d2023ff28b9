"""Serving launcher: batched generation with the LUT softmax.

Random-initializes a dense decoder, an MoE decoder (``--arch
deepseek-moe-16b`` or ``granite-moe-3b-a800m``: attention with an MoE
FFN, its router exact) or Whisper-small (seeded ``torch.Generator``;
bf16 on the card, cast block by block as drawn; depth cut by
``--layers``, widths optionally cut by ``--scale-down``) and serves
``--batch`` requests, three ways:

* ``--engine continuous`` (default) — the paged ``ServingEngine``,
  requests of mixed prompt lengths sharing the decode batch, sampled on
  the host;
* ``--engine pipelined`` — the paged ``PipelinedEngine``: the same
  tokens, sampled on the device, with up to ``--pipeline-depth`` steps in
  flight so the host plans the next step while the card runs this one;
* ``--engine lockstep`` — ``serve_loop.generate`` over contiguous
  caches, every request one prompt length, finishing together.

``--serve`` drives either paged engine through the asyncio streaming
front end (``runtime/server.py``): the requests are submitted
concurrently and consumed token by token, with admission bounded by
``--max-queue`` (``--backpressure reject`` sheds a request past it,
``wait`` parks its submitter); then the server shuts down.  The tokens
are the batch path's.  ``--temperature`` samples every request (request
b with seed ``--seed`` + b); ``--prefill-budget`` sets the prompt tokens
prefilled a step; ``--prefix-cache`` shares full-page prompt prefixes
copy-on-write: every prompt then starts with one shared preamble, and
the batch runs as two waves, the second mapping the first's pages in.

The engines serve decoder-only LMs: an encoder-decoder
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

``--tp N`` serves through N tensor-parallel ranks (the continuous or
pipelined engine): the launcher spawns one process a rank
(``launch/mesh.start_ranks``, a ``file://`` store in a temporary
directory), the page pools split over the ranks by KV heads when they
divide N, else by pages, and ``--shard-params`` cuts the weights too
(not an MoE arch's: expert parallelism is not ported, and it raises
``NotImplementedError``); rank 0 schedules and prints, the others follow
its plans.  With replicated weights the tokens are ``--tp 1``'s: a
'heads' rank's paged kernels plan their split of the keys for the
model's KV heads, so each head sums as on one device.
``--dist-backend`` names the collectives' backend: ``nccl`` (the
default on ``--device cuda``) needs one card a rank; ``gloo`` (the
default on ``--device cpu``) runs every rank on the one device, a card
shared by all ranks included — a check of the path, not a speed-up.

``--paged-backend`` selects the paged attention of BOTH phases (decode
steps and prefill chunks): ``auto`` launches the CUDA kernels on the card
and the plain versions on the CPU, ``cuda`` forces the kernels (raises on
the CPU), ``dense`` the plain versions everywhere.  ``--attention-backend``
does the same for the lockstep and encoder attentions and the dense
LUT-attention kernel (``auto`` | ``cuda`` | ``naive``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-32b \\
      --layers 4 --softmax rexp --precision uint8 --batch 4 \\
      --prompt-len 64 --new-tokens 32 --kv-dtype int8 --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-32b \\
      --scale-down 64,4,128 --layers 2 --device cpu --engine pipelined \\
      --serve --max-queue 2 --backpressure wait
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-32b \\
      --scale-down 64,4,128 --layers 2 --device cpu --tp 2 --shard-params
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \\
      --scale-down 64,4,128 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch deepseek-moe-16b --batch 4 --prompt-len 64 --new-tokens 16
"""

from __future__ import annotations

import argparse
import asyncio
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, RunConfig, get_arch
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.core.policies import SoftmaxPolicy
from repro_torch.kernels.lut_attention.ops import (
    resolve_attention_backend, resolve_paged_backend,
    resolve_paged_prefill_backend)
from repro_torch.models import build_model
from repro_torch.models.model_zoo import resolve_device
from repro_torch.runtime.engine import (EngineConfig, PipelinedEngine,
                                        ServingEngine)
from repro_torch.runtime.paged_cache import KV_DTYPES, PagedCacheConfig
from repro_torch.runtime.partitioning import check_shardable
from repro_torch.runtime.serve_loop import generate
from repro_torch.runtime.server import AsyncServingServer, ServerSaturatedError


async def serve_waves(eng, waves, max_queue, backpressure):
    """Stream every request of each wave through an
    :class:`AsyncServingServer` over ``eng``, the wave's requests
    concurrently; returns the results by request id (a request shed by
    ``backpressure="reject"`` has none)."""
    results = {}
    async with AsyncServingServer(eng, max_queue=max_queue,
                                  backpressure=backpressure) as srv:

        async def one(i, req):
            try:
                stream = await srv.submit(**req)
            except ServerSaturatedError as err:
                print(f"request {i}: shed ({err})")
                return None
            n = 0
            async for _tok in stream:
                n += 1
            res = await stream.result()
            print(f"request {res.request_id}: streamed {n} tokens (ttft "
                  f"{res.ttft_s:.3f}s, finish={res.finish_reason})")
            return res

        first = 0
        for reqs in waves:
            done = await asyncio.gather(*[one(first + i, r)
                                          for i, r in enumerate(reqs)])
            results.update({r.request_id: r for r in done if r is not None})
            first += len(reqs)
    print("server: clean shutdown")
    return results


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
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature of every request (0: greedy)")
    ap.add_argument("--engine", default="continuous",
                    choices=["continuous", "pipelined", "lockstep"])
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="pipelined engine: most device steps in flight "
                         "before the host waits on a harvest")
    ap.add_argument("--serve", action="store_true",
                    help="drive the engine through the asyncio streaming "
                         "front end instead of the batch path")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="--serve: admission bound on requests waiting "
                         "for a slot (default: unbounded)")
    ap.add_argument("--backpressure", default="reject",
                    choices=["reject", "wait"],
                    help="--serve: at --max-queue, shed new requests or "
                         "make their submitters wait")
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
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="prompt tokens prefilled per engine step "
                         "(default: one chunk)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share full-page prompt prefixes across requests "
                         "(refcounted pages, copy-on-write)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree of the continuous or "
                         "pipelined engine: one process a rank, the page "
                         "pools split by KV heads when they divide it, "
                         "else by pages; with replicated weights the "
                         "tokens are --tp 1's")
    ap.add_argument("--shard-params", action="store_true",
                    help="with --tp > 1: cut the weights over the ranks "
                         "instead of replicating them (matmul sums may "
                         "reassociate at roundoff level)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="--tp > 1: the collectives' backend (default nccl "
                         "on --device cuda, gloo on --device cpu); nccl "
                         "needs one card a rank, gloo shares one device")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.shard_params and args.tp <= 1:
        ap.error("--shard-params requires --tp > 1 (there is no mesh to "
                 "shard the weights over)")
    if args.shard_params:
        check_shardable(_arch(args))
    if args.dist_backend is None:
        args.dist_backend = "nccl" if args.device == "cuda" else "gloo"
    if args.tp > 1:
        arch = _arch(args)
        if args.engine == "lockstep" or build_model(arch).is_encdec:
            # never report single-device lockstep numbers as a --tp run
            ap.error("--tp > 1 requires the continuous engine "
                     "(attention-only decoder LM with --engine continuous)")
        spawn_ranks(_serve_rank, args.tp, backend=args.dist_backend,
                    device=args.device, args=(args,),
                    threads=1 if args.device == "cpu" else 0)
        return
    _serve(ap, args)


def _arch(args):
    """The served arch: ``--arch`` cut to ``--layers`` (and to
    ``--scale-down``'s widths)."""
    arch = get_arch(args.arch)
    if args.scale_down:
        d, h, v = (int(x) for x in args.scale_down.split(","))
        return arch.scaled_down(d_model=d, n_heads=h, vocab=v,
                                n_periods=args.layers or 2)
    return arch.with_layers(args.layers) if args.layers else arch


def _serve_rank(mesh, args) -> None:
    """One rank of ``--tp``: rank 0 serves and prints, the others follow."""
    _serve(argparse.ArgumentParser(), args, mesh)


def _serve(ap, args, mesh=None) -> None:
    device = resolve_device(mesh.device if mesh is not None else args.device)
    arch = _arch(args)
    model = build_model(arch)
    policy = (SoftmaxPolicy(impl=args.softmax, precision=args.precision)
              if args.softmax != "exact" else SoftmaxPolicy())
    run = RunConfig(dtype="bfloat16" if device.type == "cuda" else "float32",
                    softmax_policy=policy,
                    attention_backend=args.attention_backend,
                    paged_backend=args.paged_backend,
                    kv_dtype=args.kv_dtype)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen, device, dtype=torch.bfloat16
                        if device.type == "cuda" else None)
    rng = np.random.default_rng(args.seed)
    engine = args.engine
    if engine != "lockstep" and model.is_encdec:
        print(f"the {engine} engine serves decoder-only LMs; falling back "
              f"to lockstep")
        engine = "lockstep"
    if engine == "lockstep" and args.serve:
        ap.error("--serve requires the continuous or pipelined engine (the "
                 "lockstep path has no scheduler to stream from)")
    if engine == "lockstep" and args.prefix_cache:
        ap.error("--prefix-cache requires the continuous or pipelined "
                 "engine (the lockstep path has no page pool to share)")
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
                       max_new_tokens=args.new_tokens, encoder_input=frames,
                       temperature=args.temperature, seed=args.seed)
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
    engine_cls = PipelinedEngine if engine == "pipelined" else ServingEngine
    eng = engine_cls(model, params, run, EngineConfig(
        n_slots=args.batch, cache=cache, prefill_chunk=args.prefill_chunk,
        prefill_budget=args.prefill_budget, prefix_cache=args.prefix_cache,
        pipeline_depth=args.pipeline_depth, mesh=mesh,
        shard_params=args.shard_params), device=device)
    if mesh is not None and mesh.rank != 0:
        eng.follow()
        return
    try:
        _drive(args, arch, policy, cache, eng, rng, device)
    finally:
        eng.close()


def _drive(args, arch, policy, cache, eng, rng, device) -> None:
    """Serve the requests through ``eng`` and print what it did."""
    if eng.tp > 1:
        print(f"tensor-parallel tp={eng.tp} over {args.dist_backend}: "
              f"{eng.regime!r} regime (KVH={arch.n_kv_heads})"
              f"{', weights cut over the ranks' * args.shard_params}")
    tokens_in_pool = args.n_pages * args.page_size
    print(f"kv_dtype={args.kv_dtype}: {eng.stats.pool_bytes_per_layer} KV "
          f"pool bytes per layer, "
          f"{eng.stats.pool_bytes_per_layer / tokens_in_pool:g} per token"
          f"{' (rank 0)' * (eng.tp > 1)}")

    # with the prefix cache every prompt starts with one shared preamble,
    # and the batch runs as two waves: the first writes the preamble's
    # pages, the second (admitted after they are published) maps them in
    preamble = (rng.integers(0, arch.vocab_size, size=args.prompt_len // 2)
                if args.prefix_cache else None)

    def wave(w):
        reqs = []
        for b in range(args.batch):
            plen = max(1, int(rng.integers(args.prompt_len // 2,
                                           args.prompt_len + 1)))
            prompt = rng.integers(0, arch.vocab_size, size=plen)
            if preamble is not None:
                prompt = np.concatenate([preamble, prompt])[
                    :cache.max_context - args.new_tokens]
            reqs.append(dict(prompt=prompt, max_new_tokens=args.new_tokens,
                             temperature=args.temperature,
                             seed=args.seed + w * args.batch + b))
        return reqs

    waves = [wave(0)] + ([wave(1)] if args.prefix_cache else [])
    t0 = time.time()
    if args.serve:
        results = asyncio.run(serve_waves(eng, waves, args.max_queue,
                                          args.backpressure))
    else:
        results = {}
        for reqs in waves:
            handles = [eng.add_request(**r) for r in reqs]
            results.update({int(h): h.result() for h in handles})
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    ttfts = [r.ttft_s for r in results.values() if r.ttft_s is not None]
    toks = eng.stats.tokens
    st = eng.stats
    pipelined = (f"; depth {eng.depth}, {st.inflight_peak} steps in flight "
                 f"at most, {st.harvest_wait_s:.3f}s waiting on harvests, "
                 f"{st.speculative_wasted} slot-steps rolled back"
                 if isinstance(eng, PipelinedEngine) else "")
    print(f"{arch.name} x{arch.n_layers} layers on {device} "
          f"policy={policy.impl}/{policy.precision} "
          f"[{type(eng).__name__}{', streaming' * args.serve}; decode "
          f"attention: {resolve_paged_backend(args.paged_backend, device)}; "
          f"prefill attention: "
          f"{resolve_paged_prefill_backend(args.paged_backend, device)}]: "
          f"{toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s incl. kernel "
          f"build; {st.steps} decode steps, {st.prefill_steps} prefill "
          f"chunks of {args.prefill_chunk}, {st.preemptions} preemptions, "
          f"mean TTFT {np.mean(ttfts):.3f}s{pipelined})")
    if args.prefix_cache:
        print(f"prefix cache: {st.prefix_hit_tokens} prompt tokens served "
              f"from shared pages ({st.prompt_tokens} prefilled), "
              f"{st.pages_shared} pages shared, {st.cow_copies} "
              f"copy-on-write copies")
    print("sample token ids:", results[min(results)].tokens[:16].tolist())

if __name__ == "__main__":
    main()
