#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises (exit code ≠ 0):

1. device and build — needs ``torch.cuda.is_available()``; prints the
   card's name and power limit, then builds every CUDA kernel of the
   port from ``src/repro_torch/csrc`` (one ``nvcc`` per source, all at
   once: paged decode, paged prefill, dense LUT attention, row-wise LUT
   softmax, exact flash attention) and prints the build seconds and
   ptxas's report;
2. kernel against plain version — each paged kernel × {exact,
   rexp-uint8, lut2d-uint8} at Qwen3-32B width (H=64, KVH=8, Dh=128,
   page_size=16, ragged kv_lens up to 512, permuted block tables, finite
   junk in null and unused pages), and at GQA 6 and 12 (H=48 and 96 over
   8 KV heads) with block tables 512 pages wide and kv_lens up to 8192
   that cross the kernels' split ranges and page boundaries (a slot of
   0 keys, prefill rows past the logits cache), and at the MoE decoders'
   widths at the smoke's kv_lens and chunks (``MOE_SHAPES``: DeepSeek-
   MoE-16B's GQA 1, 16 / 16 heads of 128; Granite-MoE-3B's GQA 3, 24 / 8
   heads of 64):
   (a) exact-logit inputs (q, k small integers × 2^-2, so every dot order
       gives the same logits): outputs within 2e-6 — a LUT bin that moved
       would shift a weight by ≥ 1/qmax, far above that; on the long rows
       against the plain version's own weights carried through σ·V in
       f64 (within 2e-6, or twice the plain version's own distance from
       it where that is larger: over thousands of keys the f32 σ·V sum's
       roundoff reaches 2e-6 in any order);
   (b) random inputs in bf16 and f32: the max error and the share of rows
       beyond 1e-4, held to one LUT step (2/qmax · max|v|; 1e-4 · max|v|
       for exact), since the kernel and cuBLAS sum the dots in different
       orders and a logit on a bin edge may land in the neighbouring bin;
   then the kernel's time, the plain version's, SDPA on the gathered
   view for exact (a yardstick only: the port never calls it) and the
   least time the card could take, at each of the three widths; then one
   empty launch timed the same
   way (the harness's floor), the host's µs a wrapper call, and the
   sweep (:func:`sweep`: decode at B 1–64 × kv_len 1–8192, a 16-token
   prefill chunk at q_start 0–8176) on a bf16 pool;
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
   free-running streams are only printed);
4. int8 kernels against their plain versions — the int8-pool entry
   points (int8 pages, f32 per-token × KV-head scales; NaN and inf
   scales and junk codes in the null page) at the same widths, cases and
   policies, q in f32 and bf16: (a) exact-dequant inputs (codes in
   [−4, 4], power-of-two scales, so every dequantized value and dot is
   exact) within 2e-6; (b) rows quantized with ``quantize_rows`` from
   normal rows, within one LUT step; then their times beside the plain
   versions', SDPA on the dequantized gathered view for exact, and the
   bound (live int8 K+V bytes plus their f32 scales); the host's µs a
   call and the sweep on an int8 pool;
5. int8 engine — the same 8 requests and weights, REXP uint8,
   ``kv_dtype="int8"``, ``paged_backend="auto"``: both int8 launch
   counters must move; tok/s, TTFT and the pool's bytes per token per
   layer against the bf16 pool's; one profiled drive; the same run
   shadowed, every int8 kernel call held to its plain version on the
   engine's own inputs (one LUT step); under the exact policy the int8
   engine's first-token logits against int8 lockstep
   (``serve_loop.generate``, each request alone at B = 1 over
   contiguous fake-quantized caches, on the plain attention:
   ``attention_backend="naive"``) within 2%;
5b. pipelined engine and streaming server — the same model, requests,
   REXP uint8 and bf16 weights through ``PipelinedEngine`` (on-device
   sampling, one-step-ahead dispatch): at depths 1, 2 and 4 on the bf16
   pool and at depth 2 on the int8 pool every request's 32 greedy tokens
   must equal the synchronous engine's on the same pool, with the same
   paged launches (480 / 376); at temperature 0.8 the device's Gumbel-max
   draws must equal the synchronous engine's host-side ``sample_row``;
   a greedy and the sampled drive run every ``_dispatch`` under
   ``torch.cuda.set_sync_debug_mode("error")``, and every step hands
   the harvest ``(n_slots,)`` or ``(1,)`` int32 tokens; tok/s, mean TTFT,
   host ms a dispatch and harvest wait a step for sync, depths 1, 2, 4
   and sync again, and one profiled depth-2 drive's busy share beside the
   sync drive's (also its device time over the unprofiled drive's wall);
   then the 8 requests submitted concurrently through
   ``AsyncServingServer`` over a depth-2 engine (``max_queue=4``,
   ``backpressure="wait"``), consumed with ``async for``: every stream
   must equal its batch result (lines ``[pipelined]`` and ``[server]``);
5c. tensor-parallel paged serving — the same widths at 2 layers
   (``TP_LAYERS``) and the same requests (16 new tokens) through
   ``launch/mesh.start_ranks``: tp = 2 (the 'heads'
   regime: each rank holds 4 of the 8 KV heads and launches the paged
   CUDA kernels on them) and tp = 3 (the 'pages' regime: 8 % 3 ≠ 0, 128
   pages padded to 129, each rank a slab of 43 plus a sink page, its
   partials in plain torch), each rank a process sharing this card over
   gloo (the kernels built above; a card is one device, so NCCL cannot
   run): sync engines on bf16 pools under REXP and exact, a pipelined
   depth-2 drives (tp 2, REXP and exact), a ``shard_params`` drive (tp 2,
   exact) and int8 pools (tp 3, REXP and exact); against the tp = 1 sync
   engine of this call: the replicated-weight 'heads' drives' tokens
   all equal and their first-token logits ``torch.equal`` (the ranks'
   paged kernels plan their split of the keys for the model's 8 KV
   heads, so each head runs the tp = 1 arithmetic); elsewhere
   exact-policy first-token logits within 2% of the largest (REXP
   printed: its LUT steps turn the ranks' other summation orders into
   whole steps); the share of equal greedy tokens with the first parting
   decision's top-2 margin, every rank's paged launches (the tp = 1
   drive's in 'heads', none in 'pages'), and the decode collectives'
   bytes a layer within :func:`decode_wire_budget` (2·B·H·(D+2)·4; under
   ``shard_params`` plus 2·B·d_model·4, the norm scales the reference's
   serving spec stores cut, and in 'pages' the gathered q, k, v); under
   ``shard_params`` every rank's parameter bytes equal to the port's
   ``param_pspec(fsdp=False)`` shard shapes' (the rule the tests hold
   to the JAX package's) and a decode
   step's ``tp_gather`` bytes printed; its tok/s are shared-device gloo
   figures, not a tensor-parallel speed (lines ``[tp]``);
5d. the MoE decoders (lines ``[moe]``) — DeepSeek-MoE-16B (d_model
   2048, 16 / 16 heads of 128, 64 routed experts of 1408 plus 2 shared,
   top-6, vocab 102 400; 16.9B parameters in 28 layers) and
   Granite-MoE-3B (d_model 1536, 24 / 8 heads of 64, 40 experts of 512,
   top-8, tied embeddings; 32 layers) at full width, depth cut to 2
   layers (``MOE_LAYERS``), seeded random bf16 weights drawn and cast
   block by block, router f32 and exact, through the paged engines on
   the smoke's 8 requests
   (prompts over each model's vocabulary, 32 new tokens): DeepSeek
   under REXP uint8 on the bf16 and the int8 pool (the pool type's
   paged launches must move, the other's not), pipelined depth 2 on
   each with every ``_dispatch`` under ``set_sync_debug_mode("error")``
   (tokens and launches equal to the sync drive's), the exact policy on
   both pools, one profiled drive (busy share), every paged call of a
   drive held to its plain version on its own inputs (one LUT step) and
   a ``paged_backend="dense"`` drive (REXP printed); Granite under REXP
   and exact; for each, the exact drive's first-token logits within 2%
   of a dense-path drive that replays its expert choices (top-k routing
   is discontinuous: bf16 roundoff moves tokens across near-ties of the
   random router, and the count of such tokens is printed); tok/s and
   TTFT of every drive, the phase's seconds;
5e. the hybrid and recurrent decoders (lines ``[ssm]``) — Jamba-v0.1-52B
   at full width (d_model 4096, 32 / 8 heads of 128 without RoPE, Mamba
   d_inner 8192 and d_state 16, 16 experts of 14 336, top-2, vocab
   65 536), depth cut to one period of 8 layers (attention at index 3,
   Mamba elsewhere, the MoE FFN on odd layers: 13.3B parameters; the 32
   layers' ~103 GB in bf16 do not fit the card), seeded random bf16
   weights drawn and cast block by block, through ``serve_loop.generate``
   with ``attention_backend="auto"``: 4 prompts of 64 tokens, 32 new
   tokens, under REXP uint8 and 2D-LUT uint8 — exactly 32 dense
   launches a drive (the prompt's call on the tile route, 31 decode
   calls on the split route), every call of a shadowed drive within one
   LUT step of its plain version, REXP first-token logits within 2 % of
   a ``naive`` drive that replays the kernel drive's expert choices
   (:func:`pinned_routes`; the flipped routings printed), tok/s, the
   prefill's and a decode step's time, one profiled drive (busy share;
   matmuls, the dense kernel, everything else); the dense kernel at
   Jamba's two shapes (the prompt call: 64 rows over the first 64 keys
   of a 96-position cache; a decode call at kv_len 95) against its
   plain version, timed beside it, exact SDPA and its bound; then one
   Mamba block at Jamba's width (a 64-token prefill, 8 decode steps) and
   the whole xLSTM-125M (9 mLSTM + 3 sLSTM layers; the card's greedy
   drive teacher-forced for 32 steps) on the card against the CPU in
   f32, TF32 off: every output, logit and state leaf within 1e-4 of its
   largest entry; xLSTM's bf16 drive's tok/s and step times;
6. the dense LUT-attention kernel against its plain version, in its
   three modes (REXP's fused α form, REXP's and 2D-LUT's faithful σ),
   q/k/v in f32 and bf16, at Whisper-small's shapes: the encoder
   (B=2, 12 heads, Lq=Lk=1500, Dh=64), cross-attention (Lq 1 and 8
   against 1500 keys), the cached decoder self-attention (causal, 64
   positions allocated, kv_len 40, Lq 1 and 8), GQA at H=8, KVH=2,
   Dh=128, and Qwen3-32B's lockstep (H=64, KVH=8, Dh=128, causal, a
   300-token prompt and a decode step into 332 allocated positions);
   each call through the route the dispatcher picks (``dense_route``:
   the split route — the paged kernels' cluster design over contiguous
   keys — below ``MIN_TILE_ROWS`` rows, the tensor-core tile engine for
   longer bf16 calls, the row engine for the longer calls the tile
   engine does not take) and, where that is the tile or split route,
   through the row engine too: exact-logit inputs within 2e-6 of an f64
   referee, random ones within one LUT step, with the share of rows
   beyond 1e-4; every route timed at 1–128 query rows against 1500 keys
   (the route threshold); the few-row calls (Whisper's decode steps,
   Qwen3-32B's lockstep decode) timed on the split and row routes beside
   their plain version, exact SDPA on the same inputs and their bound;
   at Qwen3-32B's lockstep decode the host µs a call of the wrapper
   (a direct launch), of the bare launch and of the launch through the
   custom operator that fake tensors take (``[host]`` lines);
   then the encoder call at B=4 timed on the tile and row routes (L2
   flushed, median of 20) beside its plain version and exact SDPA, with
   its bound (the busiest of the tensor
   cores for both bf16 products at 989 TFLOP/s, the CUDA cores for the
   per-element LUT work at 67 TFLOP/s, and the bytes at 3.35 TB/s) and
   the bound as first stated (f32 q·kᵀ on the CUDA cores);
7. Whisper-small at full depth and width (12 + 12 layers), seeded
   random bf16 weights with non-zero biases, REXP uint8,
   ``attention_backend="auto"``: 4 clips of 1500 seeded random frames,
   one seeded 4–12-token prompt length, 32 greedy new tokens each
   through ``serve_loop.generate``; tok/s, the encode time and the mean
   decode step; exactly 12 + 24 · 32 = 780 dense launches (396 fused,
   384 faithful; by route as ``dense_route`` names them: the 12 encoder
   calls on the tile route, the prompt's and the decode steps' few-row
   calls on the split route); the same drive with every dense call held to its
   plain version on its own inputs (one LUT step); the ``naive`` drive's
   first-token logits within 2% of the largest under exact and REXP;
   one profiled drive (the dense kernel's ms by kernel name);
8. the row-wise LUT softmax through its op entry point
   ``lut_softmax(x, SoftmaxPolicy(impl, use_kernel=True))`` at full
   width — Whisper-small's encoder logits (4, 12, 1500, 1500) and
   Qwen3-32B's causal prefill logits (1, 64, 2048, 2048), upper
   triangle −inf — in f32 and bf16, REXP and 2D-LUT uint8: both launch
   counters must move, and every output is ``torch.equal`` to the plain
   version, and a ``[route]`` line names the launch each call took
   (route ``warp`` — a row in one warp's registers — or ``cta``, the
   vector width, the grid); then every precision (int16 at 300 columns)
   × bin mode × f32/bf16/f16 with fully masked rows and rows holding
   +inf / NaN, and the column-and-alignment sweep (``[rows]`` lines:
   1–65 536 columns, both routes, rows staged in shared memory or
   re-read, ``x[1:]`` and views one element off a 16-byte boundary, a
   single row, more rows than the persistent grid walks in one pass),
   all ``torch.equal``; the kernels' times in all eight cases (2 kernels
   × 2 shapes × f32/bf16) beside the plain versions', ``torch.softmax``
   on the same tensor (a yardstick of a memory-bound row pass, not the
   same function) and the bound (bytes in plus f32 bytes out at 3.35
   TB/s);
9. exact flash attention through ``flash_attention(backend="auto")`` at
   the Whisper encoder's shape (B=4, H=12, L=1500, Dh=64), Qwen3-32B's
   causal prefill (H=64, KVH=8, L=2048, Dh=128), a 16-token chunk at its
   tail and a 300-row chunk against 200 keys (100 rows see no key), f32
   and bf16, and two causal calls into a pre-allocated cache with a
   ``kv_len`` (one per sequence; one for all): the counter must move on
   both routes (bf16 on the tensor-core tile engine, f32 on the CUDA
   cores); the kernel's (out, m, l)
   within 2e-5 (out) and 1e-5 relative (m, l) of the plain version's (no
   TF32), on the picked route and, for bf16, on the CUDA-core route too,
   the rows that see no key exactly 0 / −inf / 0; then both routes'
   times beside the plain version's, SDPA's on the same inputs (a
   yardstick: the port never calls it) and the bound (bf16: q·kᵀ and
   three 16-bit pieces of p·V at the tensor-core peak; f32: both at the
   f32 peak; over the visible pairs) beside the bound as first stated;
10. training (lines ``[train]``), after every earlier phase has released
   its models (the memory still allocated printed at entry): a
   scaled-down Qwen3 and Granite-MoE (d_model 256, 4 heads, vocab 1024,
   2 layers; Granite's load-balance loss and routing backward) trained
   3 f32 steps from one seeded init on the card and on the CPU (TF32
   off): every loss and parameter leaf within 1e-4 of its largest
   entry; a ``ResilientTrainer`` on the card (``checkpoint_every=2``,
   checkpoints in a temporary directory removed after) with a failure
   injected once at step 4 recovers and reaches step 8 within 1e-6 of
   an uninterrupted run; Qwen3-32B widths (2 of 64 layers, 2.53B
   parameters, untied) trained 6 steps on one synthetic batch of 4 ×
   511 inputs in 2 microbatches, bf16 activations over f32 masters, lr
   1e-4: the step-0 loss within 0.5 of ln V, every loss finite, the
   last below the first; its step time, tokens/s, peak memory and the
   share of AdamW and the clip (CUDA events around them); then
   ``make_eval_step`` on the trained weights and a held-out batch
   (step 10 000 of the stream, as the launcher's evals) under exact, REXP
   uint8
   and 2D-LUT uint8, ``attention_backend`` auto and naive: exactly 2
   dense launches a LUT eval, on the tile route, every call of a
   shadowed eval within one LUT step (but rows — at most 4 a call —
   where roundoff carried Σ across a denominator bin edge: within one
   LUT step of the plain version at logits moved by 2^-20 relative and
   that bin moved one step, each printed),
   auto against naive within 1e-3,
   the LUT-minus-exact deltas printed; a ``SumCollector`` through one
   exact prefill, its samples within 1e-5 relative of the CPU's on the
   same slices, with its count, p99.9 and recommended table sizes; the
   dense kernel at the eval's call (B 4, 64 / 8 × 128, 511 × 511,
   causal, bf16 tiles) timed beside its plain version, exact SDPA and
   its bound;
11. the model across ranks (lines ``[ranks]``), each as rank processes
   sharing the card over gloo (one card: no NCCL), after phase 10:
   (a) DeepSeek-MoE-16B and Granite-MoE-3B at full width, 2 layers
   (``R_SERVE_LAYERS``), served at tp 2 ('heads') with ``shard_params`` — each rank holds 32
   of 64 / 20 of 40 experts, DeepSeek's shared MLP and both models'
   attention cut — on bf16 pools, the smoke's 8 requests with 16 new
   tokens, REXP and exact, each rank replaying the tp = 1 sync drive's
   expert choices (:func:`pinned_routes`; the flips printed): exact
   first-token logits within 2 % of that drive's, every rank's paged
   launches equal to it, its expert bytes half of the whole, its
   parameter bytes the port's serving spec's, a decode step's
   bytes a layer within phase 5c's ``shard_params`` bound (the ``moe``
   all-reduce in ``w_down``'s place; the norm scales' ``tp_gather``
   printed); then Granite-MoE-3B exact at tp 3 with ``shard_params``
   (``R_SERVE_PAGES``): its 8 KV heads do not divide 3, so the
   'pages' regime, while ``wq``'s 1536 columns and ``wo``'s 1536 rows
   do — q computed on the rank's columns and gathered (site ``qkv``),
   ``wo`` row-parallel with f32 partials — held as the tp 2 drives are
   (no paged launches on a rank: the 'pages' regime's partials are
   plain torch, and the tp = 1 drive's launches printed beside them);
   tok/s a shared-card gloo
   figure; (b) Granite-MoE-3B at full width, 2 layers, f32, trained 3
   steps at lr 1e-4 on a global batch of 4 × 256 on a (data 2, model
   2) mesh (FSDP over 'data', tensor and expert parallelism over
   'model') and on one rank from the same seeded init, the ranks
   replaying the single rank's expert choices: losses within 1e-4
   relative, step-0 gradients (gathered) within 1e-4 of each leaf's
   largest entry, the global norm within 1e-5; each rank's resident
   parameter and moment bytes, a step's collective bytes by site and
   the step seconds printed; the state saved whole (rank 0 writes),
   restored on one rank and trained 2 more steps: within 3e-4 of the
   uninterrupted single-rank run but Adam's flips; (c) GPipe over 2
   stages, each one full-width Granite-MoE layer (``make_stage_fn``),
   4 microbatches of 2 × 128 tokens: outputs and stage gradients within
   1e-6 of the largest entry of the sequential run on one rank (bitwise
   printed); (d) Jamba-v0.1-52B at full width, one period (13.3B
   parameters, f32), lockstep on a (data 1, model 2) mesh with every
   leaf stored as the JAX package's ``param_pspec(fsdp=True)`` cuts it
   — channel-parallel Mamba with its state ``h`` cut, the norm scales
   gathered before use, the experts and heads cut — each rank drawing
   the seeded init block by block and keeping its cut: 4 prompts of 64
   tokens and 8 new tokens, REXP and exact in f32 and exact in bf16,
   the ranks replaying a single-rank drive's expert choices: in f32 the
   exact drive's first-token and last-step logits within 1e-3 of that
   drive's largest and every token equal, REXP's first-token logits
   within 5e-3, the bf16 drive's figures printed; each rank's resident
   parameter bytes and Mamba ``h`` bytes equal to the JAX package's
   shard shapes', the collective bytes by site printed;
12. the reference's cells (lines ``[cells]``, after phase 11): (a) the
   dry run (``launch/cells.py``: one rank's step traced on meta tensors
   over a ``fake`` process group) of Qwen3-32B × ``decode_32k`` and
   Jamba-v0.1-52B × ``long_500k`` at one period on a (data 1, model 1)
   mesh and at full depth on the 16×16 mesh as rank 0, and of
   Granite-MoE-3B × ``train_4k`` on the 2×16×16 mesh, each record's line
   printed; (b) the same two one-period cells built for real on the
   card (``build_cell(..., probe=True, probe_periods=1,
   run_overrides={"attention_backend": "auto"})``, seeded bf16 weights,
   the cache filled with seeded random K/V to ``max_len − 1``
   positions): one decode step — B 128 over a 32 768-position cache of
   8 KV heads (the dense kernel's split route), and B 1 over 524 288
   positions (GQA 4) — its dense call within one LUT step of the plain
   version (the largest integer Σ printed; past 2^24 also the gap to
   the plain version with Σ in f64; faithful REXP gives σ = 0 on every
   key of these random caches, so the call's output is zero, and the
   share of all-zero rows is printed), the dense launches equal to the
   attention layers, ``FlopCounterMode``'s count of the real step plus
   ``dense_flops`` for each direct launch equal to the trace's, the
   step's peak memory within 10 % of the trace's estimate, and the
   kernel's time at both shapes (L2 flushed, median of 20) beside its
   bytes bound, its plain version and exact SDPA; then the same call on
   the same cache with four keys a KV head planted to dominate the
   logits (output not zero) under faithful REXP, fused REXP and 2D-LUT,
   each within one LUT step of the plain version, whose largest |value|
   must reach 8 steps; and the card's capacity against the dry run's
   ``fits_hbm_80g`` limit;
13. the examples (lines ``[examples]``, after phase 12): the four
   ``examples/*_torch.py``' ``main(device="cuda")`` in this process,
   each one's printed lines and kernel launches; quickstart's figures
   equal to its CPU run's, the others run to their end;
14. the kernel guard on the card (lines ``[guard]``, :func:`phase_guard`):
   every CUDA library's ``<name>_plan`` equal to the host library's
   (``csrc/launch_plan.h`` built by the host C++ compiler, the plans the
   kernel guard reads on a machine without a card) at each of the
   guard's geometries and the paged sweep's grid; each split-key
   instance's registers, local bytes and occupancy beside the CTAs a
   multiprocessor its plan counts on (printed); the single-device step
   contracts (``repro_torch.analysis.contracts``) on the card, each step
   under ``set_sync_debug_mode("error")``, each holding.

The whole run's seconds follow the phases.  The line before the last
is the card's name and power limit, the one before it a JSON summary of
the eight kernels (the two with several routes add the routes' times
and launches; the dense one also its few-row calls' times on the split
and row routes; the row kernels their eight cases under ``cases``, each
with its bound, route and ``torch.softmax`` time; the two f32/bf16
paged kernels their rows at the MoE widths under ``shapes``, with the
launches of that model's REXP bf16 drive, and the dense one its rows at
Jamba's two shapes, with the Jamba REXP drive's launches, and at the
Qwen3-32B eval's, with the REXP eval's launches and the full-width
step's numbers under ``train``, and at phase 12's two cells'); the last
line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import ARCHS, RunConfig  # noqa: E402
from repro_torch.core.calibration import SumCollector  # noqa: E402
from repro_torch.data.synthetic import DataConfig, SyntheticDataset  # noqa: E402,E501
from repro_torch.core import lut_softmax as LUT  # noqa: E402
from repro_torch.core.policies import SoftmaxPolicy  # noqa: E402
from repro_torch.core.precision import get_precision  # noqa: E402
from repro_torch.core.quantization import quantize_rows  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FOPS  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402,E501
    flash_attention_cuda, flash_attention_plain, flash_route)
from repro_torch.kernels.lut_softmax import ops as SOPS  # noqa: E402
from repro_torch.kernels.common import kernel_tables  # noqa: E402
from repro_torch.kernels.lut_softmax.lut_softmax import (  # noqa: E402
    lut2d_softmax_cuda, lut2d_softmax_plain, plan_for, rexp_softmax_cuda,
    rexp_softmax_plain)
from repro_torch.kernels.lut_attention import ops  # noqa: E402
from repro_torch.kernels.lut_attention import ref as REF  # noqa: E402
from repro_torch.kernels.lut_attention import lut_attention as DENSE  # noqa: E402,E501
from repro_torch.kernels.lut_attention.lut_attention import (  # noqa: E402
    MIN_TILE_ROWS, MODES, ROUTES, dense_flops, dense_route,
    lut_attention_cuda, lut_attention_plain)
from repro_torch.kernels.lut_attention.paged_decode import (  # noqa: E402
    paged_decode_attention, paged_decode_plain)
from repro_torch.kernels.lut_attention.paged_prefill import (  # noqa: E402
    paged_prefill_attention, paged_prefill_plain)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as LAYERS  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models import encdec as ENCDEC  # noqa: E402
from repro_torch.models.convert import (cast_params, tree_flatten,  # noqa: E402,E501
                                        tree_map)
from repro_torch.optim import adamw as ADAMW  # noqa: E402
from repro_torch.runtime import train_loop as TL  # noqa: E402
from repro_torch.runtime.fault_tolerance import ResilientTrainer  # noqa: E402,E501
from repro_torch.runtime.engine import (EngineConfig,  # noqa: E402
                                        PipelinedEngine, ServingEngine)
from repro_torch.runtime.paged_cache import PagedCacheConfig  # noqa: E402
from repro_torch.runtime.serve_loop import (generate,  # noqa: E402
                                            make_prefill_step)
from repro_torch.runtime.server import AsyncServingServer  # noqa: E402

#: H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
#: the operation rate for each input type (bf16 tensor cores; f32
#: outside the tensor cores, since TF32 would change the logits).  The
#: int8 kernels multiply bf16 queries by dequantized int8 rows, so their
#: operations are counted at the query type's rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
            torch.float32: 67e12}
#: f32 operations per element of the LUT pipeline (bins, lookups, Σ, σ)
ROW_OPS_PER_ELEMENT = 10

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
#: GQA 6 and 12 (H 48 and 96 over 8 KV heads, Dh 128) at long contexts:
#: block tables 512 pages wide, kv_lens that cross the kernels' split
#: ranges and page boundaries up to 8192 keys, a slot of 0 keys, and
#: prefill rows past the logits cache (those CTAs recompute q·k)
LONG_MP = 512
LONG_DECODE = [dict(h=48, kv_lens=(8192, 4111, 1000, 33, 1)),
               dict(h=96, kv_lens=(5003, 2049, 17, 0))]
LONG_PREFILL = [dict(h=48, q_start=(8176, 1000, 0), chunk_lens=(16, 9, 16)),
                dict(h=96, q_start=(2032, 40), chunk_lens=(16, 3))]
#: the MoE decoders' attention widths: DeepSeek-MoE-16B's MHA (GQA 1, 16
#: heads over 16 KV heads of 128) and Granite-MoE-3B's GQA 3 (24 heads
#: over 8 KV heads of 64) — phase 2 holds and times the paged kernels
#: there too, at the smoke's kv_lens and chunks
MOE_SHAPES = {"deepseek-moe-16b": dict(h=16, kvh=16, dh=128),
              "granite-moe-3b-a800m": dict(h=24, kvh=8, dh=64)}
EXACT_TOL = 2e-6


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Problems, timing, bounds
# ---------------------------------------------------------------------------


def pool_pages(kv_lens, mp):
    """Pages of a problem's pool: the null page, each slot's pages, and
    at the smoke's widths a slot's unowned share as well (junk pages the
    masks must keep out); long block tables get only the owned pages."""
    if mp > MP:
        return 1 + sum(-(-int(kl) // PS) for kl in kv_lens) + 4
    return 1 + len(kv_lens) * mp


def block_tables(rng, kv_lens, n_pages, mp):
    """Permuted block tables: slot i owns the next ceil(kv_lens[i]/PS)
    pages of a random order of the pool's non-null pages; the rest of
    its row points at the null page 0."""
    phys = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((len(kv_lens), mp), np.int32)
    start = 0
    for i, kl in enumerate(kv_lens):
        n_owned = -(-int(kl) // PS)
        bt[i, :n_owned] = phys[start:start + n_owned]
        start += n_owned if mp > MP else mp
    return bt


def paged_problem(rng, *, kv_lens, c, q_start, dtype, exact_logits, h=H,
                  mp=MP, kvh=KVH, dh=DH):
    """Pool + permuted block tables; slot i owns ceil(kv_lens[i]/PS)
    pages; every page (the null page and unowned pages too) holds finite
    junk, so only the masks keep it out.  Qwen3-32B's KV heads and head
    width unless ``kvh`` / ``dh`` say otherwise."""
    b = len(kv_lens)
    n_pages = pool_pages(kv_lens, mp)
    if exact_logits:
        q = rng.integers(-4, 5, size=(b, h, c, dh)) * 0.25
        k = rng.integers(-4, 5, size=(n_pages, PS, kvh, dh)) * 0.25
    else:
        q = rng.normal(size=(b, h, c, dh))
        k = rng.normal(size=(n_pages, PS, kvh, dh))
    v = rng.normal(size=(n_pages, PS, kvh, dh))
    bt = block_tables(rng, kv_lens, n_pages, mp)

    def dev(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), device="cuda").to(dt)

    return dict(q=dev(q), k_pages=dev(k), v_pages=dev(v),
                block_tables=dev(bt, torch.int32),
                kv_lens=dev(np.asarray(kv_lens, np.int32), torch.int32),
                q_start=dev(np.asarray(q_start, np.int32), torch.int32))


def int8_problem(rng, *, kv_lens, c, q_start, dtype, exact_logits, h=H,
                 mp=MP, kvh=KVH, dh=DH):
    """As :func:`paged_problem`, over an int8 pool with f32 row scales:
    exact-dequant or normal rows through ``quantize_rows``.  The null
    page holds junk codes and NaN / inf scales: only the masks keep it
    out.

    Exact-dequant: q small integers × 2^-2, codes in [−4, 4] and
    power-of-two scales 2^−3 … 2^−1, so every dequantized value and
    every dot is exact, and |k|, |v| ≤ 2 keep the problem conditioned
    like the float pools' exact-logit one.  With K scales up to 2^1 the
    logits span ±14, the exact policy's weights pile onto few keys of
    the largest |v|, and the f32 σ·V sum's own roundoff — the plain
    version's against an f64 evaluation of the same logits as much as
    the kernel's — reaches the 2e-6 limit in either summation order."""
    b = len(kv_lens)
    n_pages = pool_pages(kv_lens, mp)
    shape = (n_pages, PS, kvh, dh)

    def dev(x, dt):
        return torch.as_tensor(np.asarray(x), device="cuda").to(dt)

    if exact_logits:
        q = rng.integers(-4, 5, size=(b, h, c, dh)) * 0.25
        pools = [(dev(rng.integers(-4, 5, size=shape), torch.int8),
                  dev(2.0 ** rng.integers(-3, 0, size=shape[:3]),
                      torch.float32)) for _ in range(2)]
    else:
        q = rng.normal(size=(b, h, c, dh))
        pools = [quantize_rows(dev(rng.normal(size=shape), torch.float32))
                 for _ in range(2)]
    (kp, ks), (vp, vs) = pools
    kp[0], vp[0] = 127, -127
    ks[0], vs[0] = float("nan"), float("inf")
    bt = block_tables(rng, kv_lens, n_pages, mp)
    return dict(q=dev(q, dtype), k_pages=kp, v_pages=vp, k_scales=ks,
                v_scales=vs, block_tables=dev(bt, torch.int32),
                kv_lens=dev(np.asarray(kv_lens, np.int32), torch.int32),
                q_start=dev(np.asarray(q_start, np.int32), torch.int32))


def scales_of(p):
    """The int8 pool's scale keyword arguments (none for a float pool)."""
    return {k: p[k] for k in ("k_scales", "v_scales") if k in p}


def v_absmax(p):
    """max |v| over the pool; for an int8 pool dequantized, over the pages
    past the null page (whose scales are NaN / inf junk)."""
    if "v_scales" not in p:
        return float(p["v_pages"].float().abs().max())
    return float((p["v_pages"][1:].float()
                  * p["v_scales"][1:, ..., None]).abs().max())


def decode_args(p):
    return (p["q"], p["k_pages"], p["v_pages"], p["block_tables"],
            p["kv_lens"])


def prefill_args(p):
    return (p["q"], p["k_pages"], p["v_pages"], p["block_tables"],
            p["q_start"], p["kv_lens"])


def visible_pairs(kv_lens, q_start, c) -> int:
    """(query row, key) pairs the masks let through, summed over slots."""
    return sum(max(min(kl, qs + i + 1), 0) for kl, qs in zip(kv_lens, q_start)
               for i in range(c))


def bound(p, kv_lens, q_start, c, dtype):
    """Least time the card could take: each live K/V row, each query and
    each output read or written once, against q·k and σ·v over the
    visible (row, key) pairs at the input type's peak."""
    esize = torch.empty((), dtype=dtype).element_size()
    b, h = len(kv_lens), p["q"].shape[1]
    kvh, dh = p["k_pages"].shape[2:]
    live_rows = sum(min(kl, p["block_tables"].shape[1] * PS)
                    for kl in kv_lens)
    row_bytes = dh * p["k_pages"].element_size()
    if "k_scales" in p:
        row_bytes += 4                               # the row's f32 scale
    nbytes = (2 * live_rows * kvh * row_bytes       # K and V pages
              + b * h * c * dh * esize              # queries
              + b * h * c * dh * 4                  # f32 outputs
              + p["block_tables"].numel() * 4 + 2 * b * 4)
    ops_count = 4 * h * dh * visible_pairs(kv_lens, q_start, c)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_count / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(fn, iters=20, cold=True) -> float:
    """Median device time of one call, L2 cold: before each call a
    256 MiB write evicts the 50 MB L2 (with ``cold`` false it does not)
    and a spin keeps the device busy while the host enqueues the call,
    so the events bracket device work only."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if cold:
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


def empty_launch_ms() -> float:
    """The harness's floor: one one-element add under :func:`device_ms`."""
    x = torch.zeros(1, device="cuda")
    return device_ms(lambda: x.add_(1))


def host_us(fn, rounds=30, per_round=100) -> tuple[float, float, float]:
    """Host microseconds per call: (median, lowest, highest) over
    ``rounds`` rounds of ``per_round`` calls each, each round queued
    behind a device spin long enough that the device never drains the
    queue, so the host never waits on it."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        torch.cuda._sleep(20_000_000)
        t0 = time.perf_counter()
        for _ in range(per_round):
            fn()
        per_call.append((time.perf_counter() - t0) / per_round * 1e6)
        torch.cuda.synchronize()
    return float(np.median(per_call)), min(per_call), max(per_call)


def sdpa_ms(p, c, q_start_t):
    """Exact attention by one library call on the gathered view,
    dequantized for an int8 pool (the gather, the dequantization and the
    GQA head repeat stay outside the timed call)."""
    k, v = ops.gather_kv(p["k_pages"], p["v_pages"], p["block_tables"],
                         p["kv_lens"], **scales_of(p))
    k, v = k.to(p["q"].dtype), v.to(p["q"].dtype)
    g = p["q"].shape[1] // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    lk = k.shape[2]
    ki = torch.arange(lk, device="cuda")[None, None, None, :]
    qi = (q_start_t[:, None] + torch.arange(c, device="cuda")[None, :]
          )[:, None, :, None]
    mask = (ki <= qi) & (ki < p["kv_lens"][:, None, None, None])
    return device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        p["q"], k, v, attn_mask=mask))


# ---------------------------------------------------------------------------
# The paged sweep
# ---------------------------------------------------------------------------

SWEEP_MP = 512                       # pages of a block table: 8192 keys
SWEEP_B = (1, 4, 16, 64)
SWEEP_KV = (1, 64, 256, 257, 512, 2048, 8192)
SWEEP_PREFILL_Q = (0, 288, 2032, 8176)
SWEEP_PREFILL_B = (1, 4)


class SweepPool:
    """One K and one V pool on the card at Qwen3-32B's widths, bf16 or
    int8 with f32 row scales (seeded random rows; the null page 0 holds
    junk and, for int8, NaN / inf scales), carved into ``slots`` shares
    of ``mp`` pages; slot i's block table lists its share in a seeded
    random order.  Its calls pass the host's bound on the live lengths
    (``max_kv_len``), as the engine does."""

    def __init__(self, kind, slots, mp, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        shape = (1 + slots * mp, PS, KVH, DH)
        self.scales = {}
        if kind == "int8":
            self.k, self.v = (torch.randint(-127, 128, shape, generator=gen,
                                            device="cuda", dtype=torch.int8)
                              for _ in range(2))
            for name in ("k_scales", "v_scales"):
                s = torch.rand(shape[:3], generator=gen, device="cuda") / 64
                s[0] = float("nan")
                s[0, 0] = float("inf")
                self.scales[name] = s
        else:
            self.k, self.v = (torch.randn(shape, generator=gen, device="cuda")
                              .to(torch.bfloat16) for _ in range(2))
        self.bt = torch.stack([
            1 + i * mp + torch.randperm(mp, generator=gen, device="cuda")
            for i in range(slots)]).to(torch.int32)
        self.gen = gen

    def queries(self, b, c):
        return torch.randn((b, H, c, DH), generator=self.gen,
                           device="cuda").to(torch.bfloat16)

    def bound_ms(self, q, q_start, kv_lens):
        p = dict(q=q, k_pages=self.k, block_tables=self.bt[:len(kv_lens)],
                 **self.scales)
        return bound(p, kv_lens, q_start, q.shape[2], torch.bfloat16)[0]

    def decode(self, kernel, q, kv_lens, policy):
        kl = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
        bt = self.bt[:len(kv_lens)].contiguous()
        return lambda: kernel(q, self.k, self.v, bt, kl, policy,
                              max_kv_len=max(kv_lens), **self.scales)

    def prefill(self, kernel, q, q_start, kv_lens, policy):
        kl = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
        qs = torch.tensor(q_start, dtype=torch.int32, device="cuda")
        bt = self.bt[:len(kv_lens)].contiguous()
        return lambda: kernel(q, self.k, self.v, bt, qs, kl, policy,
                              max_kv_len=max(kv_lens), **self.scales)


def smoke_cases(pool, decode, prefill, policy):
    """``{name: call}`` of both kernels at the smoke's main shapes (decode
    B=4 over DECODE_KV_LENS, prefill PREFILL_MAIN's chunk) on ``pool``."""
    qs, n = PREFILL_MAIN["q_start"], PREFILL_MAIN["chunk_lens"]
    return {
        "paged_decode": pool.decode(decode, pool.queries(4, 1),
                                    DECODE_KV_LENS, policy),
        "paged_prefill": pool.prefill(
            prefill, pool.queries(1, CHUNK), qs,
            tuple(a + b for a, b in zip(qs, n)), policy)}


def sweep(decode, prefill, policy, kind, log=print):
    """Decode at B ∈ SWEEP_B × kv_len ∈ SWEEP_KV (every slot at that
    length) and a 16-token prefill chunk at q_start ∈ SWEEP_PREFILL_Q, B ∈
    SWEEP_PREFILL_B, on a ``kind`` pool whose block tables are 512 pages
    wide: separates the per-call cost from the per-key cost.  Returns a
    list of dicts (phase, B, kv_len or q_start, ms, bound_ms)."""
    pool = SweepPool(kind, max(SWEEP_B), SWEEP_MP, seed=11)
    rows = []
    for b in SWEEP_B:
        q = pool.queries(b, 1)
        for kv in SWEEP_KV:
            ms = device_ms(pool.decode(decode, q, (kv,) * b, policy))
            bms = pool.bound_ms(q, (kv - 1,) * b, (kv,) * b)
            rows.append(dict(phase="decode", pool=kind, B=b, kv_len=kv,
                             ms=ms, bound_ms=bms))
            log(f"[sweep] decode {kind} B={b} kv_len={kv}: {ms:.4f} ms, "
                f"bound {bms:.4f} ms ({bms / ms:.1%} of bound)")
    for b in SWEEP_PREFILL_B:
        q = pool.queries(b, CHUNK)
        for q0 in SWEEP_PREFILL_Q:
            kv = (q0 + CHUNK,) * b
            ms = device_ms(pool.prefill(prefill, q, (q0,) * b, kv, policy))
            bms = pool.bound_ms(q, (q0,) * b, kv)
            rows.append(dict(phase="prefill", pool=kind, B=b, q_start=q0,
                             ms=ms, bound_ms=bms))
            log(f"[sweep] prefill {kind} B={b} C={CHUNK} q_start={q0}: "
                f"{ms:.4f} ms, bound {bms:.4f} ms ({bms / ms:.1%} of "
                f"bound)")
    del pool
    torch.cuda.empty_cache()
    return rows


def host_times(decode, prefill, policy, kind, log=print):
    """Host µs per wrapper call at the smoke's main shapes (:func:`host_us`:
    30 rounds of 100 calls, no synchronize inside a round):
    ``{name: (median, lowest, highest)}``."""
    pool = SweepPool(kind, len(DECODE_KV_LENS), MP, seed=13)
    suffix = "_int8" if kind == "int8" else ""
    out = {}
    for name, fn in smoke_cases(pool, decode, prefill, policy).items():
        med, lo, hi = out[name + suffix] = host_us(fn)
        log(f"[host] {name}{suffix}: {med:.2f} us of host time a call "
            f"(median of 30 rounds of 100 calls, rounds {lo:.2f}–{hi:.2f})")
    return out


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
        print(f"[build] lib{name}.so entry points: {', '.join(r['entries'])}")
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    for name, r in report.items():
        for entry in r["entries"]:
            build.load(name, entry)


def plain_f64(p, policy):
    """The plain version's own weights carried through σ·V in f64: its f32
    logits, masks and policy softmax (``ops._policy_softmax``, what
    ``lut_attention_*_varlen`` run), then the product with the gathered
    V in f64.  The referee of the long rows: over thousands of keys the
    f32 σ·V sum's own roundoff, in any order, reaches the 2e-6 limit."""
    k, v = ops.gather_kv(p["k_pages"], p["v_pages"], p["block_tables"],
                         p["kv_lens"], **scales_of(p))
    q = p["q"]
    b, h, c, dh = q.shape
    s = ops._logits(q, k, dh ** -0.5)
    ki = torch.arange(k.shape[2], device="cuda")[None, None, None, :]
    qi = (p["q_start"][:, None] + torch.arange(c, device="cuda")[None, :]
          )[:, None, :, None]
    s = s.masked_fill(~((ki <= qi) & (ki < p["kv_lens"][:, None, None, None])),
                      float("-inf"))
    sigma = ops._policy_softmax(s, policy).double()
    kvh = v.shape[1]
    return torch.matmul(sigma.reshape(b, kvh, h // kvh, c, -1),
                        v.double().unsqueeze(2)).reshape(b, h, c, dh)


def check_kernel(name, kernel, plain, args_of, rng, cases,
                 make=paged_problem):
    """Hold ``kernel`` to ``plain`` on every case (problems from ``make``:
    float or int8 pools), each problem under every policy, the kernel
    given the longest kv_len as its ``max_kv_len`` (the engine's way);
    returns the
    max error of the exact-logit cases.  Rows longer than the smoke's
    512 keys hold both to :func:`plain_f64` on exact-logit inputs: the
    kernel within 2e-6 of it, or within twice the plain version's own
    distance from it where that is larger (the f32 σ·V roundoff)."""
    worst_exact = 0.0
    failures = []
    for dtype in (torch.float32, torch.bfloat16):
        for exact_logits in (True, False):
            for case in cases:
                p = make(rng, dtype=dtype, exact_logits=exact_logits,
                         **case)
                for pol_name, pol in POLICIES.items():
                    qmax = (get_precision(pol.precision).qmax
                            if pol.impl != "exact" else None)
                    out = kernel(*args_of(p), pol, **scales_of(p),
                                 max_kv_len=max(case["kv_lens"]))
                    ref = plain(*args_of(p), pol, **scales_of(p))
                    torch.cuda.synchronize()
                    err = (out - ref).abs()
                    max_err = float(err.max())
                    finite = bool(torch.isfinite(out).all())
                    if not finite:
                        failures.append(f"{name} {pol_name}: non-finite "
                                        f"output")
                    tag = (f"[kernel] {name} {pol_name} {str(dtype)[6:]} "
                           f"B={len(case['kv_lens'])} "
                           f"H={case.get('h', H)}/{case.get('kvh', KVH)} "
                           f"Dh={case.get('dh', DH)} "
                           f"max kv_len={max(case['kv_lens'])} "
                           f"{'exact-logit' if exact_logits else 'random'}")
                    if exact_logits and max(case["kv_lens"]) > MP * PS:
                        f64 = plain_f64(p, pol)
                        k_err = float((out.double() - f64).abs().max())
                        p_err = float((ref.double() - f64).abs().max())
                        limit = max(EXACT_TOL, 2 * p_err)
                        worst_exact = max(worst_exact, k_err)
                        print(f"{tag}: kernel–f64 {k_err:.3g}, plain–f64 "
                              f"{p_err:.3g} (limit {limit:.3g}), "
                              f"kernel–plain {max_err:.3g}")
                        if not k_err <= limit:
                            failures.append(f"{tag}: {k_err} > {limit}")
                    elif exact_logits:
                        worst_exact = max(worst_exact, max_err)
                        print(f"{tag}: max|err| {max_err:.3g} "
                              f"(limit {EXACT_TOL})")
                        if not max_err <= EXACT_TOL:
                            failures.append(f"{tag}: {max_err} > "
                                            f"{EXACT_TOL}")
                    else:
                        vmax = v_absmax(p)
                        limit = (2.0 / qmax if qmax else 1e-4) * vmax
                        rows = err.amax(dim=-1)
                        share = float((rows > 1e-4).float().mean())
                        print(f"{tag}: max|err| {max_err:.3g} (limit "
                              f"{limit:.3g}), rows beyond 1e-4: "
                              f"{share:.4%}")
                        if not max_err <= limit:
                            failures.append(f"{tag}: {max_err} > {limit}")
    if failures:
        raise AssertionError("kernel off its plain version:\n"
                             + "\n".join(failures))
    return worst_exact


def time_kernel(name, kernel, plain, args_of, rng, case, make=paged_problem):
    """Time the kernel, its plain version and (exact) SDPA at the main
    path's shapes in bf16; returns the main policy's row."""
    rows = {}
    c = case["c"]
    for pol_name, pol in POLICIES.items():
        p = make(rng, dtype=torch.bfloat16, exact_logits=False, **case)
        kw = scales_of(p)
        ms = device_ms(lambda: kernel(*args_of(p), pol, **kw,
                                      max_kv_len=max(case["kv_lens"])))
        plain_ms = device_ms(lambda: plain(*args_of(p), pol, **kw))
        lib = (sdpa_ms(p, c, p["q_start"]) if pol.impl == "exact" else None)
        b_ms, b_by = bound(p, case["kv_lens"], case["q_start"], c,
                           torch.bfloat16)
        print(f"[time] {name} {pol_name} bf16 B={len(case['kv_lens'])} "
              f"H={case.get('h', H)}/{case.get('kvh', KVH)} "
              f"Dh={case.get('dh', DH)} "
              f"C={c} kv_lens={list(case['kv_lens'])}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, "
              f"library {'n/a' if lib is None else f'{lib:.4f} ms'}, "
              f"bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of bound")
        rows[pol_name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by, library_ms=lib)
    return rows[MAIN_POLICY]


def phase_kernels(int8=False):
    """Phase 2, or with ``int8`` phase 4: both kernels held to their plain
    versions and timed, on float pools or on int8 pools — in phase 2 also
    at the MoE decoders' widths (``MOE_SHAPES``, each kernel's row under
    ``shapes``); then the sweep over batch and context length
    (:func:`sweep`) and the host's time per wrapper call on that pool
    type, and in phase 2 the harness's floor (one empty launch)."""
    rng = np.random.default_rng(2 if int8 else 0)

    def dec_case(kv_lens, **kw):
        return dict(kv_lens=kv_lens, c=1,
                    q_start=tuple(kl - 1 for kl in kv_lens), **kw)

    def pf_case(q_start, chunk_lens, **kw):
        return dict(kv_lens=tuple(q + n for q, n in zip(q_start, chunk_lens)),
                    c=CHUNK, q_start=q_start, **kw)

    dec_main = dec_case(DECODE_KV_LENS)
    pf_main, pf_ragged = pf_case(**PREFILL_MAIN), pf_case(**PREFILL_RAGGED)
    dec_long = [dec_case(mp=LONG_MP, **c) for c in LONG_DECODE]
    pf_long = [pf_case(mp=LONG_MP, **c) for c in LONG_PREFILL]
    make, suffix = (int8_problem, "_int8") if int8 else (paged_problem, "")
    results = {}
    for name, kernel, plain, args_of, cases, main in (
            ("paged_decode", paged_decode_attention, paged_decode_plain,
             decode_args, [dec_main, *dec_long], dec_main),
            ("paged_prefill", paged_prefill_attention, paged_prefill_plain,
             prefill_args, [pf_main, pf_ragged, *pf_long], pf_main)):
        name += suffix
        err = check_kernel(name, kernel, plain, args_of, rng, cases, make)
        results[name] = dict(max_abs_err=err,
                             **time_kernel(name, kernel, plain, args_of, rng,
                                           main, make))
        if int8:
            continue
        results[name]["shapes"] = {}
        for arch, shape in MOE_SHAPES.items():
            mine = [dict(c, **shape) for c in cases if c.get("mp", MP) == MP]
            err = check_kernel(name, kernel, plain, args_of, rng, mine, make)
            results[name]["shapes"][arch] = dict(
                max_abs_err=err, **time_kernel(name, kernel, plain, args_of,
                                               rng, dict(main, **shape),
                                               make))
    kind = "int8" if int8 else "bf16"
    pol = POLICIES[MAIN_POLICY]
    if not int8:
        print(f"[floor] one empty launch (a one-element add, as the kernels "
              f"are timed): {empty_launch_ms():.4f} ms")
    host_times(paged_decode_attention, paged_prefill_attention, pol, kind)
    sweep(paged_decode_attention, paged_prefill_attention, pol, kind)
    return results


def engine_config(depth=2):
    return EngineConfig(n_slots=N_SLOTS, prefill_chunk=CHUNK,
                        pipeline_depth=depth,
                        cache=PagedCacheConfig(n_pages=128, page_size=PS,
                                               max_pages_per_seq=MP))


def watch_pipelined(eng, dispatch_s, guard_sync=False):
    """Instrument a ``PipelinedEngine``: each ``_dispatch``'s host seconds
    go to ``dispatch_s``; every step it hands to the harvest must be an
    ``(n_slots,)`` (decode) or ``(1,)`` (final chunk) int32 tensor on the
    card, copied into a pinned host tensor of the same shape.  With
    ``guard_sync`` every ``_dispatch`` runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a blocking copy,
    ``.item()``, ``.cpu()`` or a pageable host-to-device copy inside it
    raises; the mode is restored after each."""
    dispatch, push = eng._dispatch, eng._push_inflight

    def timed():
        t0 = time.perf_counter()
        prev = torch.cuda.get_sync_debug_mode()
        if guard_sync:
            torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
            dispatch_s.append(time.perf_counter() - t0)

    def checked(toks, entries, kind):
        want = (N_SLOTS,) if kind == "decode" else (1,)
        push(toks, entries, kind)
        host = eng._inflight[-1].tokens
        if not (tuple(toks.shape) == want == tuple(host.shape)
                and toks.dtype == host.dtype == torch.int32 and toks.is_cuda
                and host.is_pinned()):
            raise AssertionError(f"{kind} step handed the harvest "
                                 f"{tuple(toks.shape)} {toks.dtype} on "
                                 f"{toks.device}, not {want} int32 tokens")

    eng._dispatch, eng._push_inflight = timed, checked


def run_engine(model, params, policy, backend, requests, shadow=None,
               around=None, kv_dtype="f32", depth=None, temperature=0.0,
               guard_sync=False, tag=None):
    """Serve ``requests`` through a fresh bf16 engine whose pool is
    ``kv_dtype``; returns the results, each request's first-token
    logits, the kernels' launches during the drive, its wall seconds,
    the engine's stats and the host seconds of each dispatch.
    ``around`` is a context manager entered around the drive only (a
    profiler).  Request r samples at ``temperature`` with seed r.

    ``depth`` serves through a ``PipelinedEngine`` of that pipeline depth
    instead of the synchronous ``ServingEngine``, watched by
    :func:`watch_pipelined` (which ``guard_sync`` passes on); its
    first-token logits never reach the host, so none are recorded.

    ``shadow`` (a list) makes every paged-attention call of the engine
    also run the plain version (``backend="dense"``) on the same inputs,
    appending ``(dispatcher, max error, one-LUT-step bound, share of rows
    beyond 1e-4)``; the model's dispatchers are restored after.  ``tag``
    starts the printed line in place of ``[engine]`` / ``[pipelined]``.
    """
    run = RunConfig(dtype="bfloat16", softmax_policy=policy,
                    paged_backend=backend, kv_dtype=kv_dtype)
    dispatch_s = []
    if depth is None:
        eng = ServingEngine(model, params, run, engine_config(),
                            device="cuda")
    else:
        eng = PipelinedEngine(model, params, run, engine_config(depth),
                              device="cuda")
        watch_pipelined(eng, dispatch_s, guard_sync)
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
            v = args[2].float()
            if kw.get("v_scales") is not None:
                v = v * kw["v_scales"][..., None]
            shadow.append((dispatch.__name__, float(rows.max()),
                           step * float(v.abs().max()),
                           float((rows > 1e-4).float().mean())))
            return out
        return call

    if shadow is not None:
        LAYERS.lut_attention_paged_decode = shadowed(
            ops.lut_attention_paged_decode)
        LAYERS.lut_attention_paged_prefill = shadowed(
            ops.lut_attention_paged_prefill)
    try:
        for rid, (prompt, n_new) in enumerate(requests):
            eng.add_request(prompt, n_new, temperature=temperature, seed=rid)
        torch.cuda.synchronize()
        for wrapper in (paged_decode_attention, paged_prefill_attention):
            wrapper.launches = wrapper.int8_launches = 0
        with around or contextlib.nullcontext():
            t0 = time.perf_counter()
            results = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        LAYERS.lut_attention_paged_decode = ops.lut_attention_paged_decode
        LAYERS.lut_attention_paged_prefill = ops.lut_attention_paged_prefill
    launches = {"paged_decode": paged_decode_attention.launches,
                "paged_prefill": paged_prefill_attention.launches,
                "paged_decode_int8": paged_decode_attention.int8_launches,
                "paged_prefill_int8": paged_prefill_attention.int8_launches}
    for rid, res in results.items():
        if len(res.tokens) != requests[rid][1]:
            raise AssertionError(f"{backend}: request {rid} gave "
                                 f"{len(res.tokens)} tokens")
    ttft = np.mean([r.ttft_s for r in results.values()])
    name = (policy.impl if policy.impl == "exact"
            else f"{policy.impl}-{policy.precision}")
    st = eng.stats
    kind = ("[engine]" if depth is None else
            f"[pipelined] depth {depth}{' (sync-guarded)' * guard_sync}")
    if tag is not None:
        kind = (f"{tag} sync" if depth is None else
                f"{tag} pipelined{kind[len('[pipelined]'):]}")
    temp = f" temperature {temperature}" if temperature > 0 else ""
    harvests = st.steps + st.prefills
    extra = ("" if depth is None else
             f", host {np.mean(dispatch_s) * 1e3:.3f} ms a dispatch "
             f"({len(dispatch_s)}), harvest wait "
             f"{st.harvest_wait_s / harvests * 1e3:.3f} ms a step "
             f"({harvests}), {st.inflight_peak} steps in flight at most")
    print(f"{kind} {name}{temp} kv_dtype={kv_dtype} paged_backend={backend}"
          f"{' (shadowed)' if shadow is not None else ''}: {len(results)} "
          f"requests, {st.tokens} tokens in {wall:.2f}s "
          f"({st.tokens / wall:.1f} tok/s), mean TTFT {ttft:.3f}s, "
          f"{st.steps} decode steps, {st.prefill_steps} "
          f"prefill chunks, {st.preemptions} preemptions{extra}, kernel "
          f"launches {launches}")
    return results, first_logits, launches, wall, st, dispatch_s


def profiler_runs() -> bool:
    """Can torch.profiler trace this card at all?  Prints "not measured"
    when it cannot."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
    except (RuntimeError, AssertionError) as err:
        print(f"[profile] the profiler did not run ({err}): not measured")
        return False
    return True


def profile_drive(model, params, requests, kv_dtype="f32", depth=None,
                  label=None):
    """Where the main path's device time goes: torch.profiler's kernel
    times over one drive (through a ``PipelinedEngine`` of ``depth`` if
    given), grouped, and the device's busy share of the drive's wall
    time (the profiler's own cost lengthens the wall time, so the share
    is a lower bound).  Prints "not measured" when the profiler records
    no device time.  ``label`` names the model in the printed line."""
    from torch.profiler import ProfilerActivity, profile
    if not profiler_runs():
        return None
    prof = profile(activities=[ProfilerActivity.CUDA])
    wall = run_engine(model, params, POLICIES[MAIN_POLICY], "auto",
                      requests, around=prof, kv_dtype=kv_dtype,
                      depth=depth)[3]
    kernels = []
    for e in prof.key_averages():
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            kernels.append((us, e.count, e.key))
    if not kernels:
        print("[profile] the profiler recorded no device time: not measured")
        return None
    busy = sum(us for us, _, _ in kernels) / 1e6
    groups = {"paged attention kernels": ("paged_attention_kernel",),
              "matmuls": ("gemm", "gemv", "nvjet", "cutlass", "xmma",
                          "sm90_")}
    shares = {g: sum(us for us, _, k in kernels
                     if any(n in k for n in names)) / 1e6
              for g, names in groups.items()}
    shares["everything else"] = busy - sum(shares.values())
    engine = "sync" if depth is None else f"pipelined depth {depth}"
    print(f"[profile] {label + ' ' if label else ''}{MAIN_POLICY} "
          f"kv_dtype={kv_dtype} {engine} drive, "
          f"profiled: "
          f"device busy "
          f"{busy * 1e3:.1f} ms of {wall * 1e3:.1f} ms wall "
          f"({busy / wall:.1%}); "
          + "; ".join(f"{g} {t * 1e3:.1f} ms ({t / busy:.1%})"
                      for g, t in shares.items()))
    for us, count, key in sorted(kernels, reverse=True)[:8]:
        print(f"[profile]   {us / 1e3:8.2f} ms  {count:5d} calls  {key[:90]}")
    return busy, wall


def compare_runs(label, a, b, tag="[engine]"):
    """First-token logits max|Δ|/max|logit| and the share of generated
    tokens that agree between two engine runs."""
    worst = max(float(np.abs(row - b[1][rid]).max()
                      / np.abs(b[1][rid]).max()) for rid, row in a[1].items())
    agree = float(np.mean([np.mean(a[0][r].tokens == b[0][r].tokens)
                           for r in a[0]]))
    print(f"{tag} {label}: first-token logits max|Δ|/max|logit| "
          f"{worst:.4g}; tokens agreeing {agree:.1%}")
    return worst


def check_shadow(shadow, label, tag="[engine]"):
    """Every kernel call of a shadowed drive within one LUT step of its
    plain version on the same inputs."""
    worst = max(e for _, e, _, _ in shadow)
    beyond = max(s for _, _, _, s in shadow)
    print(f"{tag} shadowed {label}: {len(shadow)} kernel calls held to "
          f"the plain version on the same inputs: max|err| {worst:.3g}, "
          f"largest share of rows beyond 1e-4 in one call {beyond:.4%}")
    for i, (name, err, limit, share) in enumerate(shadow):
        if not err <= limit:
            raise AssertionError(f"kernel call {i} ({name}) off its plain "
                                 f"version by {err} > one LUT step {limit}"
                                 f" ({share:.4%} of rows beyond 1e-4)")
    return worst


def setup_model():
    """Qwen3-32B widths, 4 of 64 layers, seeded random bf16 weights, and
    the 8 requests every drive serves."""
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
    return model, params, make_requests(arch.vocab_size)


def make_requests(vocab):
    """The smoke's 8 requests: seeded 16–300-token prompts over ``vocab``
    (the same lengths for every model) and 32 new tokens each."""
    rng = np.random.default_rng(1)
    return [(rng.integers(0, vocab, size=int(n)).tolist(), 32)
            for n in rng.integers(16, 301, size=8)]


def phase_engine(model, params, requests):
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
    main = POLICIES[MAIN_POLICY]
    main_run = run_engine(model, params, main, "auto", requests)
    launches = main_run[2]
    if not (launches["paged_decode"] > 0 and launches["paged_prefill"] > 0):
        raise AssertionError(f"main path skipped a kernel: {launches}")

    busy = profile_drive(model, params, requests)
    shadow = []
    run_engine(model, params, main, "auto", requests, shadow=shadow)
    check_shadow(shadow, "main path")

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
    return launches, main_run[4], busy


def lockstep_first_logits(model, params, policy, requests):
    """First-token logits of int8 lockstep: each request alone at B = 1
    through ``serve_loop`` over contiguous caches fake-quantized with
    the int8 pool's rounding; ``generate``'s token must be their
    argmax."""
    run = RunConfig(dtype="bfloat16", softmax_policy=policy, kv_dtype="int8",
                    attention_backend="naive")
    out = {}
    for rid, (prompt, _) in enumerate(requests):
        tokens = torch.tensor([prompt], dtype=torch.int32, device="cuda")
        logits, _ = make_prefill_step(model, run, len(prompt) + 1)(params,
                                                                   tokens)
        tok = generate(model, params, tokens, run, max_new_tokens=1)
        row = logits[0, 0].float().cpu().numpy()
        if int(tok[0, 0]) != int(np.argmax(row)):
            raise AssertionError(f"lockstep request {rid}: generate gave "
                                 f"{int(tok[0, 0])}, argmax {np.argmax(row)}")
        out[rid] = row
    return out


def phase_int8_engine(model, params, requests, bf16_stats):
    """The int8 main path (REXP uint8, ``kv_dtype="int8"``, ``auto``)
    timed and counted, profiled, shadowed; then the exact policy's int8
    engine against int8 lockstep — the card's form of the JAX package's
    int8 engine ≡ int8 lockstep check (``benchmarks/serving_throughput``).
    Lockstep fake-quantizes into bf16 caches and prefills whole prompts
    while the engine dequantizes in f32 inside the kernels and prefills
    in chunks, so the two differ by bf16 roundoff: first-token logits
    within 2% of the largest, as for the kernel-vs-dense pair."""
    main = POLICIES[MAIN_POLICY]
    main_run = run_engine(model, params, main, "auto", requests,
                          kv_dtype="int8")
    launches = main_run[2]
    if not (launches["paged_decode_int8"] > 0
            and launches["paged_prefill_int8"] > 0):
        raise AssertionError(f"int8 path skipped a kernel: {launches}")
    if launches["paged_decode"] or launches["paged_prefill"]:
        raise AssertionError(f"int8 path launched a float-pool kernel: "
                             f"{launches}")
    stats = main_run[4]
    tokens_in_pool = 128 * PS
    per_tok = stats.pool_bytes_per_layer / tokens_in_pool
    bf16_tok = bf16_stats.pool_bytes_per_layer / tokens_in_pool
    kvh, dh = model.cfg.n_kv_heads, model.cfg.resolved_head_dim
    print(f"[int8] KV pool bytes per token per layer: int8 {per_tok:g} B "
          f"(pages {2 * kvh * dh} + scales {2 * kvh * 4}) against bf16 "
          f"{bf16_tok:g} B: {per_tok / bf16_tok:.3f}x")
    if per_tok != 2 * kvh * (dh + 4) or bf16_tok != 2 * kvh * dh * 2:
        raise AssertionError("pool bytes off the int8 / bf16 layouts")

    profile_drive(model, params, requests, kv_dtype="int8")
    shadow = []
    run_engine(model, params, main, "auto", requests, shadow=shadow,
               kv_dtype="int8")
    check_shadow(shadow, "int8 path")

    exact = POLICIES["exact"]
    eng = run_engine(model, params, exact, "auto", requests, kv_dtype="int8")
    lock = lockstep_first_logits(model, params, exact, requests)
    worst = max(float(np.abs(row - lock[rid]).max() / np.abs(lock[rid]).max())
                for rid, row in eng[1].items())
    agree = np.mean([eng[0][rid].tokens[0] == np.argmax(lock[rid])
                     for rid in lock])
    print(f"[int8] exact int8 engine vs int8 lockstep: first-token logits "
          f"max|Δ|/max|logit| {worst:.4g}; first tokens agreeing "
          f"{agree:.1%}")
    if not worst <= 0.02:
        raise AssertionError(f"int8 engine vs int8 lockstep first-token "
                             f"logits differ by {worst:.3g} > 0.02")
    return launches


# ---------------------------------------------------------------------------
# Phase 5b: the pipelined engine and the streaming server
# ---------------------------------------------------------------------------


def same_as_sync(label, got, ref):
    """Every request's tokens and the drive's kernel launches equal the
    synchronous drive's; prints how many tokens agree."""
    agree = sum(int((got[0][r].tokens == ref[0][r].tokens).sum())
                for r in ref[0])
    total = sum(len(res.tokens) for res in ref[0].values())
    print(f"[pipelined] {label}: {agree} of {total} tokens equal the "
          f"synchronous engine's; launches {got[2]} against {ref[2]}")
    bad = [r for r in ref[0] if not np.array_equal(got[0][r].tokens,
                                                   ref[0][r].tokens)]
    if bad or got[2] != ref[2]:
        raise AssertionError(f"{label}: requests {bad} differ from the "
                             f"synchronous engine, or launches {got[2]} "
                             f"!= {ref[2]}")


def serve_streams(model, params, requests, card):
    """The 8 requests submitted concurrently through an
    ``AsyncServingServer`` over a depth-2 ``PipelinedEngine`` (bf16
    pool), ``max_queue=4``, ``backpressure="wait"``, each consumed with
    ``async for``; returns (streamed tokens, result, seconds from submit
    to first streamed token) per request and the drive's launches."""
    eng = PipelinedEngine(model, params, RunConfig(
        dtype="bfloat16", softmax_policy=POLICIES[MAIN_POLICY],
        paged_backend="auto"), engine_config(2), device="cuda")

    async def go():
        async with AsyncServingServer(eng, max_queue=4,
                                      backpressure="wait") as srv:
            async def one(prompt, n_new):
                t0 = time.perf_counter()
                stream = await srv.submit(prompt, n_new)
                toks, first = [], None
                async for tok in stream:
                    if first is None:
                        first = time.perf_counter() - t0
                    toks.append(tok)
                return toks, await stream.result(), first

            return await asyncio.wait_for(asyncio.gather(
                *[one(p, n) for p, n in requests]), 300)

    torch.cuda.synchronize()
    for wrapper in (paged_decode_attention, paged_prefill_attention):
        wrapper.launches = wrapper.int8_launches = 0
    t0 = time.perf_counter()
    outs = asyncio.run(go())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_decode": paged_decode_attention.launches,
                "paged_prefill": paged_prefill_attention.launches}
    firsts = [f for _, _, f in outs]
    n_tok = sum(len(t) for t, _, _ in outs)
    print(f"[server] AsyncServingServer over PipelinedEngine depth 2, "
          f"max_queue 4, backpressure wait: {len(outs)} streams, {n_tok} "
          f"tokens in {wall:.2f}s ({n_tok / wall:.1f} tok/s), submit to "
          f"first streamed token mean {np.mean(firsts):.3f}s, max "
          f"{max(firsts):.3f}s; {eng.stats.steps} decode steps, launches "
          f"{launches} — {card}")
    if not (launches["paged_decode"] > 0 and launches["paged_prefill"] > 0):
        raise AssertionError(f"server drive skipped a kernel: {launches}")
    return outs


def phase_pipelined(model, params, requests, card, sync_busy):
    """Phase 5b: the pipelined engine (on-device sampling, one-step-ahead
    dispatch) against the synchronous engine on the same requests, then
    the streaming server over it.

    The shapes are fixed ((n_slots, 1) decode, (1, chunk) prefill) and the
    kernels the same, so the greedy tokens must equal the sync engine's
    bit for bit — at depths 1, 2 and 4 on the bf16 pool and at depth 2 on
    the int8 pool — with the same paged launches (the drive has no EOS,
    so nothing is speculated away).  At temperature 0.8 the device's
    Gumbel-max draws must equal the sync engine's host-side
    ``sample_row`` draws of the same hash.  Two drives (one greedy, the
    sampled one) run every ``_dispatch`` under
    ``set_sync_debug_mode("error")``.  Then the
    times: sync, depths 1, 2 and 4, sync again; and one profiled depth-2
    drive's busy share beside the sync drive's.  The server's streams
    must equal the batch results.
    """
    main = POLICIES[MAIN_POLICY]
    timed = [("sync", run_engine(model, params, main, "auto", requests))]
    sync = timed[0][1]
    for depth in (1, 2, 4):
        got = run_engine(model, params, main, "auto", requests, depth=depth)
        same_as_sync(f"depth {depth}, bf16 pool", got, sync)
        timed.append((f"depth {depth}", got))
    timed.append(("sync", run_engine(model, params, main, "auto",
                                     requests)))
    same_as_sync("sync again, bf16 pool", timed[-1][1], sync)
    for label, r in timed:
        st = r[4]
        per = (f", host {np.mean(r[5]) * 1e3:.3f} ms a dispatch, harvest "
               f"wait {st.harvest_wait_s / (st.steps + st.prefills) * 1e3:.3f}"
               f" ms a step" if r[5] else
               f", {r[3] / (st.steps + st.prefill_steps) * 1e3:.3f} ms a "
               f"step (decode or chunk)")
        print(f"[pipelined] {label:8s} {st.tokens / r[3]:7.1f} tok/s, mean "
              f"TTFT {np.mean([x.ttft_s for x in r[0].values()]):.3f}s"
              f"{per} — {card}")

    sync8 = run_engine(model, params, main, "auto", requests,
                       kv_dtype="int8")
    same_as_sync("depth 2, int8 pool", run_engine(
        model, params, main, "auto", requests, kv_dtype="int8", depth=2),
        sync8)
    hot = run_engine(model, params, main, "auto", requests, temperature=0.8)
    same_as_sync("temperature 0.8, depth 2, bf16 pool, every dispatch "
                 "under set_sync_debug_mode('error')", run_engine(
                     model, params, main, "auto", requests, depth=2,
                     temperature=0.8, guard_sync=True), hot)
    moved = sum(int((hot[0][r].tokens != sync[0][r].tokens).sum())
                for r in sync[0])
    print(f"[pipelined] temperature 0.8: {moved} of {hot[4].tokens} tokens "
          f"differ from the greedy drive's")
    if not moved:
        raise AssertionError("sampling at temperature 0.8 never left the "
                             "argmax")
    same_as_sync("every dispatch under set_sync_debug_mode('error'), depth "
                 "2", run_engine(model, params, main, "auto", requests,
                                 depth=2, guard_sync=True), sync)

    busy = profile_drive(model, params, requests, depth=2)
    sync_wall = np.mean([r[3] for label, r in timed if label == "sync"])
    depth2_wall = dict(timed)["depth 2"][3]

    def share(b, wall):
        if b is None:
            return "not measured"
        return (f"{b[0] / b[1]:.1%} of the profiled drive, its "
                f"{b[0] * 1e3:.1f} ms of device time over the unprofiled "
                f"drive's "
                f"{wall * 1e3:.1f} ms wall {b[0] / wall:.1%}")
    print(f"[pipelined] device busy: sync {share(sync_busy, sync_wall)}; "
          f"pipelined depth 2 {share(busy, depth2_wall)} — {card}")

    outs = serve_streams(model, params, requests, card)
    for rid, (toks, res, _) in enumerate(outs):
        if not (toks == res.tokens.tolist() == sync[0][rid].tokens.tolist()):
            raise AssertionError(f"server stream {rid} differs from the "
                                 f"batch result")
    print("[server] every stream equals its batch result")


# ---------------------------------------------------------------------------
# Phase 5c: tensor-parallel serving, ranks sharing the one card over gloo
# ---------------------------------------------------------------------------

TP_NEW_TOKENS = 16
#: phase 5c's depth: Qwen3-32B widths at 2 layers, not the engine
#: phases' 4 — the rank phases take longest on a loaded host (5c took
#: 138–196 s at 4 layers, this script on an H100 80GB HBM3, 700 W)
TP_LAYERS = 2
#: per tp, the drives: (label, policy, kv_dtype, pipeline depth or None
#: for the sync engine, shard_params).  tp 2 splits Qwen3-32B's 8 KV
#: heads ('heads'); tp 3 does not divide them ('pages', 128 pages padded
#: to 129).  A 'heads' rank with replicated weights runs the tp = 1
#: arithmetic head for head (its paged kernels plan their split of the
#: keys for the model's 8 KV heads): its tokens must equal the tp = 1
#: engine's and its first-token logits be ``torch.equal`` to them, under
#: REXP and exact, sync and pipelined.  Elsewhere the ranks sum in other
#: orders (the 'pages' partials, the cut weights' bf16 partial products):
#: the first-token logits are held within 2% of the tp = 1 engine's
#: under the exact policy, as in phase 3, and REXP's piecewise-constant
#: numerators carry such roundoff into whole LUT steps, so its drives
#: print the gap and the first parting decision's top-2 margin
TP_DRIVES = {
    2: [("sync bf16 pool", MAIN_POLICY, "f32", None, False),
        ("sync bf16 pool", "exact", "f32", None, False),
        ("pipelined depth 2, bf16 pool", MAIN_POLICY, "f32", 2, False),
        ("pipelined depth 2, bf16 pool", "exact", "f32", 2, False),
        ("sync bf16 pool, shard_params", "exact", "f32", None, True)],
    3: [("sync bf16 pool", MAIN_POLICY, "f32", None, False),
        ("sync bf16 pool", "exact", "f32", None, False),
        ("sync int8 pool", MAIN_POLICY, "int8", None, False),
        ("sync int8 pool", "exact", "int8", None, False)],
}
#: sites of the collective log that run once a layer
LAYER_SITES = ("attn_out", "pages_max", "pages_sum", "pages_pv", "wo",
               "w_down", "tp_gather", "qkv")


def decode_wire_budget(cfg, regime, shard, b=N_SLOTS) -> int:
    """A decode step's wire bytes a layer: the (B, H, 1) max and Σ and
    (B, H, 1, D) partials, and under ``shard_params`` the ``wo`` and
    ``w_down`` sums of (B, d_model), the norm scales the reference's
    serving spec stores cut (2 of d_model, ``q_norm`` and ``k_norm`` of
    D: site ``tp_gather``) and, in 'pages', the q, k, v activations
    gathered from the ranks' columns (site ``qkv``), at 4 bytes an
    element."""
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    budget = 2 * b * h * (d + 2) * 4
    if shard:
        budget += 2 * b * cfg.d_model * 4 + (2 * cfg.d_model + 2 * d) * 4
        if regime == "pages":
            budget += b * (h + 2 * kvh) * d * 4
    return budget


def serving_spec_bytes(cfg, mesh, params) -> tuple[int, int]:
    """(bytes a rank holds of ``params``, the bytes of the same leaves at
    the shapes the port's ``param_pspec(fsdp=False)`` gives a rank of
    ``mesh``, in the leaves' own types).  The port's rule is held to the
    JAX package's in ``tests/test_torch_tp.py``; here it shows that the
    engine stored its weights at that rule's cut."""
    from repro_torch.runtime import partitioning as PT
    shapes = PT.full_shapes(cfg)
    have = want = 0
    for path, x in tree_flatten(params):
        spec = PT.param_pspec(path, shapes[path], mesh, fsdp=False)
        have += x.nbytes
        want += (int(np.prod(PT.local_shape(shapes[path], spec, mesh)))
                 * x.element_size())
    return have, want


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _paged_launches() -> dict:
    return {"paged_decode": paged_decode_attention.launches,
            "paged_prefill": paged_prefill_attention.launches,
            "paged_decode_int8": paged_decode_attention.int8_launches,
            "paged_prefill_int8": paged_prefill_attention.int8_launches}


def _zero_launches() -> None:
    for wrapper in (paged_decode_attention, paged_prefill_attention):
        wrapper.launches = wrapper.int8_launches = 0


def tp_reference(model, params, requests, policy, kv_dtype):
    """The tp = 1 sync engine of this call on phase 5c's requests: each
    request's tokens, first-token logits and, at every decision, the
    top-2 margin of its logits; the paged launches of the drive."""
    run = RunConfig(dtype="bfloat16", softmax_policy=POLICIES[policy],
                    paged_backend="auto", kv_dtype=kv_dtype)
    eng = ServingEngine(model, params, run, engine_config(), device="cuda")
    firsts, margins = {}, {}
    sample = eng._sample

    def recording(seq, row):
        top2 = np.sort(row)[-2:]
        margins[seq.request.id, len(seq.generated)] = float(top2[1] - top2[0])
        if not seq.generated:
            firsts[seq.request.id] = row.copy()
        return sample(seq, row)

    eng._sample = recording
    for rid, (prompt, n_new) in enumerate(requests):
        eng.add_request(prompt, n_new, seed=rid)
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(tokens={r: res.tokens.tolist() for r, res in results.items()},
                firsts=firsts, margins=margins, launches=_paged_launches(),
                wall=wall, n_tokens=eng.stats.tokens,
                pool_bytes=eng.stats.pool_bytes_per_layer)


def tp_rank(mesh, arch, drives, requests):
    """One rank of phase 5c: the smoke's seeded bf16 weights (initialised
    one rank at a time: an f32 init peaks at twice the bf16 model), then
    each drive — rank 0 serves the requests and closes, the others
    follow its plans.  Returns (rank 0) per drive its tokens, first-token
    logits, and every rank's paged launches, decode wire bytes a layer
    (the most any decode step moved), collective sites and wall
    seconds."""
    model = build_model(arch)
    params = None
    for r in range(mesh.tp):
        if r == mesh.rank:
            gen = torch.Generator(device=mesh.device).manual_seed(0)
            params = cast_params(model.init(gen, mesh.device),
                                 torch.bfloat16)
            _sync(mesh.device)
        torch.distributed.barrier(group=mesh.group)
    out = []
    for label, policy, kv_dtype, depth, shard in drives:
        run = RunConfig(dtype="bfloat16", softmax_policy=POLICIES[policy],
                        paged_backend="auto", kv_dtype=kv_dtype)
        cfg = dataclasses.replace(engine_config(depth or 2), mesh=mesh,
                                  shard_params=shard)
        eng = (PipelinedEngine if depth else ServingEngine)(
            model, params, run, cfg, device=mesh.device)
        firsts = {}
        if mesh.rank == 0 and depth is None:
            sample = eng._sample

            def recording(seq, row, sample=sample):
                if not seq.generated:
                    firsts[seq.request.id] = row.copy()
                return sample(seq, row)
            eng._sample = recording
        per_layer, sites, gathers = [], set(), []
        decode = eng._op_decode

        def watched(*a, decode=decode, **kw):
            mesh.log.records.clear()
            got = decode(*a, **kw)
            sites.update((r.site, r.kind, r.shape)
                         for r in mesh.log.records)
            per_layer.append(mesh.log.nbytes(*LAYER_SITES)
                             / model.cfg.n_layers)
            gathers.append(mesh.log.nbytes("tp_gather"))
            return got
        eng._op_decode = watched
        _sync(mesh.device)
        _zero_launches()
        mesh.log.clear()
        t0 = time.perf_counter()
        results = None
        if mesh.rank == 0:
            for rid, (prompt, n_new) in enumerate(requests):
                eng.add_request(prompt, n_new, seed=rid)
            try:
                results = eng.run()
            finally:
                eng.close()
        else:
            eng.follow()
        _sync(mesh.device)
        mine = dict(launches=_paged_launches(),
                    wall=time.perf_counter() - t0,
                    decode_bytes=max(per_layer), sites=sorted(sites),
                    plans=mesh.log.plans,
                    pool_bytes=eng.stats.pool_bytes_per_layer,
                    tp_gather=max(gathers),
                    spec_bytes=(serving_spec_bytes(model.cfg, mesh,
                                                   eng.params)
                                if shard else None))
        ranks = [None] * mesh.tp
        torch.distributed.all_gather_object(ranks, mine, group=mesh.group)
        if mesh.rank == 0:
            out.append(dict(
                label=label, policy=policy, kv_dtype=kv_dtype, depth=depth,
                shard=shard,
                regime=eng.regime, ranks=ranks, firsts=firsts,
                n_tokens=eng.stats.tokens,
                tokens={r: res.tokens.tolist()
                        for r, res in results.items()}))
        del eng
        if torch.device(mesh.device).type == "cuda":
            torch.cuda.empty_cache()
    return out if mesh.rank == 0 else None


def check_spec_bytes(label, ranks) -> str:
    """Hold every rank's parameter bytes to the serving-spec shard
    shapes' (``serving_spec_bytes``); the printed clause, with the norm
    scales' ``tp_gather`` bytes of a decode step."""
    for rank, mine in enumerate(ranks):
        have, want = mine["spec_bytes"]
        if have != want:
            raise AssertionError(f"{label}: rank {rank} holds {have} B of "
                                 f"parameters, the port's serving spec "
                                 f"{want} B")
    return (f"parameters a rank {[m['spec_bytes'][0] for m in ranks]} B "
            f"(the port's param_pspec(fsdp=False) shapes, held to the JAX "
            f"package's in tests/test_torch_tp.py); tp_gather "
            f"{max(m['tp_gather'] for m in ranks)} B a decode step; ")


def tp_agreement(ref, got):
    """Share of greedy tokens equal to the tp = 1 drive's, and the first
    parting decision (request, position, the tp = 1 top-2 margin
    there), or None."""
    same = total = 0
    first = None
    for rid, want in ref["tokens"].items():
        have = got["tokens"][rid]
        same += sum(a == b for a, b in zip(want, have))
        total += len(want)
        part = next((i for i, (a, b) in enumerate(zip(want, have))
                     if a != b), None)
        if part is not None and (first is None or part < first[1]):
            first = (rid, part, ref["margins"][rid, part])
    return same / total, first


def check_tp_drive(tp, ref, got, card, cfg):
    """Phase 5c's checks of one drive against the tp = 1 sync engine of
    this call; returns the printed line's key numbers."""
    label = f"tp {tp} {got['policy']} {got['label']} ({got['regime']!r})"
    bitwise = got["regime"] == "heads" and not got["shard"]
    if bitwise:
        parted = [r for r, want in ref["tokens"].items()
                  if got["tokens"][r] != want]
        moved = [r for r, row in got["firsts"].items()
                 if not np.array_equal(row, ref["firsts"][r])]
        if parted or moved:
            raise AssertionError(
                f"{label}: replicated weights, yet requests {parted} part "
                f"from tp = 1 and requests {moved} have other first-token "
                f"logits")
    if got["firsts"]:
        worst = max(float(np.abs(row - ref["firsts"][rid]).max()
                          / np.abs(ref["firsts"][rid]).max())
                    for rid, row in got["firsts"].items())
        held = got["policy"] == "exact"
        if held and not worst <= 0.02:
            raise AssertionError(f"{label}: first-token logits differ by "
                                 f"{worst:.3g} > 0.02 of the largest")
        how = ("held equal" if bitwise else "held within 0.02" if held
               else "printed")
        logits = f"first-token logits max|Δ|/max|logit| {worst:.4g} ({how}); "
    else:
        worst = None
        logits = "(first tokens sampled on the card); "
    share, first = tp_agreement(ref, got)
    parting = ("no parting" if first is None else
               f"first parting: request {first[0]} decision {first[1]}, "
               f"tp = 1 top-2 margin {first[2]:.4g}")
    kv = "_int8" if got["kv_dtype"] == "int8" else ""
    want = {f"paged_decode{kv}": ref["launches"][f"paged_decode{kv}"],
            f"paged_prefill{kv}": ref["launches"][f"paged_prefill{kv}"]}
    for rank, mine in enumerate(got["ranks"]):
        have = {k: mine["launches"][k] for k in want}
        expect = want if got["regime"] == "heads" else dict.fromkeys(want, 0)
        if have != expect or sum(mine["launches"].values()) != sum(
                expect.values()):
            raise AssertionError(f"{label}: rank {rank} launched "
                                 f"{mine['launches']}, want {expect}")
    budget = decode_wire_budget(cfg, got["regime"], got["shard"])
    wire = max(m["decode_bytes"] for m in got["ranks"])
    if not wire <= budget:
        raise AssertionError(f"{label}: a decode step moved {wire:.0f} B a "
                             f"layer > {budget} B")
    spec = check_spec_bytes(label, got["ranks"]) if got["shard"] else ""
    wall = max(m["wall"] for m in got["ranks"])
    print(f"[tp] {label}: {logits}greedy tokens equal to tp = 1 "
          f"{share:.1%}{' (held)' * bitwise} ({parting}); paged launches a "
          f"rank "
          f"{[{k: m['launches'][k] for k in want} for m in got['ranks']]} "
          f"(tp = 1: {want}); decode wire {wire:.0f} B a layer (budget "
          f"{budget}); {got['ranks'][0]['plans']} plans; KV pool "
          f"{got['ranks'][0]['pool_bytes']} B a layer a rank (tp = 1: "
          f"{ref['pool_bytes']}); {spec}{got['n_tokens'] / wall:.1f} tok/s — a "
          f"shared-device gloo figure, not a tensor-parallel speed — "
          f"{card}")
    for site in sorted({s for m in got["ranks"] for s in m["sites"]}):
        print(f"[tp]   decode collective on the wire: {site}")
    return dict(tp=tp, label=got["label"], regime=got["regime"],
                logits=worst, agree=share, parting=first, wire=wire,
                budget=budget)


def phase_tp(model, params, requests, card):
    """Phase 5c: tensor-parallel paged serving through ``mesh.start_ranks``
    — tp 2 ('heads': each rank launches the paged CUDA kernels on its 4
    KV heads) and tp 3 ('pages': each rank holds a slab of the pages and
    reduces plain-torch partials) — as separate processes sharing this
    card over gloo, against the tp = 1 sync engine of this call on the
    same requests (16 new tokens), all at ``TP_LAYERS`` layers.  The
    card is one device, so the figures are a check of the path, not of
    tensor-parallel speed.  Frees ``params`` (the engine phases'
    weights; the ranks build their own)."""
    from repro_torch.launch.mesh import start_ranks
    reqs = [(p, TP_NEW_TOKENS) for p, _ in requests]
    params.clear()
    gc.collect()
    torch.cuda.empty_cache()
    model = build_model(model.cfg.with_layers(TP_LAYERS))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = cast_params(model.init(gen, "cuda"), torch.bfloat16)
    refs = {key: tp_reference(model, params, reqs, *key)
            for key in sorted({(d[1], d[2]) for drives in TP_DRIVES.values()
                               for d in drives})}
    for (policy, kv), ref in refs.items():
        print(f"[tp] tp = 1 sync reference, {policy} kv_dtype={kv}: "
              f"{ref['n_tokens'] / ref['wall']:.1f} tok/s, paged launches "
              f"{ref['launches']} — {card}")
    print("[tp] set_sync_debug_mode('error') guards the tp = 1 pipelined "
          "drives only: gloo stages each collective of a CUDA tensor "
          "through the host, a synchronising copy by design")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    rows = []
    for tp, drives in TP_DRIVES.items():
        t0 = time.perf_counter()
        got = start_ranks(tp_rank, tp, backend="gloo", device="cuda",
                          args=(model.cfg, drives, reqs), threads=0).join()
        print(f"[tp] tp {tp}: {tp} ranks on one card over gloo, "
              f"{len(drives)} drives in {time.perf_counter() - t0:.1f}s "
              f"(start-up and weights included)")
        for g in got:
            rows.append(check_tp_drive(
                tp, refs[g["policy"], g["kv_dtype"]], g, card, model.cfg))
    return rows


# ---------------------------------------------------------------------------
# Phase 5d: the MoE decoders through the paged engines
# ---------------------------------------------------------------------------

#: depth of the MoE drives, at full width: the port's Python launches
#: take ~3.5 ms a layer and step, so a full-depth DeepSeek drive (28
#: layers) took 22 s, and at 8 layers the phase still took 145 s (this
#: script on an H100 80GB HBM3, 700 W); 6 layers kept it near 110 s, 4
#: made room for phase 12 (86–107 s), and 2 make room for phase 11a's
#: 'pages' drive (40–52 s) within the run's time limit
MOE_LAYERS = 2


def setup_moe(name):
    """An MoE decoder at full width, depth cut to ``MOE_LAYERS``, with
    seeded random bf16 weights, drawn and cast block by block
    (DeepSeek-MoE-16B's f32 weights would not fit the card beside their
    bf16 copy at full depth)."""
    full = ARCHS[name]
    arch = full.with_layers(MOE_LAYERS)
    model = build_model(arch)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen, "cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    m = arch.moe
    print(f"[moe] {name}: {arch.n_layers} of {full.n_layers} layers of "
          f"d_model {arch.d_model}, "
          f"heads {arch.n_heads}/{arch.n_kv_heads} of "
          f"{arch.resolved_head_dim}, {m.n_experts} routed experts of "
          f"{m.d_expert} (+{m.n_shared} shared), top-{m.top_k}, vocab "
          f"{arch.vocab_size}{', tied embeddings' * arch.tie_embeddings}: "
          f"{arch.param_count() / 1e9:.2f}B params "
          f"({arch.param_count(active_only=True) / 1e9:.2f}B active; "
          f"{full.param_count() / 1e9:.2f}B at full depth) bf16, "
          f"router f32, init {time.perf_counter() - t0:.1f}s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    return model, params


def moe_launches(name, run, kv_dtype="f32"):
    """A drive's paged launches on its pool type, which must have moved;
    the other pool type's kernels must not have launched."""
    launches = run[2]
    kv = "_int8" if kv_dtype == "int8" else ""
    other = "" if kv else "_int8"
    mine = {k: launches[f"paged_{k}{kv}"] for k in ("decode", "prefill")}
    if not all(mine.values()) or any(launches[f"paged_{k}{other}"]
                                     for k in ("decode", "prefill")):
        raise AssertionError(f"{name} {kv_dtype} pool: paged launches "
                             f"{launches}")
    return mine


@contextlib.contextmanager
def pinned_routes(record=None, replay=None, flips=None):
    """Every MoE routing call of a sync drive, in call order: ``record``
    (a list) gets its expert indices; with ``replay`` (such a list) the
    call takes the recorded experts instead of its own top-k — their
    gates from this call's own router probabilities, their slots
    recomputed — and ``flips`` gets, per call, whether each token's own
    top-k differed (a data rank of a training mesh replays its rows of
    the recorded global routing, slotted over the global token groups).
    Top-k routing is discontinuous: under random
    weights the router's 64 probabilities lie close, and bf16 roundoff
    of the attention output (kernel against plain version) moves tokens
    across ties, each flip swapping an expert; a replayed drive isolates
    the continuous rest."""
    route = MOE.route
    calls = iter(replay or ())

    def pinned(p, xt, **kw):
        out = route(p, xt, **kw)
        if record is not None:
            record.append(out[1])
        if replay is None:
            return out
        experts, cap, g = next(calls).to(xt.device), out[4], out[5]
        data = MOE._data_mesh()
        if data is not None:      # a rank's rows of a global routing
            t, i = xt.shape[0], data[0].index(data[1])
            experts = experts[i * t:(i + 1) * t]
        flips.append((experts != out[1]).any(-1))
        logits = xt.float() @ p["router"].float()
        probs = LUT.make_softmax_fn(kw["router_policy"])(logits, axis=-1)
        gates = torch.gather(probs, -1, experts)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        slots, kept = MOE.assign_slots(experts, kw["n_experts"], g, cap,
                                       data)
        return gates, experts, slots, kept, cap, g

    MOE.route = pinned
    try:
        yield
    finally:
        MOE.route = route


def phase_moe(card):
    """Phase 5d: DeepSeek-MoE-16B and Granite-MoE-3B at full width and
    depth, seeded random bf16 weights, through the paged engines on the
    smoke's 8 requests (32 new tokens).

    DeepSeek: REXP uint8 sync on the bf16 and the int8 pool (their paged
    launches must move, and only their pool type's), a pipelined depth-2
    drive on each pool with every ``_dispatch`` under
    ``set_sync_debug_mode("error")`` (tokens and launches equal to the
    sync drive's), one profiled drive (the device's busy share), the same
    requests with every paged call held to its plain version on the
    drive's own inputs (one LUT step) and with ``paged_backend="dense"``
    (printed: REXP's free-running streams part).  Both models: an exact
    sync drive, and the same requests exact with
    ``paged_backend="dense"`` replaying the exact drive's expert choices
    (:func:`pinned_routes`): first-token logits within 2% of the
    kernel drive's, with the routing decisions the dense path would have
    taken otherwise counted.  Returns each model's launches of its REXP
    bf16 sync drive, by kernel."""
    t0 = time.perf_counter()
    main, exact = POLICIES[MAIN_POLICY], POLICIES["exact"]
    out = {}
    for name in MOE_SHAPES:
        model, params = setup_moe(name)
        requests = make_requests(model.cfg.vocab_size)
        tag = f"[moe] {name}"

        def drive(policy, backend="auto", **kw):
            return run_engine(model, params, policy, backend, requests,
                              tag=tag, **kw)

        sync = drive(main)
        out[name] = moe_launches(name, sync)
        routes, flips = [], []
        with pinned_routes(record=routes):
            ex = drive(exact)
        moe_launches(name, ex)
        with pinned_routes(replay=routes, flips=flips):
            dense_ex = drive(exact, "dense")
        flipped = torch.cat(flips)
        print(f"[moe] {name} exact, dense path replaying the kernel drive's "
              f"experts: {len(routes)} routing calls; the dense path's own "
              f"top-k would differ for {int(flipped.sum())} of "
              f"{flipped.numel()} token routings")
        worst = compare_runs(f"{name} exact kernel vs dense, experts "
                             f"pinned", ex, dense_ex, tag="[moe]")
        if not worst <= 0.02:
            raise AssertionError(f"{name}: exact-policy first-token logits "
                                 f"differ by {worst:.3g} > 0.02")
        if name == "deepseek-moe-16b":
            same_as_sync(f"{name} depth 2, bf16 pool, every dispatch under "
                         f"set_sync_debug_mode('error')",
                         drive(main, depth=2, guard_sync=True), sync)
            sync8 = drive(main, kv_dtype="int8")
            moe_launches(name, sync8, "int8")
            same_as_sync(f"{name} depth 2, int8 pool, every dispatch under "
                         f"set_sync_debug_mode('error')",
                         drive(main, kv_dtype="int8", depth=2,
                               guard_sync=True), sync8)
            profile_drive(model, params, requests, label=name)
            shadow = []
            drive(main, shadow=shadow)
            check_shadow(shadow, f"{name} bf16 pool", tag="[moe]")
            dense = drive(main, "dense")
            if any(dense[2].values()):
                raise AssertionError(f"dense run launched kernels: "
                                     f"{dense[2]}")
            compare_runs(f"{name} {MAIN_POLICY} kernel vs dense "
                         f"(free-running)", sync, dense, tag="[moe]")
        print(f"[moe] {name}: paged launches a REXP bf16 sync drive "
              f"{out[name]} — {card}")
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[moe] phase 5d: {time.perf_counter() - t0:.1f}s — {card}")
    return out


# ---------------------------------------------------------------------------
# Phase 5e: the hybrid and recurrent decoders through lockstep
# ---------------------------------------------------------------------------

#: Jamba's lockstep drive: 4 requests of a 64-token prompt and 32 new
#: tokens each, so its attention cache holds 96 positions
J_BATCH, J_PROMPT, J_NEW = 4, 64, 32
#: the recurrent code on the card against the CPU in f32: every output,
#: logit and state leaf within this share of its largest entry
SSM_TOL = 1e-4
#: Mamba decode steps after the 64-token prefill of the block check
MAMBA_STEPS = 8


def setup_jamba():
    """Jamba-v0.1-52B at full width, depth cut to one period (8 layers:
    attention at index 3, Mamba elsewhere, the MoE FFN on odd layers),
    seeded random bf16 weights drawn and cast block by block (the 32
    layers' ~103 GB do not fit the card), and the drive's seeded
    prompts."""
    full = ARCHS["jamba-v0.1-52b"]
    arch = full.with_layers(1)
    model = build_model(arch)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = model.init(gen, "cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    rng = np.random.default_rng(5)
    prompt = torch.as_tensor(rng.integers(0, arch.vocab_size,
                                          size=(J_BATCH, J_PROMPT)),
                             dtype=torch.int32, device="cuda")
    m = arch.moe
    print(f"[ssm] {arch.name}: {arch.n_layers} of {full.n_layers} layers "
          f"(attention at 3, Mamba elsewhere; MoE FFN on odd layers) of "
          f"d_model {arch.d_model}, heads {arch.n_heads}/{arch.n_kv_heads} "
          f"of {arch.resolved_head_dim} (no RoPE), Mamba d_inner "
          f"{SSM.EXPAND * arch.d_model} d_state {SSM.D_STATE}, "
          f"{m.n_experts} experts of {m.d_expert} top-{m.top_k}, d_ff "
          f"{arch.d_ff}, vocab {arch.vocab_size}: "
          f"{arch.param_count() / 1e9:.2f}B params "
          f"({full.param_count() / 1e9:.2f}B at full depth) bf16, init "
          f"{time.perf_counter() - t0:.1f}s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card; "
          f"{J_BATCH} prompts of {J_PROMPT} tokens, {J_NEW} new tokens")
    return model, params, prompt


def held_to_cpu(label, got, ref, worst):
    """``got`` (on the card) within ``SSM_TOL`` of the largest entry of
    ``ref`` (on the CPU); returns the larger of ``worst`` and this
    ratio."""
    ref = ref.float()
    err = float((got.float().cpu() - ref).abs().max()
                / max(float(ref.abs().max()), 1e-30))
    if not err <= SSM_TOL:
        raise AssertionError(f"{label}: card against CPU {err:.3g} of the "
                             f"largest entry > {SSM_TOL}")
    return max(worst, err)


def state_leaves(caches):
    """(name, tensor) of every leaf of a lockstep model's caches."""
    for pi, period in enumerate(caches):
        for si, cache in enumerate(period):
            for f in dataclasses.fields(cache):
                leaf = getattr(cache, f.name)
                if isinstance(leaf, torch.Tensor):
                    yield f"period {pi} layer {si} {f.name}", leaf


def mamba_block_check(card):
    """One Mamba block at Jamba's width (d_model 4096, d_inner 8192,
    d_state 16, dt_rank 256), f32: a 64-token prefill into a fresh cache
    and ``MAMBA_STEPS`` decode steps on the card against the same weights
    and inputs on the CPU."""
    d = ARCHS["jamba-v0.1-52b"].d_model
    t0 = time.perf_counter()
    p_cpu = SSM.init_mamba(d, torch.Generator().manual_seed(9), "cpu")
    p_gpu = tree_map(lambda t, _: t.to("cuda"), p_cpu)
    x = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (J_BATCH, J_PROMPT + MAMBA_STEPS, d), dtype=np.float32))
    caches = [SSM.MambaCache.zeros(J_BATCH, d, torch.float32, dev)
              for dev in ("cuda", "cpu")]
    worst = 0.0
    steps = [x[:, :J_PROMPT]] + [x[:, J_PROMPT + i:J_PROMPT + i + 1]
                                 for i in range(MAMBA_STEPS)]
    for i, xs in enumerate(steps):
        label = "prefill" if i == 0 else f"decode {i}"
        got = SSM.apply_mamba(p_gpu, xs.to("cuda"), cache=caches[0])
        ref = SSM.apply_mamba(p_cpu, xs, cache=caches[1])
        worst = held_to_cpu(f"mamba {label} out", got, ref, worst)
        for leaf in ("h", "conv"):
            worst = held_to_cpu(f"mamba {label} {leaf}",
                                getattr(caches[0], leaf),
                                getattr(caches[1], leaf), worst)
    print(f"[ssm] one Mamba block at Jamba's width (d_inner {2 * d}, "
          f"dt_rank {p_cpu['dt_proj'].shape[0]}), f32, B={J_BATCH}: a "
          f"{J_PROMPT}-token prefill and {MAMBA_STEPS} decode steps on the "
          f"card against the CPU: outputs and state (h, conv) within "
          f"{worst:.3g} of their largest entry (limit {SSM_TOL}); "
          f"{time.perf_counter() - t0:.1f}s — {card}")


def xlstm_check(card):
    """The whole xLSTM-125M (12 layers: 9 mLSTM, 3 sLSTM), seeded f32
    weights: the card's greedy drive of 4 prompts of 64 tokens,
    teacher-forced on the CPU with the card's tokens — every step's
    logits and every state leaf within ``SSM_TOL`` of its largest entry;
    then the same weights in bf16 through ``generate``: tok/s, the
    prefill's and a decode step's time."""
    arch = ARCHS["xlstm-125m"]
    model = build_model(arch)
    t0 = time.perf_counter()
    p_cpu = model.init(torch.Generator().manual_seed(10), "cpu")
    p_gpu = tree_map(lambda t, _: t.to("cuda"), p_cpu)
    prompt = torch.as_tensor(np.random.default_rng(10).integers(
        0, arch.vocab_size, size=(J_BATCH, J_PROMPT)), dtype=torch.int32)
    run = lockstep_run(POLICIES["exact"], dtype="float32")
    max_len = J_PROMPT + J_NEW
    lg, sg = model.prefill(p_gpu, prompt.to("cuda"), run, max_len,
                           logits="last")
    lc, sc = model.prefill(p_cpu, prompt, run, max_len, logits="last")
    worst = 0.0
    for i in range(J_NEW):
        worst = held_to_cpu(f"xlstm step {i} logits", lg, lc, worst)
        for (name, g), (_, c) in zip(state_leaves(sg), state_leaves(sc)):
            worst = held_to_cpu(f"xlstm step {i} {name}", g, c, worst)
        if i == J_NEW - 1:
            break
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
        lg, sg = model.decode_step(p_gpu, tok, sg, run)
        lc, sc = model.decode_step(p_cpu, tok.cpu(), sc, run)
    mixers = [s.mixer for s in arch.period] * arch.n_periods
    print(f"[ssm] {arch.name} ({mixers.count('mlstm')} mLSTM + "
          f"{mixers.count('slstm')} sLSTM layers, d_model {arch.d_model}, "
          f"{arch.n_heads} heads, vocab {arch.vocab_size}: "
          f"{arch.param_count() / 1e6:.0f}M params), f32, B={J_BATCH}: the "
          f"card's greedy drive teacher-forced on the CPU for {J_NEW} "
          f"steps: logits and {sum(1 for _ in state_leaves(sg))} state "
          f"leaves within {worst:.3g} of their largest entry (limit "
          f"{SSM_TOL}); {time.perf_counter() - t0:.1f}s")
    params = cast_params(p_gpu, torch.bfloat16)
    run = lockstep_run(POLICIES["exact"])
    prompt = prompt.to("cuda")
    lockstep_drive(model, params, prompt, run, J_NEW)           # warm-up
    out, _, wall, _ = lockstep_drive(model, params, prompt, run, J_NEW)
    if out.shape != (J_BATCH, J_NEW) or not (
            (out >= 0) & (out < arch.vocab_size)).all():
        raise AssertionError(f"xlstm tokens out of range: {out}")
    t_pre, t_dec = lockstep_step_times(model, params, prompt, run, J_NEW)
    print(f"[ssm] {arch.name} bf16 lockstep drive: {out.numel()} tokens in "
          f"{wall:.3f}s ({out.numel() / wall:.1f} tok/s); prefill "
          f"{t_pre * 1e3:.2f} ms ({J_BATCH} × {J_PROMPT} tokens), mean "
          f"decode step {t_dec * 1e3:.2f} ms — {card}")


def jamba_dense_rows(cfg, qmax, card):
    """The dense kernel at Jamba's two lockstep shapes, bf16, REXP
    faithful (a cache's kv_len): the prompt call (64 rows over the first
    64 keys of the 96-position cache, causal) and a decode call at
    kv_len 95, on the route the dispatcher picks — within one LUT step of
    the plain version on normal rows, timed beside it, exact SDPA on the
    same inputs and the bound over the visible pairs and valid keys."""
    rng = np.random.default_rng(11)
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    lk = J_PROMPT + J_NEW
    rows = {}
    for name, lq, kv_len in (("prompt", J_PROMPT, J_PROMPT),
                             ("decode", 1, lk - 1)):
        q, k, v = dense_problem(rng, J_BATCH, h, kvh, lq, lk, dh,
                                torch.bfloat16, False)
        route = dense_route(q.dtype, dh, lq, qmax, "rexp")
        ref = dense_call(lut_attention_plain, "rexp", q, k, v, True, kv_len)
        out = dense_call(lut_attention_cuda, "rexp", q, k, v, True, kv_len,
                         route=route)
        err = float((out - ref).abs().max())
        limit = 2.0 / qmax * float(v.float().abs().max())
        if not err <= limit:
            raise AssertionError(f"jamba {name} call off its plain version "
                                 f"by {err} > one LUT step {limit}")
        b_ms, b_by = dense_bound(J_BATCH, h, kvh, lq, kv_len, dh,
                                 torch.bfloat16,
                                 dense_pairs(lq, lk, True, kv_len))
        row = dict(route=route, ms=device_ms(lambda: dense_call(
            lut_attention_cuda, "rexp", q, k, v, True, kv_len, route=route)),
            plain_ms=device_ms(lambda: dense_call(
                lut_attention_plain, "rexp", q, k, v, True, kv_len)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            sdpa_ms=dense_sdpa_ms(q, k, v, True, kv_len), max_abs_err=err)
        rows[name] = row
        print(f"[time] lut_attention rexp bf16 jamba {name} B={J_BATCH} "
              f"H={h}/{kvh} Lq={lq} Lk={lk} kv_len={kv_len} Dh={dh} "
              f"{route}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, exact SDPA {row['sdpa_ms']:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by}), "
              f"{b_ms / row['ms']:.1%} of bound; max|err| {err:.3g} (limit "
              f"{limit:.3g}) — {card}")
    return rows


def phase_ssm(card):
    """Phase 5e: Jamba-v0.1-52B (one period at full width, seeded bf16
    weights) through ``serve_loop.generate`` with
    ``attention_backend="auto"``: 4 prompts of 64 tokens, 32 new tokens,
    under REXP uint8 and 2D-LUT uint8 — exactly 32 dense launches a drive
    (the prompt's call on the tile route, 31 decode calls on the split
    route), every call of a shadowed drive within one LUT step of its
    plain version, REXP first-token logits within 2 % of a ``naive``
    drive that replays the kernel drive's expert choices, tok/s, the
    prefill's and a decode step's time, one profiled drive; the dense
    kernel timed at Jamba's two shapes; one Mamba block at Jamba's width
    and the whole xLSTM-125M on the card against the CPU in f32.
    Returns the dense kernel's Jamba row: both shapes' times and the
    REXP drive's launches."""
    t0 = time.perf_counter()
    model, params, prompt = setup_jamba()
    cfg = model.cfg
    main, lut2d = POLICIES[MAIN_POLICY], POLICIES["lut2d-uint8"]
    qmax = get_precision(main.precision).qmax
    dh = cfg.resolved_head_dim
    n_attn = cfg.n_periods * sum(s.mixer == "attn" for s in cfg.period)
    expect_routes = dict.fromkeys(ROUTES, 0)
    for n, rows in ((n_attn, J_PROMPT), (n_attn * (J_NEW - 1), 1)):
        expect_routes[dense_route(torch.bfloat16, dh, rows, qmax,
                                  "rexp")] += n

    def drive(policy, backend="auto", around=None):
        return lockstep_drive(model, params, prompt,
                              lockstep_run(policy, backend), J_NEW,
                              around=around)

    def counted(label, got, mode):
        expect = dict.fromkeys(MODES, 0)
        expect[mode] = n_attn * J_NEW
        out, launches, wall, by_route = got
        print(f"[ssm] jamba {label}: {out.numel()} tokens in {wall:.3f}s "
              f"({out.numel() / wall:.1f} tok/s); dense launches {launches} "
              f"by route {by_route} (expected {expect} by route "
              f"{expect_routes})")
        if launches != expect or by_route != expect_routes:
            raise AssertionError(f"jamba {label} launched {launches} by "
                                 f"route {by_route}")
        if out.shape != (J_BATCH, J_NEW) or not (
                (out >= 0) & (out < cfg.vocab_size)).all():
            raise AssertionError(f"jamba tokens out of range: {out}")
        return got

    drive(main)                                                  # warm-up
    got = counted(f"{MAIN_POLICY} auto", drive(main), "rexp")
    t_pre, t_dec = lockstep_step_times(model, params, prompt,
                                       lockstep_run(main), J_NEW)
    print(f"[ssm] jamba {MAIN_POLICY}: prefill {t_pre * 1e3:.2f} ms "
          f"({J_BATCH} × {J_PROMPT} tokens), mean decode step "
          f"{t_dec * 1e3:.2f} ms ({J_BATCH} tokens) — {card}")
    counted("lut2d-uint8 auto", drive(lut2d), "lut2d")
    for pol_name, pol in ((MAIN_POLICY, main), ("lut2d-uint8", lut2d)):
        shadow = []
        LAYERS.lut_attention = dense_shadow(shadow, qmax)
        try:
            counted(f"{pol_name} auto (shadowed)", drive(pol),
                    "rexp" if pol is main else "lut2d")
        finally:
            LAYERS.lut_attention = ops.lut_attention
        if len(shadow) != n_attn * J_NEW:
            raise AssertionError(f"shadowed drive: {len(shadow)} calls")
        check_shadow(shadow, f"jamba {pol_name} drive", tag="[ssm]")
    naive = drive(main, "naive")
    if any(naive[1].values()):
        raise AssertionError(f"naive drive launched {naive[1]}")
    print(f"[ssm] jamba {MAIN_POLICY} naive drive: {naive[2]:.3f}s; tokens "
          f"agreeing with the kernel drive (free-running) "
          f"{float((naive[0] == got[0]).float().mean()):.1%}")
    routes, flips = [], []
    with pinned_routes(record=routes):
        a = first_token_logits(model, params, None, prompt,
                               lockstep_run(main), J_NEW)
    with pinned_routes(replay=routes, flips=flips):
        b = first_token_logits(model, params, None, prompt,
                               lockstep_run(main, "naive"), J_NEW)
    flipped = torch.cat(flips)
    worst = float(np.abs(a - b).max() / np.abs(b).max())
    print(f"[ssm] jamba {MAIN_POLICY} auto vs naive, the naive prefill "
          f"replaying the kernel prefill's experts ({len(routes)} routing "
          f"calls; its own top-k would differ for {int(flipped.sum())} of "
          f"{flipped.numel()} token routings): first-token logits "
          f"max|Δ|/max|logit| {worst:.4g}; first tokens agreeing "
          f"{float(np.mean(a.argmax(-1) == b.argmax(-1))):.1%}")
    if not worst <= 0.02:
        raise AssertionError(f"jamba first-token logits differ by "
                             f"{worst:.3g} > 0.02")
    lockstep_profile(f"jamba {MAIN_POLICY}",
                     lambda around: drive(main, around=around))
    rows = jamba_dense_rows(cfg, qmax, card)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    mamba_block_check(card)
    xlstm_check(card)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[ssm] phase 5e: {time.perf_counter() - t0:.1f}s — {card}")
    return {cfg.name: dict(rows, launches=sum(got[1].values()),
                           route_launches=got[3])}


# ---------------------------------------------------------------------------
# Phases 6 and 7: the dense LUT-attention kernel and Whisper-small
# ---------------------------------------------------------------------------

#: the dense kernel's modes: mode → (policy, fused_requant)
DENSE_MODES = {
    "rexp_fused": (POLICIES["rexp-uint8"], True),
    "rexp": (POLICIES["rexp-uint8"], False),
    "lut2d": (POLICIES["lut2d-uint8"], False),
}
#: Whisper-small's attention: 12 heads of 64, 1500 encoder frames
W_H, W_DH, W_LENC = 12, 64, 1500
#: (name, B, H, KVH, Lq, Lk, Dh, causal, kv_len) — the main path's shapes
DENSE_CASES = [
    ("encoder", 2, W_H, W_H, W_LENC, W_LENC, W_DH, False, None),
    ("cross decode", 4, W_H, W_H, 1, W_LENC, W_DH, False, None),
    ("cross prefill", 4, W_H, W_H, 8, W_LENC, W_DH, False, None),
    ("self decode", 4, W_H, W_H, 1, 64, W_DH, True, 40),
    ("self prefill", 4, W_H, W_H, 8, 64, W_DH, True, 40),
    ("gqa", 2, 8, 2, 256, 256, 128, True, None),
    # Qwen3-32B's lockstep (``launch/serve.py --engine lockstep``): GQA 8,
    # Dh 128, a prompt-length chunk and a decode step into a cache
    # allocated for the prompt and 32 new tokens
    ("qwen3 lockstep prefill", 2, 64, 8, 300, 332, 128, True, 300),
    ("qwen3 lockstep decode", 4, 64, 8, 1, 332, 128, True, 301),
]
W_BATCH, W_NEW = 4, 32


def dense_problem(rng, b, h, kvh, lq, lk, dh, dtype, exact_logits):
    """Contiguous q (B, H, Lq, Dh), k / v (B, KVH, Lk, Dh): exact-logit
    q, k (small integers × 2^-2; Dh 64's scale 1/8 is a power of two) or
    normal rows."""
    if exact_logits:
        q = rng.integers(-4, 5, size=(b, h, lq, dh)) * 0.25
        k = rng.integers(-4, 5, size=(b, kvh, lk, dh)) * 0.25
    else:
        q = rng.normal(size=(b, h, lq, dh))
        k = rng.normal(size=(b, kvh, lk, dh))
    v = rng.normal(size=(b, kvh, lk, dh))
    return [torch.as_tensor(x, device="cuda").to(dtype) for x in (q, k, v)]


def dense_call(fn, mode, q, k, v, causal, kv_len, **kw):
    pol, fused = DENSE_MODES[mode]
    return fn(q, k, v, ops._tables_for(pol), method=pol.impl, causal=causal,
              index_mode=pol.index_mode, fused_requant=fused, kv_len=kv_len,
              **kw)


def routes_of(mode, q):
    """The route the dispatcher picks for this call and, when it picks
    the tile engine or the split route, the row engine forced on the same
    inputs."""
    pol, _ = DENSE_MODES[mode]
    picked = dense_route(q.dtype, q.shape[-1], q.shape[2],
                         get_precision(pol.precision).qmax, mode)
    return [picked] + (["rows"] if picked != "rows" else [])


def dense_pairs(lq, lk, causal, kv_len):
    """Visible (row, key) pairs of one (sequence, head): keys below
    kv_len (default Lk), causal rows right-aligned to it."""
    kv = lk if kv_len is None else kv_len
    if not causal:
        return lq * kv
    return sum(max(min(kv, kv - lq + c + 1), 0) for c in range(lq))


def dense_sdpa_ms(q, k, v, causal, kv_len):
    """Exact attention by one library call on the same inputs (the GQA
    head repeat and the mask built outside the timed call): the
    yardstick of a dense call, not the same function."""
    g = q.shape[1] // k.shape[1]
    k, v = (x.repeat_interleave(g, dim=1) for x in (k, v))
    lq, lk = q.shape[2], k.shape[2]
    kv = lk if kv_len is None else kv_len
    ki = torch.arange(lk, device="cuda")[None, :]
    mask = ki < kv
    if causal:
        mask = mask & (ki <= torch.arange(lq, device="cuda")[:, None]
                       + (kv - lq))
    return device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask))


def dense_f64(mode, q, k, v, causal, kv_len):
    """The plain version's own f32 logits and integer LUT pipeline, with
    the final σ·V (REXP fused: Σ e·v, then the f32 α factor) carried in
    f64: the referee that tells the kernel's f32 σ·V roundoff from the
    plain version's."""
    pol, fused = DENSE_MODES[mode]
    tables = ops._tables_for(pol)
    s = REF._logits(q, k, q.shape[-1] ** -0.5, causal, kv_len)
    vx = v.double().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    if fused:
        inv = LUT.inv_scale(tables.precision.qmax)
        e = LUT.rexp_exp_int(s, tables, axis=-1, index_mode=pol.index_mode)
        ja = LUT.rexp_alpha_index(e.float().sum(-1, keepdim=True), tables,
                                  pol.index_mode)
        alpha = torch.as_tensor(tables.lut_alpha, dtype=torch.int32,
                                device=q.device)[ja]
        return (torch.matmul(e.double(), vx)
                * (alpha.float() * inv * inv).double())
    soft = LUT.softmax_rexp if pol.impl == "rexp" else LUT.softmax_lut2d
    return torch.matmul(soft(s, tables, axis=-1,
                             index_mode=pol.index_mode).double(), vx)


def dense_bound(b, h, kvh, lq, lk, dh, dtype, pairs):
    """Least time for the dense call: the busiest of three units.  Memory:
    q, k, v read once and the f32 output written once over 3.35 TB/s.
    Tensor cores or CUDA cores for the two products over the visible
    (row, key) pairs of every (sequence, head): with bf16 inputs each
    product of q·kᵀ is exact in f32, so q·kᵀ may run on the tensor cores
    like σ·V (whose weights are integers ≤ qmax, exact in bf16) at
    989 TFLOP/s; with f32 inputs q·kᵀ feeds the bins and needs IEEE f32,
    and both run on the CUDA cores at 67 TFLOP/s.  The CUDA cores also
    do the per-element LUT work (bins, lookups, Σ, σ:
    ROW_OPS_PER_ELEMENT operations a visible pair).  Work on one unit
    adds up; the units may overlap, so the busiest sets the time."""
    esize = torch.empty((), dtype=dtype).element_size()
    nbytes = (b * h * lq * dh * esize + 2 * b * kvh * lk * dh * esize
              + b * h * lq * dh * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    flops = 2 * b * h * dh * pairs                   # one of q·kᵀ and σ·V
    lut_ops = ROW_OPS_PER_ELEMENT * b * h * pairs
    per_unit = {PEAK_OPS[torch.float32]: lut_ops}
    per_unit[PEAK_OPS[dtype]] = per_unit.get(PEAK_OPS[dtype], 0) + 2 * flops
    t_ops = max(n / peak for peak, n in per_unit.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dense_bound_f32_logits(b, h, kvh, lq, lk, dh, dtype, pairs):
    """The dense bound as first stated, kept beside the restated one:
    q·kᵀ in IEEE f32 on the CUDA cores whatever the input type, σ·V at
    the input type's peak, no LUT work counted.  A tensor-core kernel may
    beat it."""
    esize = torch.empty((), dtype=dtype).element_size()
    nbytes = (b * h * lq * dh * esize + 2 * b * kvh * lk * dh * esize
              + b * h * lq * dh * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    flops = 2 * b * h * dh * pairs
    per_unit = {PEAK_OPS[torch.float32]: flops}
    per_unit[PEAK_OPS[dtype]] = per_unit.get(PEAK_OPS[dtype], 0) + flops
    return max(t_bytes, max(n / peak for peak, n in per_unit.items()) * 1e3)


def dense_host_us(q, k, v, kv_len):
    """Host µs a dense decode call (:func:`host_us`) three ways: the
    wrapper, whose launch on real tensors is a direct library call (the
    main path's); the bare launch (``_launch``); and the same launch
    through the custom operator ``repro_torch::lut_attention_dense``
    (the dispatcher's path, which fake tensors take).  The wrapper
    through the operator costs about wrapper − launch + operator."""
    pol, _ = DENSE_MODES["rexp"]
    main, aux, ints, floats = kernel_tables(pol.impl, ops._tables_for(pol),
                                            pol.index_mode, q.device)
    tail = (kv_len, True, False, ROUTES.index("split"), q.shape[-1] ** -0.5)
    cases = {
        "wrapper": lambda: dense_call(lut_attention_cuda, "rexp", q, k, v,
                                      True, kv_len),
        "launch": lambda: DENSE._launch(q, k, v, main, aux, ints, floats,
                                        *tail),
        "operator": lambda: DENSE._dense_op(q, k, v, main, aux, list(ints),
                                            list(floats), *tail)}
    out = {}
    for name, fn in cases.items():
        med, lo, hi = out[name] = host_us(fn)
        print(f"[host] lut_attention rexp {name} B={q.shape[0]} "
              f"H={q.shape[1]}/{k.shape[1]} Lk={k.shape[2]} kv_len={kv_len}:"
              f" {med:.2f} us of host time a call (median of 30 rounds of "
              f"100 calls, rounds {lo:.2f}–{hi:.2f})")
    print(f"[host] lut_attention: the custom operator adds "
          f"{out['operator'][0] - out['launch'][0]:.2f} us to a launch "
          f"(the wrapper through it: about "
          f"{out['wrapper'][0] - out['launch'][0] + out['operator'][0]:.2f}"
          f" us against its {out['wrapper'][0]:.2f})")
    return {name: med for name, (med, _, _) in out.items()}


def phase_dense_kernel():
    """Phase 6: the dense kernel against its plain version at the main
    path's shapes, every mode, f32 and bf16, exact-logit (2e-6) and
    random (one LUT step) inputs, through the route the dispatcher picks
    and, where it picks the tile engine or the split route, through the
    row engine too; the route threshold (every route timed at 1–128
    query rows); the few-row calls timed on the split and row routes
    beside their plain version, exact SDPA and their bound; then the
    encoder call at B = 4 timed on the tile and row routes beside its
    plain version and exact SDPA."""
    rng = np.random.default_rng(6)
    worst_exact = 0.0
    failures = []
    qmax = get_precision("uint8").qmax
    for name, b, h, kvh, lq, lk, dh, causal, kv_len in DENSE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            for exact_logits in (True, False):
                q, k, v = dense_problem(rng, b, h, kvh, lq, lk, dh, dtype,
                                        exact_logits)
                for mode in MODES:
                    ref = dense_call(lut_attention_plain, mode, q, k, v,
                                     causal, kv_len)
                    f64 = (dense_f64(mode, q, k, v, causal, kv_len)
                           if exact_logits else None)
                    for route in routes_of(mode, q):
                        out = dense_call(lut_attention_cuda, mode, q, k, v,
                                         causal, kv_len, route=route)
                        torch.cuda.synchronize()
                        err = (out - ref).abs()
                        max_err = float(err.max())
                        kind = "exact-logit" if exact_logits else "random"
                        tag = (f"[dense] {name} {mode} {str(dtype)[6:]} "
                               f"{route} B={b} H={h}/{kvh} Lq={lq} Lk={lk} "
                               f"kv_len={kv_len} {kind}")
                        share = float((err.amax(dim=-1) > 1e-4).float()
                                      .mean())
                        if exact_logits:
                            # same f32 logits, so the same bins: what is
                            # left is each side's f32 σ·V roundoff, which
                            # the f64 evaluation of the plain version's σ
                            # referees
                            worst_exact = max(worst_exact, max_err)
                            k_err = float((out.double() - f64).abs().max())
                            p_err = float((ref.double() - f64).abs().max())
                            print(f"{tag}: max|err| {max_err:.3g}; kernel – "
                                  f"f64 {k_err:.3g} (limit {EXACT_TOL}), "
                                  f"plain – f64 {p_err:.3g}")
                            if not k_err <= EXACT_TOL:
                                failures.append(f"{tag}: kernel – f64 "
                                                f"{k_err} > {EXACT_TOL}")
                            continue
                        limit = 2.0 / qmax * float(v.float().abs().max())
                        print(f"{tag}: max|err| {max_err:.3g} (limit "
                              f"{limit:.3g}), rows beyond 1e-4: {share:.4%}")
                        if not max_err <= limit:
                            failures.append(f"{tag}: {max_err} > {limit}")
                    del ref, f64
    if failures:
        raise AssertionError("dense kernel off its plain version:\n"
                             + "\n".join(failures))

    # The route threshold: every route at Whisper's cross-attention shape
    # (1500 keys, fused) for few query rows (fewer than MIN_TILE_ROWS take
    # the split route, more the tile route).
    for lq in (1, 2, 4, 8, 9, 12, 16, 32, 64, 128):
        q, k, v = dense_problem(rng, W_BATCH, W_H, W_H, lq, W_LENC, W_DH,
                                torch.bfloat16, False)
        t = {route: device_ms(lambda: dense_call(
            lut_attention_cuda, "rexp_fused", q, k, v, False, None,
            route=route)) for route in ROUTES}
        print(f"[route] lut_attention rexp_fused bf16 B={W_BATCH} H={W_H} "
              f"Lq={lq} Lk={W_LENC}: " + ", ".join(
                  f"{r} {t[r]:.4f} ms" for r in ROUTES)
              + f"; dispatcher picks "
              f"{dense_route(q.dtype, W_DH, lq, qmax, 'rexp_fused')} "
              f"(MIN_TILE_ROWS {MIN_TILE_ROWS})")

    # The few-row calls of the main path, bf16, in the mode the model
    # path gives them (fused without a cache's kv_len, faithful with one):
    # the row route (the parent's route for them, its code unchanged) and
    # the split route, beside the plain version, exact SDPA on the same
    # inputs (a yardstick, not the same function) and the bound over the
    # visible pairs and the valid keys.
    few_rows = {}
    for name, b, h, kvh, lq, lk, dh, causal, kv_len in DENSE_CASES:
        if lq >= MIN_TILE_ROWS:
            continue
        mode = "rexp_fused" if kv_len is None else "rexp"
        q, k, v = dense_problem(rng, b, h, kvh, lq, lk, dh, torch.bfloat16,
                                False)
        pairs = dense_pairs(lq, lk, causal, kv_len)
        live = lk if kv_len is None else kv_len
        b_ms, b_by = dense_bound(b, h, kvh, lq, live, dh, torch.bfloat16,
                                 pairs)
        row = {route: device_ms(lambda: dense_call(
            lut_attention_cuda, mode, q, k, v, causal, kv_len, route=route))
            for route in ("rows", "split")}
        row.update(plain_ms=device_ms(lambda: dense_call(
            lut_attention_plain, mode, q, k, v, causal, kv_len)),
            sdpa_ms=dense_sdpa_ms(q, k, v, causal, kv_len), bound_ms=b_ms,
            bound_by=b_by)
        few_rows[name] = row
        print(f"[time] lut_attention {mode} bf16 {name} B={b} H={h}/{kvh} "
              f"Lq={lq} Lk={lk} kv_len={kv_len} Dh={dh}: split "
              f"{row['split']:.4f} ms, rows {row['rows']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, exact SDPA {row['sdpa_ms']:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by}), "
              f"{b_ms / row['split']:.1%} of bound on split")
        if name == "qwen3 lockstep decode":
            row["host_us"] = dense_host_us(q, k, v, kv_len)

    # The encoder call on the tile and row routes (the split route serves
    # few-row calls only).
    b, h, lq, lk, dh = W_BATCH, W_H, W_LENC, W_LENC, W_DH
    q, k, v = dense_problem(rng, b, h, h, lq, lk, dh, torch.bfloat16, False)
    b_ms, b_by = dense_bound(b, h, h, lq, lk, dh, torch.bfloat16, lq * lk)
    old_ms = dense_bound_f32_logits(b, h, h, lq, lk, dh, torch.bfloat16,
                                    lq * lk)
    sdpa = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v))
    rows = {}
    for mode in MODES:
        ref = dense_call(lut_attention_plain, mode, q, k, v, False, None)
        plain_ms = device_ms(lambda: dense_call(lut_attention_plain, mode, q,
                                                k, v, False, None))
        by_route = {}
        for route in ("rows", "tiles"):
            share = float(((dense_call(lut_attention_cuda, mode, q, k, v,
                                       False, None, route=route) - ref)
                           .abs().amax(dim=-1) > 1e-4).float().mean())
            ms = device_ms(lambda: dense_call(lut_attention_cuda, mode, q, k,
                                              v, False, None, route=route))
            by_route[route] = ms
            print(f"[time] lut_attention {mode} bf16 encoder {route} B={b} "
                  f"H={h} Lq=Lk={lq} Dh={dh}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, SDPA {sdpa:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}; first stated {old_ms:.4f} ms), "
                  f"{b_ms / ms:.1%} of bound; rows beyond 1e-4 of the plain "
                  f"version {share:.4%}")
        del ref
        picked = dense_route(q.dtype, dh, lq, qmax, mode)
        rows[mode] = dict(ms=by_route[picked], plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=None,
                          route_ms=by_route)
        if not by_route["tiles"] < by_route["rows"]:
            print(f"[time] lut_attention {mode}: the tile route is not "
                  f"faster than the row route at the encoder shape")
    print(f"[time] exact SDPA bf16 at the same shape (the library yardstick; "
          f"REXP has no library call): {sdpa:.4f} ms")
    return dict(max_abs_err=worst_exact, **rows["rexp_fused"],
                few_rows=few_rows)


def setup_whisper():
    """Whisper-small at full depth and width (12 + 12 layers, d_model 768,
    12 heads, vocab 51865), seeded random bf16 weights with every bias —
    attention and LayerNorm — seeded non-zero; 4 clips of 1500 seeded
    random stub frames and one seeded prompt of 4–12 tokens each."""
    arch = ARCHS["whisper-small"]
    model = build_model(arch)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(3)

    def bias(t, name):
        if name not in ("bq", "bk", "bv", "bo", "bias"):
            return t
        return torch.randn(t.shape, generator=gen, device="cuda") * 0.2

    params = cast_params(tree_map(bias, model.init(gen, "cuda")),
                         torch.bfloat16)
    torch.cuda.synchronize()
    rng = np.random.default_rng(4)
    frames = torch.as_tensor(rng.standard_normal(
        (W_BATCH, arch.encoder_seq, arch.d_model), dtype=np.float32),
        device="cuda")
    plen = int(rng.integers(4, 13))
    prompt = torch.as_tensor(rng.integers(0, arch.vocab_size,
                                          size=(W_BATCH, plen)),
                             dtype=torch.int32, device="cuda")
    print(f"[whisper] {arch.name}: {arch.encoder_layers} + {arch.n_layers} "
          f"layers, d_model {arch.d_model}, heads {arch.n_heads}, d_ff "
          f"{arch.d_ff}, vocab {arch.vocab_size}: "
          f"{arch.param_count() / 1e6:.0f}M params bf16, non-zero biases, "
          f"init {time.perf_counter() - t0:.1f}s; {W_BATCH} clips of "
          f"{arch.encoder_seq} frames, prompts of {plen} tokens, {W_NEW} new "
          f"tokens each")
    return model, params, frames, prompt


def lockstep_run(policy, backend="auto", dtype="bfloat16"):
    return RunConfig(dtype=dtype, softmax_policy=policy,
                     attention_backend=backend)


def _zero_dense():
    """Sync, then set the dense kernel's launch counters to 0."""
    torch.cuda.synchronize()
    for counts in (lut_attention_cuda.launches,
                   lut_attention_cuda.route_launches):
        for key in counts:
            counts[key] = 0


def lockstep_drive(model, params, prompt, run, new_tokens=W_NEW,
                   frames=None, around=None):
    """One ``serve_loop.generate`` of the prompts (an encoder-decoder's
    with its clips' ``frames``); returns the tokens, the dense kernel's
    launches by mode during it, its wall seconds and its launches by
    route."""
    _zero_dense()
    with around or contextlib.nullcontext():
        t0 = time.perf_counter()
        out = generate(model, params, prompt, run,
                       max_new_tokens=new_tokens, encoder_input=frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return (out, dict(lut_attention_cuda.launches), wall,
            dict(lut_attention_cuda.route_launches))


def lockstep_step_times(model, params, prompt, run, new_tokens,
                        frames=None):
    """The prefill (an encoder-decoder's encode included), then the
    decode steps one by one, each ended by a synchronize: (prefill s,
    mean decode step s)."""
    max_len = prompt.shape[1] + new_tokens
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = make_prefill_step(model, run, max_len)(params, prompt,
                                                           frames)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    steps = []
    for _ in range(new_tokens - 1):
        t0 = time.perf_counter()
        logits, state = model.decode_step(params, tok, state, run)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    return t_pre, float(np.mean(steps))


def whisper_step_times(model, params, frames, prompt, run):
    """Encode alone, then prefill and the decode steps one by one, each
    ended by a synchronize: (encode s, prefill s, mean decode step s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ENCDEC.encode(params, frames.to(torch.bfloat16), model.cfg, run,
                  run.softmax_policy)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    return (t_enc, *lockstep_step_times(model, params, prompt, run, W_NEW,
                                        frames))


#: the dense kernel's bodies as the profiler names them (the tile
#: route's, the row route's and the split route's)
DENSE_KERNEL_NAMES = ("lut_attention_tiles_kernel", "lut_attention_kernel",
                      "lut_attention_split_kernel")


def lockstep_profile(label, drive):
    """The device's busy share of a profiled lockstep drive (``drive(
    around)`` → :func:`lockstep_drive`'s result) and its device time by
    class: the dense kernel, matmuls, everything else ("not measured"
    when the profiler records no device time)."""
    from torch.profiler import ProfilerActivity, profile
    if not profiler_runs():
        return None
    prof = profile(activities=[ProfilerActivity.CUDA])
    _, launches, wall, _ = drive(prof)
    kernels = []
    for e in prof.key_averages():
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            kernels.append((us, e.count, e.key))
    if not kernels:
        print("[profile] the profiler recorded no device time: not measured")
        return None
    busy = sum(us for us, _, _ in kernels) / 1e6
    dense = sum(us for us, _, k in kernels
                if any(name in k for name in DENSE_KERNEL_NAMES)) / 1e6
    mm = sum(us for us, _, k in kernels
             if any(n in k for n in ("gemm", "gemv", "nvjet", "cutlass",
                                     "xmma", "sm90_"))) / 1e6
    print(f"[profile] {label} drive, profiled: device busy "
          f"{busy * 1e3:.1f} ms of {wall * 1e3:.1f} ms wall "
          f"({busy / wall:.1%}); dense LUT-attention kernel "
          f"{dense * 1e3:.1f} ms ({dense / busy:.1%} of busy); matmuls "
          f"{mm * 1e3:.1f} ms ({mm / busy:.1%}); everything else "
          f"{(busy - dense - mm) * 1e3:.1f} ms")
    traced = sum(n for _, n, k in kernels
                 if any(name in k for name in DENSE_KERNEL_NAMES))
    for name in DENSE_KERNEL_NAMES:
        us = sum(us for us, _, k in kernels if name in k)
        n = sum(n for _, n, k in kernels if name in k)
        print(f"[profile] {name}: {us / 1e3:.2f} ms in {n} calls")
    print(f"[profile] dense kernel calls in the trace {traced}, launches "
          f"counted {sum(launches.values())} (the profiler may drop events "
          f"at a trace's edge)")
    for us, count, key in sorted(kernels, reverse=True)[:8]:
        print(f"[profile]   {us / 1e3:8.2f} ms  {count:5d} calls  {key[:90]}")
    return busy, wall


def dense_shadow(shadow, qmax):
    """A stand-in for ``layers.lut_attention`` that makes each call, makes
    it again on the plain version (``backend="naive"``) and appends
    (name, max|err|, one LUT step of 2/qmax · max|v|, share of rows
    beyond 1e-4) to ``shadow``."""
    def shadowed(*args, **kw):
        out = ops.lut_attention(*args, **kw)
        ref = ops.lut_attention(*args, **{**kw, "backend": "naive"})
        rows = (out - ref).abs().amax(dim=-1)
        shadow.append(("lut_attention", float(rows.max()),
                       2.0 / qmax * float(args[2].float().abs().max()),
                       float((rows > 1e-4).float().mean())))
        return out
    return shadowed


def first_token_logits(model, params, frames, prompt, run,
                       new_tokens=W_NEW):
    max_len = prompt.shape[1] + new_tokens
    logits, _ = make_prefill_step(model, run, max_len)(params, prompt, frames)
    return logits[:, 0].float().cpu().numpy()


def phase_whisper():
    """Phase 7: the Whisper drive on ``attention_backend="auto"``, REXP
    uint8 — tokens, tok/s, encode and decode-step times, exactly
    12 + 24 · 32 = 780 dense launches split by mode; the same drive with
    every dense kernel call held to its plain version on its own inputs
    (one LUT step); the ``naive`` drive's first-token logits within 2 %
    under exact and REXP; one profiled drive."""
    model, params, frames, prompt = setup_whisper()
    cfg = model.cfg
    main = POLICIES[MAIN_POLICY]
    run = lockstep_run(main)
    lockstep_drive(model, params, prompt, run, frames=frames)  # warm-up
    out, launches, wall, by_route = lockstep_drive(model, params, prompt,
                                                   run, frames=frames)
    toks = out.numel()
    n_steps = W_NEW                           # the prefill and 31 decodes
    expect = {"rexp_fused": cfg.encoder_layers + cfg.n_layers * n_steps,
              "rexp": cfg.n_layers * n_steps, "lut2d": 0}
    # by route, as the dispatcher names them: the encoder's 1500-row
    # calls, the prompt's (self- and cross-attention in every decoder
    # layer) and the decode steps' single rows
    qmax = get_precision(main.precision).qmax
    dh = cfg.resolved_head_dim
    expect_routes = dict.fromkeys(ROUTES, 0)
    for n, rows in ((cfg.encoder_layers, cfg.encoder_seq),
                    (2 * cfg.n_layers, prompt.shape[1]),
                    (2 * cfg.n_layers * (n_steps - 1), 1)):
        expect_routes[dense_route(torch.bfloat16, dh, rows, qmax,
                                  "rexp")] += n
    total = sum(launches.values())
    print(f"[whisper] rexp-uint8 attention_backend=auto: {toks} tokens in "
          f"{wall:.3f}s ({toks / wall:.1f} tok/s); dense kernel launches "
          f"{total} {launches} by route {by_route} (expected "
          f"{sum(expect.values())} {expect} by route {expect_routes})")
    if launches != expect or by_route != expect_routes:
        raise AssertionError(f"whisper drive launched {launches} by route "
                             f"{by_route}, expected {expect} by route "
                             f"{expect_routes}")
    if out.shape != (W_BATCH, W_NEW) or not (
            (out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"whisper tokens out of range: {out}")
    t_enc, t_pre, t_dec = whisper_step_times(model, params, frames, prompt,
                                             run)
    print(f"[whisper] encode {t_enc * 1e3:.2f} ms ({cfg.encoder_layers} "
          f"layers, {W_BATCH} × {cfg.encoder_seq} frames); prefill incl. encode {t_pre * 1e3:.2f} ms; "
          f"mean decode step {t_dec * 1e3:.2f} ms ({W_BATCH} tokens)")

    shadow = []
    LAYERS.lut_attention = dense_shadow(shadow, qmax)
    try:
        shadow_out = lockstep_drive(model, params, prompt, run,
                                    frames=frames)
    finally:
        LAYERS.lut_attention = ops.lut_attention
    if len(shadow) != total or shadow_out[1] != expect \
            or shadow_out[3] != expect_routes:
        raise AssertionError(f"shadowed drive: {len(shadow)} calls, "
                             f"launches {shadow_out[1]} {shadow_out[3]}")
    check_shadow(shadow, "whisper drive")

    naive_out = lockstep_drive(model, params, prompt,
                               lockstep_run(main, "naive"), frames=frames)
    if any(naive_out[1].values()):
        raise AssertionError(f"naive drive launched {naive_out[1]}")
    agree = float((naive_out[0] == out).float().mean())
    print(f"[whisper] rexp-uint8 naive drive: {naive_out[2]:.3f}s "
          f"({toks / naive_out[2]:.1f} tok/s); tokens agreeing with the "
          f"kernel drive {agree:.1%}")
    for pol_name in ("exact", MAIN_POLICY):
        pol = POLICIES[pol_name]
        a = first_token_logits(model, params, frames, prompt,
                               lockstep_run(pol))
        b = first_token_logits(model, params, frames, prompt,
                               lockstep_run(pol, "naive"))
        worst = float(np.abs(a - b).max() / np.abs(b).max())
        same = float(np.mean(a.argmax(-1) == b.argmax(-1)))
        print(f"[whisper] {pol_name} auto vs naive: first-token logits "
              f"max|Δ|/max|logit| {worst:.4g}; first tokens agreeing "
              f"{same:.1%}")
        if not worst <= 0.02:
            raise AssertionError(f"whisper {pol_name} first-token logits "
                                 f"differ by {worst:.3g} > 0.02")
    lockstep_profile("whisper rexp-uint8", lambda around: lockstep_drive(
        model, params, prompt, run, frames=frames, around=around))
    return total, by_route


# ---------------------------------------------------------------------------
# Phases 8 and 9: the row-wise LUT softmax and exact flash attention
# ---------------------------------------------------------------------------

#: full-width logits for the row kernels: Whisper-small's encoder
#: self-attention (4 clips, 12 heads, 1500 frames) and Qwen3-32B's causal
#: prefill (64 heads, a 2048-token prompt, the upper triangle −inf)
ROW_SHAPES = {"whisper encoder": ((W_BATCH, W_H, W_LENC, W_LENC), False),
              "qwen3 prefill": ((1, H, 2048, 2048), True)}
ROW_KERNELS = {"rexp": (rexp_softmax_cuda, rexp_softmax_plain),
               "lut2d": (lut2d_softmax_cuda, lut2d_softmax_plain)}
FLOAT_TYPES = (torch.float32, torch.bfloat16, torch.float16)


def row_logits(shape, causal, dtype, seed):
    """Seeded normal logits (σ = 3) on the card; causal: the upper
    triangle of every (query, key) square −inf."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=gen, device="cuda") * 3
    if causal:
        lq, lk = shape[-2:]
        upper = torch.ones(lq, lk, dtype=torch.bool, device="cuda").triu(1)
        x.masked_fill_(upper, float("-inf"))
    return x.to(dtype)


def row_bound(numel, dtype):
    """Least time for a row kernel: each element read once and written
    once as f32 at 3.35 TB/s, against its operations at the f32 peak."""
    esize = torch.empty((), dtype=dtype).element_size()
    t_bytes = numel * (esize + 4) / HBM_BYTES_PER_S * 1e3
    t_ops = numel * ROW_OPS_PER_ELEMENT / PEAK_OPS[torch.float32] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row_plan_of(x, out, impl, tables):
    """The launch plan the row kernel's wrapper picks for ``x``."""
    return plan_for(x, out, *kernel_tables(impl, tables, "round",
                                           x.device)[:2])


#: the column sweep of the row kernels: the warp route (1–2048 columns,
#: vectors of 8, 4 and 1) and the cta route (staged in two buffers, one,
#: or re-read past 227 KB)
ROW_SWEEP_COLS = (1, 7, 8, 300, 1500, 1501, 2048, 4097, 16384, 65536)


def row_sweep_inputs(dt):
    """(label, x) of the column-and-alignment sweep in ``dt``: each column
    count with a fully masked row, a +inf and a NaN row; ``x[1:]`` of a
    (9, 1500) tensor (rows 8-byte aligned in bf16 / f16); flat views one
    element off a 16-byte boundary; a single finite row; more rows than
    the persistent grid walks in one pass."""
    gen = torch.Generator(device="cuda").manual_seed(11)

    def logits(rows, cols):
        x = torch.randn(rows, cols, generator=gen, device="cuda") * 3
        x[torch.rand(x.shape, generator=gen, device="cuda") < 0.25] = \
            float("-inf")
        x[0] = float("-inf")
        if rows > 2:
            x[1, cols // 2], x[2, cols // 3] = float("inf"), float("nan")
        return x.to(dt)

    cases = [(f"{c} columns", logits(4 if c > 2048 else 9, c))
             for c in ROW_SWEEP_COLS]
    cases.append(("x[1:] of (9, 1500)", logits(9, 1500)[1:]))
    for rows, cols in ((6, 1500), (3, 16384)):
        flat = logits(rows + 1, cols).reshape(-1)
        cases.append((f"({rows}, {cols}) one element off",
                      flat[1:1 + rows * cols].view(rows, cols)))
    cases.append(("a single row of 1500", logits(4, 1500)[3:]))
    cases.append(("9000 rows of 300", logits(9003, 300)[3:]))
    cases.append(("700 rows of 16384", logits(703, 16384)[3:]))
    return cases


def phase_row_softmax():
    """Phase 8: the op entry point ``lut_softmax(use_kernel=True)`` at full
    width, counted, with the route each call took; every result
    ``torch.equal`` to the plain version; the precision sweep,
    non-finite rows, the column-and-alignment sweep; times."""
    pols = {impl: SoftmaxPolicy(impl=impl, precision="uint8",
                                use_kernel=True) for impl in ROW_KERNELS}
    inputs = {(name, dt): row_logits(shape, causal, dt, seed=8)
              for name, (shape, causal) in ROW_SHAPES.items()
              for dt in (torch.float32, torch.bfloat16)}
    torch.cuda.synchronize()
    for kernel, _ in ROW_KERNELS.values():
        kernel.launches = 0
    outs = {(key, impl): SOPS.lut_softmax(x, pols[impl])
            for key, x in inputs.items() for impl in pols}
    torch.cuda.synchronize()
    launches = {impl: kernel.launches
                for impl, (kernel, _) in ROW_KERNELS.items()}
    print(f"[rows] lut_softmax(use_kernel=True) over "
          f"{len(inputs)} full-width tensors: launches {launches}")
    if launches != {impl: len(inputs) for impl in ROW_KERNELS}:
        raise AssertionError(f"the op entry point skipped a kernel: "
                             f"{launches}")
    failures = []
    routes = {}
    for ((name, dt), impl), out in outs.items():
        x = inputs[(name, dt)]
        tables = ops._tables_for(pols[impl])
        plan = row_plan_of(x, out, impl, tables)
        routes[(name, dt)] = plan.route
        print(f"[route] lut_softmax_{impl} {name} {tuple(x.shape)} "
              f"{str(dt)[6:]}: route {plan.route}, {plan.vec}-element "
              f"vectors, {plan.per_lane} elements a lane, stages "
              f"{plan.stages}, grid {plan.grid} × {plan.threads} threads, "
              f"{plan.smem} B shared")
        ref = ROW_KERNELS[impl][1](x, tables)
        same = torch.equal(out, ref)
        sums = out.sum(-1)
        print(f"[rows] {impl} {name} {tuple(x.shape)} {str(dt)[6:]}: "
              f"torch.equal to plain {same}; row sums in "
              f"[{float(sums.min()):.4f}, {float(sums.max()):.4f}]")
        if not same or out.shape != x.shape or not torch.isfinite(out).all():
            failures.append(f"{impl} {name} {dt}")
        del ref
    del outs

    # every precision × bin mode × input type at a small width, with
    # −inf masks, fully masked rows (all zeros out) and non-finite rows
    gen = torch.Generator(device="cuda").manual_seed(9)
    base = torch.randn(64, 300, generator=gen, device="cuda") * 3
    base[torch.rand(base.shape, generator=gen, device="cuda") < 0.25] = \
        float("-inf")
    base[:4] = float("-inf")
    base[4, 7], base[5, 9], base[6, 11] = float("inf"), float("nan"), \
        float("-inf")
    n_sweep = 0
    for impl, (kernel, plain) in ROW_KERNELS.items():
        for prec in ("int16", "uint8", "uint4", "uint2"):
            tables = ops._tables_for(SoftmaxPolicy(impl=impl, precision=prec))
            for mode in ("round", "floor"):
                for dt in FLOAT_TYPES:
                    x = base.to(dt)
                    out = kernel(x, tables, mode)
                    n_sweep += 1
                    if not (torch.equal(out, plain(x, tables, mode))
                            and not out[:4].any()):
                        failures.append(f"sweep {impl} {prec} {mode} {dt}")
    print(f"[rows] sweep: {n_sweep} cases (4 precisions × 2 bin modes × "
          f"f32/bf16/f16, rows fully masked and holding +inf / NaN): "
          f"{'all torch.equal' if not failures else failures}")

    # the column-and-alignment sweep, uint8 in both bin modes (inside
    # the Σ < 2^24 bound: 65 536 · 255 < 2^24)
    for dt in FLOAT_TYPES:
        for label, x in row_sweep_inputs(dt):
            line = []
            for impl, (kernel, plain) in ROW_KERNELS.items():
                tables = ops._tables_for(pols[impl])
                for mode in ("round", "floor"):
                    out = kernel(x, tables, mode)
                    same = torch.equal(out, plain(x, tables, mode))
                    if not same:
                        failures.append(f"{label} {impl} {mode} {dt}")
                    line.append(f"{impl}/{mode} {same}")
            plan = row_plan_of(x, out, "lut2d", tables)
            print(f"[rows] {label} {str(dt)[6:]} (route {plan.route}, "
                  f"{plan.vec}-element vectors, stages {plan.stages}, grid "
                  f"{plan.grid}): torch.equal " + ", ".join(line))
    if failures:
        raise AssertionError(f"row kernels off their plain versions: "
                             f"{failures}")

    rows = {}
    for (name, dt), x in inputs.items():
        b_ms, b_by = row_bound(x.numel(), dt)
        lib = device_ms(lambda: torch.softmax(x, dim=-1))
        for impl, (kernel, plain) in ROW_KERNELS.items():
            tables = ops._tables_for(pols[impl])
            ms = device_ms(lambda: kernel(x, tables))
            plain_ms = device_ms(lambda: plain(x, tables), iters=5)
            print(f"[time] lut_softmax_{impl} {name} {tuple(x.shape)} "
                  f"{str(dt)[6:]}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, torch.softmax {lib:.4f} ms (a "
                  f"yardstick of a row pass, not the same function), bound "
                  f"{b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of bound")
            case = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, softmax_ms=lib,
                        route=routes[(name, dt)])
            row = rows.setdefault(f"lut_softmax_{impl}", dict(
                max_abs_err=0.0, library_ms=None, cases={}))
            row["cases"][f"{name} {str(dt)[6:]}"] = case
            if name == "whisper encoder" and dt == torch.float32:
                row.update({k: case[k] for k in
                            ("ms", "plain_ms", "bound_ms", "bound_by")})
    return rows, {f"lut_softmax_{k}": v for k, v in launches.items()}


#: (name, B, H, KVH, Lq, Lk, Dh, causal) — Whisper-small's encoder, and
#: Qwen3-32B's causal prefill, a 16-token chunk at its tail and a chunk
#: longer than its keys (the first 100 rows see no key)
FLASH_CASES = [
    ("whisper encoder", W_BATCH, W_H, W_H, W_LENC, W_LENC, W_DH, False),
    ("qwen3 prefill", 1, H, KVH, 2048, 2048, DH, True),
    ("qwen3 tail chunk", 1, H, KVH, 16, 2048, DH, True),
    ("lq > lk", 1, H, KVH, 300, 200, DH, True),
]
#: (name, B, H, KVH, Lq, Lk, Dh, kv_len) — causal calls into a
#: pre-allocated cache, the queries right-aligned to kv_len: Qwen3-32B's
#: 16-token chunks into 2048 positions with a valid length per sequence
#: (the second one's first 9 rows see no key), and Whisper's decoder
#: self-attention (8 rows into 64 positions, 40 valid, one for all)
FLASH_KV_CASES = [
    ("qwen3 cache chunk", 2, H, KVH, 16, 2048, DH, (1500, 7)),
    ("whisper self cache", 4, W_H, W_H, 8, 64, W_DH, 40),
]


def causal_pairs(lq, lk, causal):
    """Visible (query row, key) pairs of one (sequence, head)."""
    if not causal:
        return lq * lk
    return sum(max(0, min(lk, i + lk - lq + 1)) for i in range(lq))


#: the 16-bit pieces the flash tile route splits p into for p·V
FLASH_PIECES = 3


def flash_bound(b, h, kvh, lq, lk, dh, dtype, pairs):
    """Least time for the flash call: q, k, v read once and the f32 out,
    m and l written once over 3.35 TB/s, against the products over the
    visible pairs.  With 16-bit inputs both may run on the tensor cores:
    q·kᵀ (each product exact in f32) and p·V as FLASH_PIECES 16-bit
    products, since p is f32 and one 16-bit piece of it misses the 2e-5
    limit — so (1 + FLASH_PIECES) products at 989 TFLOP/s.  With f32
    inputs both run in IEEE f32 on the CUDA cores (67 TFLOP/s)."""
    esize = torch.empty((), dtype=dtype).element_size()
    nbytes = ((b * h * lq + 2 * b * kvh * lk) * dh * esize
              + b * h * lq * (dh + 2) * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    flops = 2 * b * h * dh * pairs                   # one of q·kᵀ and p·V
    n = 1 + FLASH_PIECES if dtype != torch.float32 else 2
    t_ops = n * flops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_bound_f32_pv(b, h, kvh, lq, lk, dh, dtype, pairs):
    """The flash bound as first stated, kept beside the restated one: q·kᵀ
    at the input type's peak beside p·V at the f32 peak (p is f32); the
    busier unit sets the operations' time.  A kernel that takes p·V to
    the tensor cores may beat it."""
    esize = torch.empty((), dtype=dtype).element_size()
    nbytes = ((b * h * lq + 2 * b * kvh * lk) * dh * esize
              + b * h * lq * (dh + 2) * 4)
    flops = 2 * b * h * dh * pairs
    per_unit = {PEAK_OPS[torch.float32]: flops}
    per_unit[PEAK_OPS[dtype]] = per_unit.get(PEAK_OPS[dtype], 0) + flops
    return max(nbytes / HBM_BYTES_PER_S * 1e3,
               max(n / peak for peak, n in per_unit.items()) * 1e3)


def phase_flash():
    """Phase 9: ``flash_attention(backend="auto")`` at full width,
    counted by route (bf16 on the tile engine, f32 on the CUDA cores);
    the kernel's (out, m, l) against the plain version's on the route the
    dispatcher picks and, for bf16, on the CUDA-core route too; times
    beside the plain version and SDPA."""
    rng = np.random.default_rng(9)
    problems, kw_of = {}, {}
    for name, b, h, kvh, lq, lk, dh, causal, kv_len in (
            [(*c, None) for c in FLASH_CASES]
            + [(*c[:7], True, c[7]) for c in FLASH_KV_CASES]):
        arrays = [rng.standard_normal(s, dtype=np.float32)
                  for s in ((b, h, lq, dh), (b, kvh, lk, dh),
                            (b, kvh, lk, dh))]
        for dt in (torch.float32, torch.bfloat16):
            problems[(name, dt)] = [torch.as_tensor(a, device="cuda").to(dt)
                                    for a in arrays]
        kw_of[name] = dict(causal=causal, kv_len=(
            torch.tensor(kv_len, dtype=torch.int32, device="cuda")
            if isinstance(kv_len, tuple) else kv_len))
    torch.cuda.synchronize()
    for route in flash_attention_cuda.launches:
        flash_attention_cuda.launches[route] = 0
    outs = {key: FOPS.flash_attention(*qkv, backend="auto", **kw_of[key[0]])
            for key, qkv in problems.items()}
    torch.cuda.synchronize()
    launches = dict(flash_attention_cuda.launches)
    expect = {"simt": 0, "tiles": 0}
    for (_, dt), (q, _, _) in problems.items():
        expect[flash_route(dt, q.shape[-1])] += 1
    print(f"[flash] flash_attention(backend='auto') over {len(problems)} "
          f"full-width calls: launches by route {launches} (expected "
          f"{expect})")
    if launches != expect or expect["tiles"] != len(kw_of):
        raise AssertionError(f"the op entry point skipped a route: "
                             f"{launches}")
    worst, failures = 0.0, []
    for (name, dt), (q, k, v) in problems.items():
        kw = kw_of[name]
        ro, rm, rl = flash_attention_plain(q, k, v, **kw)
        blind = torch.isneginf(rm)
        seen = ~blind
        routes = [flash_route(dt, q.shape[-1])]
        routes += ["simt"] if routes[0] == "tiles" else []
        for route in routes:
            out, m, l = flash_attention_cuda(q, k, v, route=route, **kw)
            torch.cuda.synchronize()
            err = float((out - ro).abs().max())
            op_err = (float((outs[(name, dt)] - ro).abs().max())
                      if route == routes[0] else 0.0)
            m_rel = float(((m - rm).abs() / rm.abs().clamp(min=1e-30))[seen]
                          .max()) if seen.any() else 0.0
            l_rel = float(((l - rl).abs() / rl)[seen].max()) if seen.any() \
                else 0.0
            exact_blind = (torch.equal(torch.isneginf(m), blind)
                           and not out[blind].any() and not l[blind].any())
            kv_len = kw["kv_len"]
            if torch.is_tensor(kv_len):
                kv_len = kv_len.tolist()
            print(f"[flash] {name} {str(dt)[6:]} {route} B={q.shape[0]} "
                  f"H={q.shape[1]}/{k.shape[1]} Lq={q.shape[2]} "
                  f"Lk={k.shape[2]} Dh={q.shape[3]} causal={kw['causal']} "
                  f"kv_len={kv_len}: out "
                  f"max|err| {err:.3g} (op {op_err:.3g}; limit 2e-5), m rel "
                  f"{m_rel:.3g}, l rel {l_rel:.3g} (limit 1e-5); "
                  f"{int(blind.sum())} rows see no key"
                  f"{', exactly 0 / −inf / 0' if exact_blind else ''}")
            worst = max(worst, err, op_err)
            if not (err <= 2e-5 and op_err <= 2e-5 and m_rel <= 1e-5
                    and l_rel <= 1e-5 and exact_blind):
                failures.append(f"{name} {dt} {route}")
            del out, m, l
        del ro, rm, rl
    if failures:
        raise AssertionError(f"flash kernel off its plain version: "
                             f"{failures}")

    rows = {}
    for name, b, h, kvh, lq, lk, dh, causal in FLASH_CASES[:2]:
        pairs = causal_pairs(lq, lk, causal)
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = problems[(name, dt)]
            # the library yardstick, with the GQA head repeat outside the
            # timed call (Lq = Lk, so SDPA's causal mask is this one)
            kx, vx = (t.repeat_interleave(h // kvh, dim=1) for t in (k, v))
            sdpa = device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, kx, vx, is_causal=causal))
            del kx, vx
            b_ms, b_by = flash_bound(b, h, kvh, lq, lk, dh, dt, pairs)
            old_ms = flash_bound_f32_pv(b, h, kvh, lq, lk, dh, dt, pairs)
            plain_ms = device_ms(lambda: flash_attention_plain(
                q, k, v, causal=causal), iters=5)
            picked = flash_route(dt, dh)
            by_route = {}
            for route in [picked] + (["simt"] if picked == "tiles" else []):
                ms = device_ms(lambda: flash_attention_cuda(
                    q, k, v, causal=causal, route=route))
                by_route[route] = ms
                print(f"[time] flash_attention {name} {str(dt)[6:]} {route}: "
                      f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
                      f"{sdpa:.4f} ms, bound {b_ms:.4f} ms ({b_by}; first "
                      f"stated {old_ms:.4f} ms), {b_ms / ms:.1%} of bound")
            if name == "whisper encoder" and dt == torch.bfloat16:
                rows["flash_attention"] = dict(
                    max_abs_err=worst, ms=by_route[picked],
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=sdpa, route_ms=by_route,
                    route_launches=launches)
    return rows, {"flash_attention": sum(launches.values())}


# ---------------------------------------------------------------------------
# Phase 10: training
# ---------------------------------------------------------------------------

#: the scaled-down models of the card-against-CPU and resume checks
T_SMALL = dict(d_model=256, n_heads=4, vocab=1024, n_periods=2)
T_TOL = 1e-4             # card against CPU, of each leaf's largest entry
RESUME_TOL = 1e-6        # resumed against uninterrupted run, on the card
#: the full-width step: Qwen3-32B widths, 2 of 64 layers, B 4 × 511
#: input tokens in 2 microbatches, bf16 activations over f32 masters
T_LAYERS, T_BATCH, T_SEQ, T_STEPS = 2, 4, 511, 6
T_EVAL_POLICIES = ("exact", "rexp-uint8", "lut2d-uint8")


def largest_off(got, ref) -> float:
    """max |got − ref| over the largest |ref| (both moved to the CPU)."""
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    return float((got - ref).abs().max() / max(float(ref.abs().max()),
                                               1e-30))


def tree_off(a, b) -> tuple[float, str]:
    """The worst :func:`largest_off` over two trees' leaves, and its
    path."""
    return max((largest_off(x, y), p) for (p, x), (_, y) in zip(
        tree_flatten(a), tree_flatten(b)))


def params_off(got, ref, tol, lr, steps, label):
    """Parameters after ``steps`` AdamW steps held to ``ref``: every
    element within ``tol`` of its leaf's largest entry but Adam's flips.
    Adam moves an element by about ``lr`` whatever its gradient's size,
    so an element whose gradient is at the two runs' f32 roundoff (the
    first non-zero gradient of an embedding row, say) may move by ``lr``
    one way in one run and the other way in the other: such elements
    (at most a 1e-3 share of a leaf) are held within ``2 · lr · steps``
    instead.  Returns the worst other element's share of its leaf's
    largest entry and the number of flips."""
    worst, flips = 0.0, 0
    for (path, x), (_, y) in zip(tree_flatten(got), tree_flatten(ref)):
        x, y = x.detach().float().cpu(), y.detach().float().cpu()
        d = (x - y).abs()
        over = d > tol * float(y.abs().max())
        flips += int(over.sum())
        if over.float().mean() > 1e-3 or float(d.max()) > 2 * lr * steps:
            raise AssertionError(f"{label}: {path} off by {float(d.max())} "
                                 f"in {int(over.sum())} of {d.numel()} "
                                 f"elements")
        rest = torch.where(over, torch.zeros_like(d), d)
        worst = max(worst, float(rest.max() / y.abs().max()))
    return worst, flips


def step0_grads(name, device, params):
    """The loss's gradients at ``params`` (a copy on ``device``) on the
    smoke's first small batch, by checkpoint path."""
    arch = ARCHS[name].scaled_down(**T_SMALL)
    run = RunConfig(dtype="float32")
    p = TL.train_state(tree_map(lambda t, _: t.detach().to(
        device, copy=True), params), run).params
    ds = SyntheticDataset(DataConfig(arch.vocab_size, 64, 4, seed=3))
    loss, _ = TL.make_loss_fn(build_model(arch), run)(
        p, {"tokens": torch.from_numpy(ds.batch(0)).to(device)})
    loss.backward()
    return {path: t.grad for path, t in tree_flatten(p)}


def small_train(name, device, params, steps):
    """``steps`` f32 train steps of the scaled-down ``name`` from a copy
    of ``params`` on ``device``, on the seeded synthetic stream: (the
    losses, the final state)."""
    arch = ARCHS[name].scaled_down(**T_SMALL)
    model = build_model(arch)
    run = RunConfig(dtype="float32", learning_rate=1e-3)
    state = TL.train_state(tree_map(lambda t, _: t.detach().to(
        device, copy=True), params), run)
    step = TL.make_train_step(model, run)
    ds = SyntheticDataset(DataConfig(arch.vocab_size, 64, 4, seed=3))
    losses = []
    for i in range(steps):
        state, m = step(state, {"tokens": torch.from_numpy(ds.batch(i))
                                .to(device)})
        losses.append(float(m["loss"]))
    return losses, state


def train_card_vs_cpu(card):
    """The scaled-down Qwen3 and Granite-MoE (its load-balance loss and
    the routing backward) from one seeded init, on the card and on the
    CPU: the first step's gradients within ``T_TOL`` of each leaf's
    largest entry; 3 train steps' losses within ``T_TOL`` relative and
    parameters within ``T_TOL`` of each leaf's largest entry but Adam's
    flips (:func:`params_off`)."""
    for name in ("qwen3-32b", "granite-moe-3b-a800m"):
        arch = ARCHS[name].scaled_down(**T_SMALL)
        params = build_model(arch).init(torch.Generator().manual_seed(3),
                                        "cpu")
        g_off, g_where = tree_off(step0_grads(name, "cuda", params),
                                  step0_grads(name, "cpu", params))
        t0 = time.perf_counter()
        card_l, card_s = small_train(name, "cuda", params, 3)
        t_card = time.perf_counter() - t0
        cpu_l, cpu_s = small_train(name, "cpu", params, 3)
        loss_off = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
        off, flips = params_off(card_s.params, cpu_s.params, T_TOL, 1e-3, 3,
                                f"{name} card against CPU")
        print(f"[train] {name} (d_model {arch.d_model}, {arch.n_layers} "
              f"layers, vocab {arch.vocab_size}) card against CPU, f32: "
              f"first-step gradients worst {g_off:.3g} of the largest entry "
              f"({g_where}); 3 steps' losses {card_l} / {cpu_l}, worst "
              f"{loss_off:.3g} relative; parameters worst {off:.3g} of the "
              f"largest entry but {flips} Adam flips; card {t_card:.2f}s "
              f"incl. first calls")
        if not (g_off <= T_TOL and loss_off <= T_TOL):
            raise AssertionError(f"{name}: card against CPU {g_off:.3g} / "
                                 f"{loss_off:.3g} > {T_TOL}")


def train_resume(card):
    """A ``ResilientTrainer`` on the card (the scaled-down Qwen3,
    ``checkpoint_every=2``) with a failure injected once at step 4
    recovers from the step-4 checkpoint and reaches step 8: its losses
    and parameters within ``RESUME_TOL`` of an uninterrupted run's."""
    name = "qwen3-32b"
    arch = ARCHS[name].scaled_down(**T_SMALL)
    model = build_model(arch)
    params = model.init(torch.Generator().manual_seed(4), "cpu")
    ref_l, ref_s = small_train(name, "cuda", params, 8)
    run = RunConfig(dtype="float32", learning_rate=1e-3)
    state = TL.train_state(tree_map(lambda t, _: t.to("cuda"), params), run)
    ds = SyntheticDataset(DataConfig(arch.vocab_size, 64, 4, seed=3))
    armed, losses = [True], {}

    def hook(step):
        if step == 4 and armed[0]:
            armed[0] = False
            raise RuntimeError("injected failure at step 4")

    directory = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        final, report = ResilientTrainer(
            TL.make_train_step(model, run),
            CheckpointManager(directory, keep_n=2), checkpoint_every=2).run(
            state, lambda i: {"tokens": torch.from_numpy(ds.batch(i))
                              .to("cuda")}, 8, failure_hook=hook,
            metrics_cb=lambda i, m: losses.__setitem__(i, m["loss"]))
        kept = sorted(os.listdir(directory))
    finally:
        shutil.rmtree(directory)
    loss_off = max(abs(losses[i] - ref_l[i]) / abs(ref_l[i])
                   for i in range(8))
    off, flips = params_off(final.params, ref_s.params, RESUME_TOL, 1e-3, 8,
                            "resumed run")
    print(f"[train] resilient run on the card: {report.failures_recovered} "
          f"failure recovered, {report.steps_run} steps, checkpoints "
          f"{kept}; against the uninterrupted run: losses worst "
          f"{loss_off:.3g} relative, parameters worst {off:.3g} of the "
          f"largest entry but {flips} Adam flips")
    if (report.failures_recovered != 1 or int(final.opt.step) != 8
            or not loss_off <= RESUME_TOL):
        raise AssertionError(f"resumed run off: {report}, {loss_off:.3g}")


@contextlib.contextmanager
def timed_optimizer(times):
    """Record CUDA events around every ``adamw_update`` of the train step
    and every gradient clip inside it; ``times`` gets (name, start,
    end) triples."""
    update, clip = TL.adamw_update, ADAMW.clip_by_global_norm

    def wrap(name, fn):
        def timed(*args, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*args, **kw)
            ev[1].record()
            times.append((name, *ev))
            return out
        return timed

    TL.adamw_update = wrap("adamw", update)
    ADAMW.clip_by_global_norm = wrap("clip", clip)
    try:
        yield
    finally:
        TL.adamw_update, ADAMW.clip_by_global_norm = update, clip


def full_width_train(card):
    """Qwen3-32B widths cut to ``T_LAYERS`` layers: ``T_STEPS`` steps of
    B ``T_BATCH`` × ``T_SEQ`` inputs in 2 microbatches, bf16 activations
    over f32 masters, lr 1e-4, on one synthetic batch: the step-0 loss
    within 0.5 of ln V, every loss finite, the last below the first;
    step time, tokens/s, peak memory and the optimizer's share."""
    full = ARCHS["qwen3-32b"]
    arch = full.with_layers(T_LAYERS)
    model = build_model(arch)
    run = RunConfig(dtype="bfloat16", microbatch=2, learning_rate=1e-4)
    t0 = time.perf_counter()
    state = TL.init_train_state(
        model, torch.Generator(device="cuda").manual_seed(7), run, "cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for _, p in tree_flatten(state.params))
    print(f"[train] {arch.name}: d_model {arch.d_model}, heads "
          f"{arch.n_heads}/{arch.n_kv_heads} of {arch.resolved_head_dim}, "
          f"d_ff {arch.d_ff}, vocab {arch.vocab_size}, untied, "
          f"{arch.n_layers} of {full.n_layers} layers: {n / 1e9:.3f}B "
          f"params (f32 masters, grads, m, v: {16 * n / 1e9:.1f} GB), init "
          f"{time.perf_counter() - t0:.1f}s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    ds = SyntheticDataset(DataConfig(arch.vocab_size, T_SEQ, T_BATCH,
                                     seed=11))
    batch = {"tokens": torch.from_numpy(ds.batch(0)).to("cuda")}
    step = TL.make_train_step(model, run)
    losses, walls, times = [], [], []
    torch.cuda.reset_peak_memory_stats()
    with timed_optimizer(times):
        for i in range(T_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            loss = float(m["loss"])
            walls.append(time.perf_counter() - t0)
            losses.append(loss)
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.median(walls[1:]))
    ms = {name: float(np.median([s.elapsed_time(e) for k, s, e in times[2:]
                                 if k == name])) for name in ("adamw", "clip")}
    toks = T_BATCH * T_SEQ
    print(f"[train] full-width step (B {T_BATCH} × {T_SEQ} tokens, 2 "
          f"microbatches, bf16 over f32 masters, remat): losses "
          f"{[round(x, 4) for x in losses]} (ln V = "
          f"{math.log(arch.vocab_size):.4f}); step {step_s * 1e3:.1f} ms "
          f"(median of steps 1–{T_STEPS - 1}; step 0 {walls[0]:.2f}s), "
          f"{toks / step_s:.0f} tokens/s, peak memory "
          f"{peak / 2**30:.1f} GiB; AdamW {ms['adamw']:.1f} ms "
          f"({ms['adamw'] / (step_s * 1e3):.1%} of the step) of which the "
          f"clip {ms['clip']:.1f} ms ({ms['clip'] / (step_s * 1e3):.1%}) "
          f"— {card}")
    if not (all(math.isfinite(x) for x in losses)
            and abs(losses[0] - math.log(arch.vocab_size)) <= 0.5
            and losses[-1] < losses[0]):
        raise AssertionError(f"full-width losses {losses}")
    # the evals score a held-out batch of the stream, as the launcher's
    held_out = {"tokens": torch.from_numpy(ds.batch(10_000)).to("cuda")}
    return model, state.params, held_out, dict(
        step_ms=step_s * 1e3, tokens_per_s=toks / step_s,
        peak_gib=peak / 2**30, adamw_ms=ms["adamw"], clip_ms=ms["clip"])


#: a call of the eval's shadow may hold this many rows that only the
#: plain version's roundoff neighbours explain
FLIP_ROWS = 4
#: the relative change of a row's logits that stands for the kernel's
#: q·k roundoff against cuBLAS's (a few f32 ulps of a 128-term sum)
LOGIT_ROUNDOFF = 2.0 ** -20


def roundoff_neighbours(s, v, pol):
    """The plain version's row (faithful REXP or 2D-LUT) on f32 logits
    ``s`` (Lk,) scaled by 1 − ``LOGIT_ROUNDOFF``, 1 and 1 +
    ``LOGIT_ROUNDOFF`` (every ``max − x`` moved by that share: the
    numerators a roundoff-sized change bins otherwise), each with its
    denominator's bin — REXP's α index, 2D-LUT's Σ column — as binned
    and moved one step down and up (a Σ that such a change carried
    across a bin edge moves every weight of the row).  The plain row
    itself is among them."""
    tables = ops._tables_for(pol)
    qmax = tables.precision.qmax
    inv = LUT.inv_scale(qmax)
    vf, out = v.float(), []
    for f in (1.0 - LOGIT_ROUNDOFF, 1.0, 1.0 + LOGIT_ROUNDOFF):
        x = s * f
        if pol.impl == "rexp":
            e = LUT.rexp_exp_int(x, tables, index_mode=pol.index_mode)
            ja = LUT.rexp_alpha_index(e.float().sum(-1, keepdim=True),
                                      tables, pol.index_mode)
            lut = torch.as_tensor(tables.lut_alpha, dtype=torch.int32,
                                  device=s.device)
            out += [torch.matmul(torch.round((e * lut[torch.clamp(
                ja + dj, 0, lut.numel() - 1)]).float() * inv) * inv, vf)
                for dj in (-1, 0, 1)]
            continue
        e = LUT.lut2d_exp_int(x, tables, index_mode=pol.index_mode)
        sig = torch.as_tensor(tables.lut_sigma, dtype=torch.int32,
                              device=s.device)
        n_rows, n_cols = sig.shape
        i_idx = LUT._bin_index(e.float() * LUT.inv_scale(
            qmax * tables.scale_ex), pol.index_mode, 0, n_rows - 1)
        j_idx = LUT._bin_index(e.float().sum(-1, keepdim=True)
                               * LUT.inv_scale(qmax * tables.scale_sum),
                               pol.index_mode, 1, n_cols) - 1
        out += [torch.matmul(sig[i_idx, torch.clamp(
            j_idx + dj, 0, n_cols - 1).expand_as(i_idx)].float() * inv, vf)
            for dj in (-1, 0, 1)]
    return out


def eval_shadow(shadow, pol):
    """:func:`dense_shadow` for the evals' calls: each call made on the
    kernel and on its plain version; a row beyond one LUT step of the
    plain version must lie within one LUT step of one of
    :func:`roundoff_neighbours`' rows, at most ``FLIP_ROWS`` of them a
    call.  Appends (name, max|err| of the other rows, one LUT step,
    share of rows beyond 1e-4) and prints each such row."""
    qmax = get_precision(pol.precision).qmax

    def shadowed(q, k, v, policy, **kw):
        out = ops.lut_attention(q, k, v, policy, **kw)
        ref = ops.lut_attention(q, k, v, policy, **{**kw,
                                                    "backend": "naive"})
        limit = 2.0 / qmax * float(v.float().abs().max())
        rows = (out - ref).abs().amax(dim=-1)
        bad = (rows > limit).nonzero().tolist()
        if len(bad) > FLIP_ROWS:
            raise AssertionError(f"{len(bad)} rows beyond one LUT step")
        g = q.shape[1] // k.shape[1]
        for b, h, r in bad:
            s = REF._logits(q[b:b + 1, h:h + 1], k[b:b + 1, h // g:h // g + 1],
                            q.shape[-1] ** -0.5, kw["causal"],
                            kw.get("kv_len"))[0, 0, r]
            moved = min(float((out[b, h, r] - alt).abs().max()) for alt in
                        roundoff_neighbours(s, v[b, h // g], policy))
            print(f"[train] row (b {b}, head {h}, row {r}: "
                  f"{int(torch.isfinite(s).sum())} keys) off the plain "
                  f"version by {float(rows[b, h, r]):.4g} > one LUT step "
                  f"{limit:.4g}; off its nearest roundoff neighbour (the "
                  f"logits moved by {LOGIT_ROUNDOFF:.3g} relative, the "
                  f"denominator bin by at most one step) by {moved:.4g}")
            if not moved <= limit:
                raise AssertionError(f"row ({b}, {h}, {r}) unexplained")
            rows[b, h, r] = 0
        shadow.append(("lut_attention", float(rows.max()), limit,
                       float((rows > 1e-4).float().mean())))
        return out
    return shadowed


def eval_policies(model, params, batch, card):
    """``make_eval_step`` on the trained parameters and a held-out batch
    under exact, REXP uint8 and 2D-LUT uint8, ``attention_backend`` auto
    and naive: each LUT eval launches the dense kernel once a layer on
    the tile route, every launched call within one LUT step of its plain
    version (a shadowed eval, :func:`eval_shadow`), auto against naive
    ``eval_loss`` within 1e-3 relative; the LUT-minus-exact deltas
    printed.  Returns the REXP
    eval's launches by route.

    Across 130 816 rows a call, a row may sit where the f32 roundoff of
    the kernel's q·k against the plain version's moves one numerator
    bin and with it the row's Σ across a bin edge of the denominator:
    every weight of the row then moves by one step of LUT_α (or of the
    σ table's column), more than one LUT step of the output
    (:func:`eval_shadow` holds such rows to the plain version's
    roundoff neighbours)."""
    n_attn = model.cfg.n_layers
    qmax = get_precision("uint8").qmax
    expect = dict.fromkeys(ROUTES, 0)
    expect[dense_route(torch.bfloat16, model.cfg.resolved_head_dim, T_SEQ,
                       qmax, "rexp")] = n_attn
    got = {}
    for pol in T_EVAL_POLICIES:
        for backend in ("auto", "naive"):
            ev = TL.make_eval_step(model, lockstep_run(POLICIES[pol],
                                                       backend))
            _zero_dense()
            t0 = time.perf_counter()
            m = {k: float(v) for k, v in ev(params, batch).items()}
            wall = time.perf_counter() - t0
            routes = dict(lut_attention_cuda.route_launches)
            want = (expect if backend == "auto" and pol != "exact"
                    else dict.fromkeys(ROUTES, 0))
            print(f"[train] eval {pol} {backend}: eval_loss "
                  f"{m['eval_loss']:.5f}, next_token_acc "
                  f"{m['next_token_acc']:.4f}, {wall * 1e3:.0f} ms; dense "
                  f"launches by route {routes}")
            if routes != want:
                raise AssertionError(f"eval {pol} {backend} launched "
                                     f"{routes}, expected {want}")
            got[pol, backend] = (m, routes)
        a, n = got[pol, "auto"][0], got[pol, "naive"][0]
        rel = abs(a["eval_loss"] - n["eval_loss"]) / abs(n["eval_loss"])
        if not rel <= 1e-3:
            raise AssertionError(f"eval {pol}: auto against naive {rel:.3g}")
    for pol in ("rexp-uint8", "lut2d-uint8"):
        shadow = []
        LAYERS.lut_attention = eval_shadow(shadow, POLICIES[pol])
        try:
            TL.make_eval_step(model, lockstep_run(POLICIES[pol]))(params,
                                                                   batch)
        finally:
            LAYERS.lut_attention = ops.lut_attention
        if len(shadow) != n_attn:
            raise AssertionError(f"shadowed eval: {len(shadow)} calls")
        check_shadow(shadow, f"{pol} eval", tag="[train]")
        d_loss = (got[pol, "auto"][0]["eval_loss"]
                  - got["exact", "auto"][0]["eval_loss"])
        d_acc = (got[pol, "auto"][0]["next_token_acc"]
                 - got["exact", "auto"][0]["next_token_acc"])
        print(f"[train] {pol} minus exact: eval_loss {d_loss:+.5f}, "
              f"next_token_acc {d_acc:+.4f} — {card}")
    return got["rexp-uint8", "auto"][1]


def calibrate_full_width(model, params, batch):
    """A ``SumCollector`` through one exact bf16 ``prefill`` of the
    full-width model, its samples against the same collector fed the
    CPU's plain logits of the same slices (within 1e-5 relative)."""
    slices = []
    tap = LAYERS.attention_logits

    def recorded(q, k, scale, causal):
        slices.append((q.cpu(), k.cpu(), scale, causal))
        return tap(q, k, scale, causal)

    card = SumCollector()
    LAYERS.attention_logits = recorded
    try:
        with torch.no_grad():
            model.prefill(params, batch["tokens"][:, :-1],
                          lockstep_run(POLICIES["exact"]), max_len=T_SEQ,
                          collector=card)
    finally:
        LAYERS.attention_logits = tap
    cpu = SumCollector()
    for q, k, scale, causal in slices:
        cpu.offer(REF._logits(q, k, scale, causal))
    res = card.result()
    off = float(np.max(np.abs(card.samples() - cpu.samples())
                       / np.abs(cpu.samples())))
    print(f"[train] calibration (exact prefill, {len(slices)} attention "
          f"layers): count {res.count}, mean {res.mean:.3f}, p50 "
          f"{res.p50:.3f}, p99 {res.p99:.3f}, p99.9 {res.p999:.3f}, max "
          f"{res.max:.3f}; recommend_alpha_len {res.recommend_alpha_len()}, "
          f"recommend_sigma_cols {res.recommend_sigma_cols()}; samples "
          f"against the CPU's plain logits of the same slices: worst "
          f"{off:.3g} relative")
    if len(slices) != model.cfg.n_layers or res.count != T_SEQ * len(slices):
        raise AssertionError(f"calibration: {len(slices)} taps, "
                             f"{res.count} samples")
    if not off <= 1e-5:
        raise AssertionError(f"calibration samples off by {off:.3g}")


def eval_shape_row(card):
    """The dense kernel at the eval step's call (B 4, 64 / 8 heads of
    128, 511 rows over a 511-key cache at kv_len 511, causal, bf16, REXP
    faithful, the tile route as the dispatcher picks it): within one LUT
    step of its plain version on normal rows, timed beside it, exact
    SDPA on the same inputs and its bound."""
    h, kvh, dh = H, KVH, DH
    qmax = get_precision("uint8").qmax
    q, k, v = dense_problem(np.random.default_rng(13), T_BATCH, h, kvh,
                            T_SEQ, T_SEQ, dh, torch.bfloat16, False)
    route = dense_route(q.dtype, dh, T_SEQ, qmax, "rexp")
    ref = dense_call(lut_attention_plain, "rexp", q, k, v, True, T_SEQ)
    out = dense_call(lut_attention_cuda, "rexp", q, k, v, True, T_SEQ,
                     route=route)
    err = float((out - ref).abs().max())
    limit = 2.0 / qmax * float(v.float().abs().max())
    if not err <= limit:
        raise AssertionError(f"eval-shape call off its plain version by "
                             f"{err} > one LUT step {limit}")
    b_ms, b_by = dense_bound(T_BATCH, h, kvh, T_SEQ, T_SEQ, dh,
                             torch.bfloat16,
                             dense_pairs(T_SEQ, T_SEQ, True, T_SEQ))
    row = dict(route=route, ms=device_ms(lambda: dense_call(
        lut_attention_cuda, "rexp", q, k, v, True, T_SEQ, route=route)),
        plain_ms=device_ms(lambda: dense_call(
            lut_attention_plain, "rexp", q, k, v, True, T_SEQ)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        sdpa_ms=dense_sdpa_ms(q, k, v, True, T_SEQ), max_abs_err=err)
    print(f"[time] lut_attention rexp bf16 qwen3-32b eval B={T_BATCH} "
          f"H={h}/{kvh} Lq={T_SEQ} Lk={T_SEQ} kv_len={T_SEQ} Dh={dh} "
          f"{route}: kernel {row['ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms, exact SDPA {row['sdpa_ms']:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}), {b_ms / row['ms']:.1%} of bound; "
          f"max|err| {err:.3g} (limit {limit:.3g}) — {card}")
    return row


def phase_train(card):
    """Phase 10 (lines ``[train]``): the training side of the port —
    card against CPU, checkpoint and resume, the full-width step, the
    exact-against-LUT evals, calibration, the dense kernel at the eval
    shape.  Returns the dense kernel's ``qwen3-32b-eval`` row."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    print(f"[train] phase 10 starts with "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    train_card_vs_cpu(card)
    train_resume(card)
    model, params, batch, numbers = full_width_train(card)
    routes = eval_policies(model, params, batch, card)
    calibrate_full_width(model, params, batch)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    row = eval_shape_row(card)
    print(f"[train] phase 10: {time.perf_counter() - t0:.1f}s — {card}")
    return dict(row, launches=sum(routes.values()), route_launches=routes,
                train=numbers)


# ---------------------------------------------------------------------------
# Phase 11: the model across ranks
# ---------------------------------------------------------------------------

#: expert-parallel serving: layers (the depth cut below phase 5d's to
#: keep the smoke in its time), new tokens a request, the drives'
#: policies
R_SERVE_LAYERS = 2
R_NEW_TOKENS = 16
R_POLICIES = (MAIN_POLICY, "exact")
#: the 'pages' drives of phase 11a, model → (tp, policies): Granite-MoE-3B
#: at tp 3, where its 8 KV heads do not divide 3 and wq's columns and
#: wo's rows (1536) do, so shard_params cuts them (the paged layers'
#: row-parallel wo); its experts (40 of 512) stay whole
R_SERVE_PAGES = {"granite-moe-3b-a800m": (3, ("exact",))}
#: the sharded train step: Granite-MoE-3B at full width, 2 layers, f32,
#: a (data 2, model 2) mesh, global batch 4 × 256, lr 1e-4, 3 steps, then
#: a save, a restore on one rank and 2 more steps
R_TRAIN_LAYERS, R_BATCH, R_SEQ, R_STEPS, R_MORE, R_LR = 2, 4, 256, 3, 2, 1e-4
R_MESH = {"data": 2, "model": 2}
R_LOSS_TOL, R_GRAD_TOL, R_NORM_TOL, R_RESUME_TOL = 1e-4, 1e-4, 1e-5, 3e-4
#: GPipe: 2 stages, each one full-width Granite-MoE layer, 4
#: microbatches of 2 × 128 tokens
R_STAGES, R_MICRO, R_MB, R_MB_SEQ, R_PIPE_TOL = 2, 4, 2, 128, 1e-6
#: the sites of a decode step's collectives that run once a layer under
#: shard_params on an MoE decoder: the cut attention's and the experts'
R_LAYER_SITES = LAYER_SITES + ("moe",)


def _expert_bytes(params) -> int:
    """Bytes of the routed experts' stacked weights of a tree."""
    return sum(x.nbytes for path, x in tree_flatten(params)
               if path.split("/")[-2] == "ffn"
               and path.rsplit("/", 1)[-1] in ("w_gate", "w_up", "w_down"))


def _init_bf16(arch, device):
    model = build_model(arch)
    gen = torch.Generator(device=device).manual_seed(0)
    return model, model.init(gen, device, dtype=torch.bfloat16)


def ep_reference(model, params, requests, policy, device, routes):
    """The tp = 1 sync drive of phase 11a: tokens, first-token logits,
    top-2 margins and paged launches, the expert choices of every
    routing call recorded into ``routes``."""
    run = RunConfig(dtype="bfloat16", softmax_policy=POLICIES[policy],
                    paged_backend="auto")
    eng = ServingEngine(model, params, run, engine_config(), device=device)
    firsts, margins = {}, {}
    sample = eng._sample

    def recording(seq, row):
        top2 = np.sort(row)[-2:]
        margins[seq.request.id, len(seq.generated)] = float(top2[1] - top2[0])
        if not seq.generated:
            firsts[seq.request.id] = row.copy()
        return sample(seq, row)

    eng._sample = recording
    for rid, (prompt, n_new) in enumerate(requests):
        eng.add_request(prompt, n_new, seed=rid)
    _sync(device)
    _zero_launches()
    t0 = time.perf_counter()
    with pinned_routes(record=routes):
        results = eng.run()
    _sync(device)
    return dict(tokens={r: res.tokens.tolist() for r, res in results.items()},
                firsts=firsts, margins=margins, launches=_paged_launches(),
                wall=time.perf_counter() - t0, n_tokens=eng.stats.tokens)


def ep_rank(mesh, arch, requests, routes, policies=R_POLICIES):
    """One rank of phase 11a: the seeded bf16 weights (drawn one rank at
    a time), cut by ``shard_params`` (at tp 2 this rank's half of the
    experts, its columns of the shared MLP and its heads), then a sync
    drive a policy of ``policies`` replaying the tp = 1 drive's expert
    choices; rank 0 serves, the others follow.  Returns (rank 0) per
    policy its tokens,
    first-token logits, and every rank's paged launches, decode bytes a
    layer, collective sites, expert bytes, flipped routings and wall
    seconds."""
    from repro_torch.runtime import partitioning as PT
    params = None
    for r in range(mesh.tp):
        if r == mesh.rank:
            model, whole = _init_bf16(arch, mesh.device)
            params = PT.Layout(arch, mesh, fsdp=False).cut(whole)
            del whole
            _sync(mesh.device)
            if torch.device(mesh.device).type == "cuda":
                torch.cuda.empty_cache()
        torch.distributed.barrier(group=mesh.group)
    out = {}
    for policy in policies:
        run = RunConfig(dtype="bfloat16", softmax_policy=POLICIES[policy],
                        paged_backend="auto")
        cfg = dataclasses.replace(engine_config(), mesh=mesh,
                                  shard_params=True)
        eng = ServingEngine(model, params, run, cfg, device=mesh.device)
        firsts = {}
        if mesh.rank == 0:
            sample = eng._sample

            def recording(seq, row, sample=sample):
                if not seq.generated:
                    firsts[seq.request.id] = row.copy()
                return sample(seq, row)
            eng._sample = recording
        per_layer, sites, gathers = [], set(), []
        decode = eng._op_decode

        def watched(*a, decode=decode, **kw):
            mesh.log.records.clear()
            got = decode(*a, **kw)
            sites.update((r.site, r.kind, r.shape)
                         for r in mesh.log.records)
            per_layer.append(mesh.log.nbytes(*R_LAYER_SITES)
                             / model.cfg.n_layers)
            gathers.append(mesh.log.nbytes("tp_gather"))
            return got
        eng._op_decode = watched
        flips = []
        _sync(mesh.device)
        _zero_launches()
        mesh.log.clear()
        t0 = time.perf_counter()
        results = None
        with pinned_routes(replay=[r.to(mesh.device) for r in
                                   routes[policy]], flips=flips):
            if mesh.rank == 0:
                for rid, (prompt, n_new) in enumerate(requests):
                    eng.add_request(prompt, n_new, seed=rid)
                try:
                    results = eng.run()
                finally:
                    eng.close()
            else:
                eng.follow()
        _sync(mesh.device)
        flipped = torch.cat(flips)
        mine = dict(launches=_paged_launches(),
                    wall=time.perf_counter() - t0,
                    decode_bytes=max(per_layer), sites=sorted(sites),
                    experts=_expert_bytes(eng.params),
                    flips=(int(flipped.sum()), flipped.numel()),
                    tp_gather=max(gathers),
                    spec_bytes=serving_spec_bytes(model.cfg, mesh,
                                                  eng.params))
        ranks = [None] * mesh.tp
        torch.distributed.all_gather_object(ranks, mine, group=mesh.group)
        if mesh.rank == 0:
            out[policy] = dict(
                regime=eng.regime, ranks=ranks, firsts=firsts,
                n_tokens=eng.stats.tokens,
                tokens={r: res.tokens.tolist()
                        for r, res in results.items()})
        del eng
    return out if mesh.rank == 0 else None


def check_ep_drive(name, tp, policy, ref, g, whole_experts, arch, card):
    """Phase 11a's checks of one drive at ``tp`` against the tp = 1 sync
    drive; returns the row of its key numbers."""
    regime = "heads" if tp == 2 else "pages"
    label = f"{name} tp {tp} {policy} shard_params ({g['regime']!r})"
    if g["regime"] != regime:
        raise AssertionError(f"{label}: not the {regime!r} regime")
    worst = max(float(np.abs(row - ref["firsts"][rid]).max()
                      / np.abs(ref["firsts"][rid]).max())
                for rid, row in g["firsts"].items())
    if policy == "exact" and not worst <= 0.02:
        raise AssertionError(f"{label}: first-token logits differ by "
                             f"{worst:.3g} > 0.02 of the largest")
    want = {k: ref["launches"][k] for k in ("paged_decode",
                                            "paged_prefill")}
    expect = (ref["launches"] if regime == "heads"
              else dict.fromkeys(ref["launches"], 0))
    for rank, mine in enumerate(g["ranks"]):
        if mine["launches"] != expect:
            raise AssertionError(f"{label}: rank {rank} launched "
                                 f"{mine['launches']}, want {expect}")
        if tp == 2 and mine["experts"] * 2 != whole_experts:
            raise AssertionError(f"{label}: rank {rank} holds "
                                 f"{mine['experts']} B of experts, "
                                 f"not half of {whole_experts}")
    budget = decode_wire_budget(arch, regime, True)
    wire = max(m["decode_bytes"] for m in g["ranks"])
    if not wire <= budget:
        raise AssertionError(f"{label}: a decode step moved "
                             f"{wire:.0f} B a layer > {budget} B")
    spec = check_spec_bytes(label, g["ranks"])
    share, first = tp_agreement(ref, g)
    parting = ("no parting" if first is None else
               f"first parting: request {first[0]} decision "
               f"{first[1]}, tp = 1 top-2 margin {first[2]:.4g}")
    flips = [m["flips"] for m in g["ranks"]]
    wall = max(m["wall"] for m in g["ranks"])
    print(f"[ranks] {label}: first-token logits max|Δ|/max|logit| "
          f"{worst:.4g} ({'held within 0.02' if policy == 'exact' else 'printed'}); "
          f"greedy tokens equal to tp = 1 {share:.1%} ({parting}); "
          f"flipped routings replayed (rank: flipped of token "
          f"routings) {flips}; paged launches a rank "
          f"{[{k: m['launches'][k] for k in want} for m in g['ranks']]}"
          f" (tp = 1: {want}); experts a rank "
          f"{[m['experts'] for m in g['ranks']]} B of "
          f"{whole_experts}; decode wire {wire:.0f} B a layer "
          f"(budget {budget}); {spec}{g['n_tokens'] / wall:.1f} tok/s — a "
          f"shared-card gloo figure, not a speed — {card}")
    return dict(logits=worst, wire=wire, budget=budget, agree=share,
                flips=flips)


def phase_ranks_serving(card, device="cuda", archs=None,
                        layers=R_SERVE_LAYERS):
    """Phase 11a: DeepSeek-MoE-16B and Granite-MoE-3B at full width,
    ``layers`` layers, served at tp 2 ('heads') with ``shard_params``:
    each rank holds half the experts (32 of 64, 20 of 40), DeepSeek's
    shared MLP and both models' attention cut, on bf16 pools, the
    smoke's 8 requests with 16 new tokens, REXP and exact, each rank
    replaying the tp = 1 drive's expert choices; then the
    :data:`R_SERVE_PAGES` drives ('pages', Granite at tp 3) against the
    same tp = 1 drives."""
    from repro_torch.launch.mesh import start_ranks
    out = {}
    for name, arch in (archs or {n: ARCHS[n] for n in MOE_SHAPES}).items():
        arch = arch.with_layers(layers)
        t0 = time.perf_counter()
        model, params = _init_bf16(arch, device)
        reqs = [(p, R_NEW_TOKENS) for p, _ in make_requests(arch.vocab_size)]
        routes, refs = {}, {}
        for policy in R_POLICIES:
            routes[policy] = []
            refs[policy] = ep_reference(model, params, reqs, policy, device,
                                        routes[policy])
            routes[policy] = [r.cpu() for r in routes[policy]]
        whole_experts = _expert_bytes(params)
        del model, params
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        drives = [(2, R_POLICIES)] + ([R_SERVE_PAGES[name]]
                                      if name in R_SERVE_PAGES else [])
        for tp, policies in drives:
            t_tp = time.perf_counter()
            got = start_ranks(ep_rank, tp, backend="gloo", device=device,
                              args=(arch, reqs, routes, policies),
                              threads=0).join()
            print(f"[ranks] {name} tp {tp}: {tp} ranks on one card over "
                  f"gloo, {len(policies)} drives in "
                  f"{time.perf_counter() - t_tp:.1f}s (start-up and "
                  f"weights included)")
            for policy in policies:
                out[name, tp, policy] = check_ep_drive(
                    name, tp, policy, refs[policy], got[policy],
                    whole_experts, arch, card)
            for site in sorted({s for m in got[policies[-1]]["ranks"]
                                for s in m["sites"]}):
                print(f"[ranks]   {name} tp {tp} decode collective on the "
                      f"wire: {site}")
        print(f"[ranks] {name}: phase 11a {time.perf_counter() - t0:.1f}s "
              f"(inits, tp = 1 drives, rank start-up included) — {card}")
    return out


def _train_arch(arch=None):
    arch = arch or ARCHS["granite-moe-3b-a800m"]
    return arch.with_layers(R_TRAIN_LAYERS)


def _train_batches(arch):
    ds = SyntheticDataset(DataConfig(arch.vocab_size, R_SEQ, R_BATCH,
                                     seed=11))
    return [ds.batch(i) for i in range(R_STEPS + R_MORE)]


def _train_init(arch, device):
    model = build_model(arch)
    gen = torch.Generator(device=device).manual_seed(0)
    run = RunConfig(dtype="float32", learning_rate=R_LR)
    return model, run, TL.train_state(model.init(gen, device), run)


def train_rank(mesh, arch, batches, routes, out_dir):
    """One rank of phase 11b: the seeded f32 init, cut to this rank's
    shard; the step-0 gradients (gathered whole; rank 0 saves them to
    ``out_dir``) and ``R_STEPS`` sharded steps, each replaying the
    single-rank run's expert choices; then the gathered state saved
    through ``CheckpointManager`` (rank 0 writes).  Returns (rank 0) the
    losses, norms, each step's seconds, every rank's resident bytes and
    flipped routings, and a step's collective bytes by site."""
    model, run, whole = _train_init(arch, mesh.device)
    step = TL.make_train_step(model, run, mesh=mesh)
    layout = step.layout
    state = TL.shard_train_state(whole, layout)
    del whole
    batches = [{"tokens": torch.from_numpy(b).to(mesh.device)}
               for b in batches]
    flips = []
    it = iter(routes)
    with pinned_routes(replay=[r.to(mesh.device) for r in next(it)],
                       flips=flips):
        loss0, grads = TL.make_grad_fn(model, run, mesh)(state.params,
                                                         batches[0])
    grads = layout.gather(grads)
    if mesh.world_rank == 0:
        torch.save({p: g.cpu() for p, g in tree_flatten(grads)},
                   os.path.join(out_dir, "grads0.pt"))
    del grads
    losses, norms, secs = [], [], []
    by_site = None
    for i in range(R_STEPS):
        mesh.log.clear()
        _sync(mesh.device)
        t0 = time.perf_counter()
        with pinned_routes(replay=[r.to(mesh.device) for r in next(it)],
                           flips=flips):
            state, m = step(state, batches[i])
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        _sync(mesh.device)
        secs.append(time.perf_counter() - t0)
        by_site = by_site or mesh.log.by_site()

    def nbytes(tree):
        return sum(x.nbytes for _, x in tree_flatten(tree))
    flipped = torch.cat(flips)
    mine = dict(params=nbytes(state.params), m=nbytes(state.opt.m),
                v=nbytes(state.opt.v),
                flips=(int(flipped.sum()), flipped.numel()))
    ranks = [None] * (mesh.tp * mesh.data)
    torch.distributed.all_gather_object(ranks, mine)
    final = TL.gather_train_state(state, layout)
    CheckpointManager(out_dir).save(final, step=R_STEPS, mesh=mesh)
    return dict(loss0=float(loss0), losses=losses, norms=norms, secs=secs,
                ranks=ranks, by_site=by_site)


def phase_ranks_train(card, device="cuda", arch=None):
    """Phase 11b: Granite-MoE-3B at full width, 2 layers, f32: a
    single-rank run on this device and the sharded step on a (data 2,
    model 2) mesh of 4 ranks sharing it over gloo, from one seeded init;
    then the sharded run's checkpoint restored on one rank for 2 more
    steps against the uninterrupted single-rank run."""
    from repro_torch.launch.mesh import start_ranks
    t_phase = time.perf_counter()
    arch = _train_arch(arch)
    batches = _train_batches(arch)
    model, run, state = _train_init(arch, device)
    tb = [{"tokens": torch.from_numpy(b).to(device)} for b in batches]
    routes = []
    rec = []
    with pinned_routes(record=rec):
        loss0, grads0 = TL.make_grad_fn(model, run)(state.params, tb[0])
    routes.append([r.cpu() for r in rec])
    step = TL.make_train_step(model, run)
    losses, norms, secs = [], [], []
    for i in range(R_STEPS + R_MORE):
        rec = []
        _sync(device)
        t0 = time.perf_counter()
        with pinned_routes(record=rec):
            state, m = step(state, tb[i])
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        _sync(device)
        secs.append(time.perf_counter() - t0)
        routes.append([r.cpu() for r in rec])
    whole_bytes = sum(x.nbytes for _, x in tree_flatten(state.params))
    out_dir = tempfile.mkdtemp(prefix="smoke_ranks_")
    try:
        got = start_ranks(train_rank, backend="gloo", device=device,
                          axes=R_MESH, threads=0,
                          args=(arch, batches[:R_STEPS],
                                routes[:1 + R_STEPS], out_dir)).join()
        label = (f"granite-moe-3b-a800m x{arch.n_layers} layers f32, mesh "
                 f"(data {R_MESH['data']}, model {R_MESH['model']})")
        loss_off = max(abs(a - b) / abs(b) for a, b in zip(
            [got["loss0"]] + got["losses"], [float(loss0)] + losses))
        norm_off = abs(got["norms"][0] - norms[0]) / norms[0]
        grads = torch.load(os.path.join(out_dir, "grads0.pt"))
        grad_off = max((largest_off(grads[p], g), p)
                       for p, g in tree_flatten(grads0))
        if not loss_off <= R_LOSS_TOL:
            raise AssertionError(f"{label}: losses off by {loss_off:.3g}")
        if not norm_off <= R_NORM_TOL:
            raise AssertionError(f"{label}: global norm off by "
                                 f"{norm_off:.3g}")
        if not grad_off[0] <= R_GRAD_TOL:
            raise AssertionError(f"{label}: step-0 gradient {grad_off[1]} "
                                 f"off by {grad_off[0]:.3g} of its largest")
        del grads, grads0
        print(f"[ranks] {label}: {R_STEPS} steps on global batch "
              f"{R_BATCH} × {R_SEQ}: losses {got['losses']} (single rank "
              f"{losses[:R_STEPS]}), worst {loss_off:.3g} relative (held "
              f"within {R_LOSS_TOL}); step-0 gradients worst "
              f"{grad_off[0]:.3g} of the leaf's largest ({grad_off[1]}; "
              f"held within {R_GRAD_TOL}); global norm {got['norms'][0]:.6g} "
              f"vs {norms[0]:.6g} ({norm_off:.3g} relative, held within "
              f"{R_NORM_TOL}); flipped routings replayed (rank: flipped of "
              f"token routings) {[r['flips'] for r in got['ranks']]} — "
              f"{card}")
        print(f"[ranks] {label}: resident bytes a rank (params, m, v) "
              f"{[(r['params'], r['m'], r['v']) for r in got['ranks']]} of "
              f"{whole_bytes} each whole ("
              f"{max(r['params'] for r in got['ranks']) / whole_bytes:.3f} "
              f"at most); collective bytes of a step by site (rank 0) "
              f"{got['by_site']}; step seconds {[round(t, 4) for t in got['secs']]}"
              f" (gloo over the host, 4 ranks on one card: not a speed; "
              f"single rank {[round(t, 4) for t in secs[:R_STEPS]]}) — "
              f"{card}")
        # restore on one rank, 2 more steps, against the uninterrupted run
        _, _, like = _train_init(arch, device)
        restored, at = CheckpointManager(out_dir).restore_latest(like)
        del like
        if at != R_STEPS:
            raise AssertionError(f"restored step {at}, want {R_STEPS}")
        flips = []
        for i in range(R_STEPS, R_STEPS + R_MORE):
            with pinned_routes(replay=[r.to(device) for r in routes[1 + i]],
                               flips=flips):
                restored, _ = step(restored, tb[i])
        worst, adam_flips = params_off(restored.params, state.params,
                                       R_RESUME_TOL, R_LR, R_MORE,
                                       f"{label} resumed")
        flipped = torch.cat(flips)
        print(f"[ranks] {label}: saved whole at step {R_STEPS} (rank 0 "
              f"writes), restored on one rank, {R_MORE} more steps: params "
              f"within {worst:.3g} of each leaf's largest of the "
              f"uninterrupted single-rank run (held within {R_RESUME_TOL}; "
              f"{adam_flips} Adam flips; {int(flipped.sum())} of "
              f"{flipped.numel()} routings replayed flipped) — {card}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(f"[ranks] phase 11b: {time.perf_counter() - t_phase:.1f}s — "
          f"{card}")
    return dict(loss_off=loss_off, grad_off=grad_off[0], norm_off=norm_off,
                resume=worst)


def _pipe_setup(arch, device):
    from repro_torch.models import transformer as TF
    from repro_torch.runtime.pipeline import make_stage_fn
    model = build_model(arch)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen, device)
    run = RunConfig(dtype="float32")
    spec = arch.period[0]
    stage_fn = make_stage_fn(lambda pp, h: TF.apply_block(
        pp, h, arch, run, spec, policy=POLICIES["exact"], cache=None)[0], 1)
    gen = torch.Generator(device=device).manual_seed(1)
    mbs = torch.randn((R_MICRO, R_MB, R_MB_SEQ, arch.d_model),
                      generator=gen, device=device)
    return params, stage_fn, mbs


def _stage(params, i):
    """Stage ``i``'s slice of the period stack (a stack of one), requiring
    grad."""
    return tree_map(lambda a, _: a[i:i + 1].detach().clone()
                    .requires_grad_(True), params["periods"][0])


def pipe_rank(mesh, arch, out_dir):
    """One stage of phase 11c: its full-width layer through
    ``gpipe_forward``; saves the outputs (rank 0) and its gradients of
    ``Σ out²``, returns its seconds."""
    from repro_torch.runtime.pipeline import gpipe_forward
    params, stage_fn, mbs = _pipe_setup(arch, mesh.device)
    mine = _stage(params, mesh.pipe_rank)
    del params
    _sync(mesh.device)
    t0 = time.perf_counter()
    out = gpipe_forward(stage_fn, mine, mbs, mesh, axis="pipe")
    (out ** 2).sum().backward()
    _sync(mesh.device)
    wall = time.perf_counter() - t0
    torch.save({p: x.grad.cpu() for p, x in tree_flatten(mine)},
               os.path.join(out_dir, f"stage{mesh.pipe_rank}.pt"))
    if mesh.pipe_rank == 0:
        torch.save(out.detach().cpu(), os.path.join(out_dir, "out.pt"))
    return wall


def phase_ranks_pipeline(card, device="cuda", arch=None):
    """Phase 11c: GPipe over 2 stages sharing this device, each stage one
    full-width Granite-MoE layer, against the sequential run on one
    rank: outputs and stage gradients within 1e-6 of the largest
    entry (a stage's arithmetic is the sequential run's)."""
    from repro_torch.launch.mesh import start_ranks
    t_phase = time.perf_counter()
    arch = (arch or ARCHS["granite-moe-3b-a800m"]).with_layers(R_STAGES)
    out_dir = tempfile.mkdtemp(prefix="smoke_pipe_")
    try:
        wall = start_ranks(pipe_rank, backend="gloo", device=device,
                           axes={"pipe": R_STAGES}, threads=0,
                           args=(arch, out_dir)).join()
        params, stage_fn, mbs = _pipe_setup(arch, device)
        stages = [_stage(params, i) for i in range(R_STAGES)]
        del params
        outs = []
        for j in range(R_MICRO):
            h = mbs[j]
            for st in stages:
                h = stage_fn(st, h)
            outs.append(h)
        ref = torch.stack(outs)
        (ref ** 2).sum().backward()
        got = torch.load(os.path.join(out_dir, "out.pt"))
        worst_out = largest_off(got, ref)
        bitwise = torch.equal(got, ref.detach().cpu())
        worst_grad = (0.0, "")
        for i, st in enumerate(stages):
            g = torch.load(os.path.join(out_dir, f"stage{i}.pt"))
            for p, x in tree_flatten(st):
                off = largest_off(g[p], x.grad)
                bitwise &= torch.equal(g[p], x.grad.cpu())
                worst_grad = max(worst_grad, (off, f"stage {i} {p}"))
        if not (worst_out <= R_PIPE_TOL and worst_grad[0] <= R_PIPE_TOL):
            raise AssertionError(f"GPipe: outputs off by {worst_out:.3g}, "
                                 f"gradients by {worst_grad}")
        print(f"[ranks] GPipe {R_STAGES} stages × 1 full-width "
              f"{arch.name} layer, {R_MICRO} microbatches of {R_MB} × "
              f"{R_MB_SEQ}: outputs within {worst_out:.3g}, stage gradients "
              f"within {worst_grad[0]:.3g} of the largest entry of the "
              f"sequential run (held within {R_PIPE_TOL}; bitwise "
              f"{bitwise}); forward and backward {wall:.2f}s on rank 0 "
              f"(gloo, not a speed) — {card}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(f"[ranks] phase 11c: {time.perf_counter() - t_phase:.1f}s — "
          f"{card}")
    return dict(out=worst_out, grad=worst_grad[0], bitwise=bitwise)


# ---------------------------------------------------------------------------
# Phase 12: the reference's cells — the dry run and two cells on the card
# ---------------------------------------------------------------------------

#: the cells phase 12 builds for real, at one period
C_CELLS = (("qwen3-32b", "decode_32k"), ("jamba-v0.1-52b", "long_500k"))
C_PROBE = dict(probe=True, probe_periods=1,
               run_overrides={"attention_backend": "auto"})
#: the step's measured peak against the trace's estimate
C_MEM_TOL = 0.10
#: the peaked check: keys planted in every (sequence, KV head) of the
#: cell's cache, each at this share of the planted logit
C_PEAK_SHARES = (1.0, 0.98, 0.95, 0.9)
#: how far the planted logit lies above the random keys' (in their
#: standard deviations, then in logit units)
C_PEAK_SIGMAS, C_PEAK_ABOVE = 6.0, 16.0
#: the largest |value| of the plain output a peaked check must reach, in
#: LUT steps (its limit): a kernel that dropped σ·V would be that far off
C_PEAK_MIN_STEPS = 8


def dry_records(card):
    """Phase 12a: the dry-run records of the two cells at full depth on
    the 16×16 mesh and of Granite × train_4k on the 2×16×16 mesh, as
    ``launch/dryrun.py`` prints them."""
    from repro_torch.launch.dryrun import line, run_cell
    for arch, shape, multi_pod in (*((a, s, False) for a, s in C_CELLS),
                                   ("granite-moe-3b-a800m", "train_4k",
                                    True)):
        rec = run_cell(arch, shape, multi_pod)
        print(f"[cells] {line(rec)} — {card}")
        if rec["status"] != "ok":
            raise AssertionError(f"dry run of {arch} × {shape}: "
                                 f"{rec.get('traceback')}")


def cell_trace(arch, shape):
    """Phase 12a on the (data 1, model 1) mesh: the one-period cell and
    its trace (its FLOPs and peak are what 12b holds the card to)."""
    from repro_torch.launch import cells as CELLS
    from repro_torch.launch.mesh import make_fake_mesh
    cell = CELLS.build_cell(arch, shape, make_fake_mesh(1, 1), **C_PROBE)
    tr = CELLS.trace_cell(cell)
    print(f"[cells] dry run {arch} × {shape} one period on (data 1, model "
          f"1): {tr.flops:.6e} FLOPs, arguments "
          f"{tr.argument_bytes / 2**30:.3f} GiB, peak "
          f"{tr.peak_bytes / 2**30:.3f} GiB + workspaces "
          f"{(tr.live_bytes - tr.peak_bytes) / 2**20:.0f} MiB, "
          f"collectives {tr.collectives or 'none'}, trace "
          f"{tr.seconds:.2f}s")
    return cell, tr


def _real_cell_args(cell):
    """Seeded bf16 weights (drawn and cast block by block), the cache
    (and recurrent states) filled with seeded random values to
    ``max_len − 1`` positions, and the rank's tokens, on the card."""
    from repro_torch.launch.cells import _at_length
    from repro_torch.runtime import partitioning as PT
    model, run, shape = cell.model, cell.run, cell.shape
    b, s = shape.global_batch, shape.seq_len
    gen = torch.Generator(device="cuda").manual_seed(12)
    params = model.init(gen, "cuda", dtype=torch.bfloat16)

    def fill(x, name, recurrent):
        return torch.randn(x.shape, generator=gen, dtype=x.dtype,
                           device="cuda")

    state = _at_length(PT.map_cache(model.decode_state_struct(b, s, run),
                                    fill), s - 1)
    token = torch.randint(0, model.cfg.vocab_size, (b, 1), generator=gen,
                          device="cuda", dtype=torch.int32)
    return params, token, state


#: batch rows a plain-version call of phase 12 takes at once (the plain
#: version repeats K in f32 for every query head: Qwen3's whole decode
#: call would need 128 GiB)
C_PLAIN_ROWS = 8


def plain_rows(q, k, v, policy, kw):
    """The plain version of a dense call, C_PLAIN_ROWS batch rows at a
    time (each row's attention is its own), concatenated."""
    return torch.cat([
        ops.lut_attention(q[i:i + C_PLAIN_ROWS], k[i:i + C_PLAIN_ROWS],
                          v[i:i + C_PLAIN_ROWS], policy,
                          **{**kw, "backend": "naive"})
        for i in range(0, q.shape[0], C_PLAIN_ROWS)])


def sdpa_gqa_ms(q, k, v):
    """Exact attention by one library call on the same inputs, every key
    visible (a decode step at the cache's last position): the query
    heads share their KV head's rows (``enable_gqa``), nothing
    repeated."""
    return device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, enable_gqa=True))


def sigma_f64_gap(out, q, k, v, kv_len, pol):
    """The largest integer Σ of a REXP faithful dense call, and — where it
    passes 2^24, past which the plain version's f32 Σ is not exact — the
    gap max|out − ref| to the plain version with Σ summed in f64 (and
    σ·V carried in f64) over the first ``C_PLAIN_ROWS`` batch rows; None
    below."""
    tables = ops._tables_for(pol)

    def numerators(i):
        r = slice(i, i + C_PLAIN_ROWS)
        s = REF._logits(q[r], k[r], q.shape[-1] ** -0.5, True, kv_len)
        return LUT.rexp_exp_int(s, tables, axis=-1,
                                index_mode=pol.index_mode)

    smax = max(float(numerators(i).double().sum(-1).max())
               for i in range(0, q.shape[0], C_PLAIN_ROWS))
    if smax < 2**24:
        return None, smax
    e = numerators(0)
    ssum = e.double().sum(-1, keepdim=True)
    inv = LUT.inv_scale(tables.precision.qmax)
    ja = LUT._bin_index(ssum * inv, pol.index_mode, 0,
                        len(tables.lut_alpha) - 1)
    alpha = torch.as_tensor(tables.lut_alpha, dtype=torch.int64,
                            device=q.device)[ja]
    sigma = torch.round((e.long() * alpha).double() * inv) * inv
    b, h, lq, lk = sigma.shape
    kvh = k.shape[1]
    ref = torch.matmul(sigma.view(b, kvh, h // kvh * lq, lk),
                       v[:b].double())
    return (float((out[:b].double() - ref.view(b, h, lq, -1)).abs().max()),
            smax)


def plant_peaks(q, k, kv_len, gen):
    """Plant ``len(C_PEAK_SHARES)`` keys in every (sequence, KV head) of
    ``k``, in place, at seeded positions below ``kv_len``: each along the
    group's mean query direction u, scaled so that every query head's
    logit at the first planted key lies ``C_PEAK_ABOVE`` above
    ``C_PEAK_SIGMAS`` standard deviations of its logits at the random
    keys (σ = scale · |q_h|: k's rows are N(0, 1)).  Every other key's
    REXP numerator then rounds to 0, Σ/qmax is at most the planted keys'
    count — inside LUT_α, whose last bin's α is 0 — and the output mixes
    the planted keys' V by nonzero weights under every policy."""
    b, h, _, dh = q.shape
    kvh = k.shape[1]
    scale = dh ** -0.5
    qg = q[:, :, 0].float().view(b, kvh, h // kvh, dh)
    qn = qg.norm(dim=-1)
    u = (qg / qn[..., None]).sum(2)
    u = u / u.norm(dim=-1, keepdim=True)
    proj = (qg * u[:, :, None]).sum(-1)
    if not bool((proj > 0).all()):
        raise AssertionError("a query head points away from its group's "
                             "mean direction")
    t = ((C_PEAK_SIGMAS * scale * qn + C_PEAK_ABOVE)
         / (scale * proj)).amax(-1)
    n = len(C_PEAK_SHARES)
    pos = torch.stack([torch.randperm(kv_len, generator=gen,
                                      device=k.device)[:n]
                       for _ in range(b * kvh)]).view(b, kvh, n)
    shares = torch.tensor(C_PEAK_SHARES, device=k.device)
    rows = t[..., None, None] * shares[:, None] * u[:, :, None]
    k[torch.arange(b, device=k.device)[:, None, None],
      torch.arange(kvh, device=k.device)[None, :, None], pos] = rows.to(
        k.dtype)


def peaked_checks(arch, q, k, v, policy, kw, limit):
    """The dense kernel at the cell's shape on inputs whose output is not
    zero (:func:`plant_peaks`): faithful REXP (the call's mode), REXP's
    fused α form (no ``kv_len``: every key is valid) and 2D-LUT, each
    within one LUT step of the plain version, whose largest |value| must
    reach ``C_PEAK_MIN_STEPS`` steps.  Returns ``{mode: (max|err|,
    max|ref|)}``."""
    plant_peaks(q, k, kw["kv_len"], torch.Generator(
        device="cuda").manual_seed(25))
    res = {}
    for mode, pol, kv_len in (("rexp", policy, kw["kv_len"]),
                              ("rexp_fused", policy, None),
                              ("lut2d", POLICIES["lut2d-uint8"],
                               kw["kv_len"])):
        kwm = {**kw, "kv_len": kv_len}
        out = ops.lut_attention(q, k, v, pol, **kwm)
        ref = plain_rows(q, k, v, pol, kwm)
        err, top = float((out - ref).abs().max()), float(ref.abs().max())
        res[mode] = (err, top)
        print(f"[cells] {arch} dense call, planted keys, {mode}: max|err| "
              f"{err:.3g} (one LUT step {limit:.3g}), max|ref| {top:.3g} "
              f"(at least {C_PEAK_MIN_STEPS} steps)")
        if not (err <= limit and top >= C_PEAK_MIN_STEPS * limit):
            raise AssertionError(f"{arch} planted {mode}: max|err| {err}, "
                                 f"max|ref| {top}, limit {limit}")
        del out, ref
    return res


def cell_tensors(*trees):
    from repro_torch.launch.cells import _tensors
    return _tensors(trees)


def real_cell(cell, tr, card):
    """Phase 12b for one cell: its step (built on the (data 1, model 1)
    mesh, where a rank's step is the single-card step) once on the card
    on seeded weights and cache, held to the plain version, the trace's
    FLOPs and its memory estimate; the dense call timed.  Returns the
    kernel's row for the summary."""
    from torch.utils.flop_counter import FlopCounterMode
    t0 = time.perf_counter()
    arch, shape = cell.arch.name, cell.shape.name
    cfg, pol = cell.arch, cell.run.softmax_policy
    qmax = get_precision(pol.precision).qmax
    params, token, state = _real_cell_args(cell)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    calls = []

    def recorded(q, k, v, policy, **kw):
        out = ops.lut_attention(q, k, v, policy, **kw)
        calls.append((q, k, v, policy, kw, out))
        return out

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated() - sum(
        x.untyped_storage().nbytes() for x in cell_tensors(params, token,
                                                           state))
    torch.cuda.reset_peak_memory_stats()
    _zero_dense()
    LAYERS.lut_attention = recorded
    try:
        with FlopCounterMode(display=False) as fc:
            logits, _ = cell.fn(params, token, state)
        torch.cuda.synchronize()
    finally:
        LAYERS.lut_attention = ops.lut_attention
    peak = torch.cuda.max_memory_allocated() - base
    launches = sum(lut_attention_cuda.launches.values())
    n_attn = cfg.n_periods * sum(sp.mixer == "attn" for sp in cfg.period)
    if launches != n_attn or len(calls) != n_attn:
        raise AssertionError(f"{arch}: {launches} dense launches, "
                             f"{len(calls)} calls; {n_attn} attention "
                             f"layers")
    if not bool(torch.isfinite(logits).all()) or tuple(logits.shape) != (
            cell.shape.global_batch, 1, cfg.vocab_size):
        raise AssertionError(f"{arch}: logits {tuple(logits.shape)} not "
                             f"finite")
    # the dense launches are direct library calls, which FlopCounterMode
    # does not see: their dense_flops are added, as the fake trace's
    # operator counts them
    attn_flops = sum(dense_flops(c[0].shape, c[1].shape) for c in calls)
    flops = int(fc.get_total_flops()) + attn_flops
    if flops != tr.flops:
        raise AssertionError(f"{arch}: the step counted {flops} FLOPs, the "
                             f"trace {tr.flops}")
    off = abs(peak - tr.live_bytes) / tr.live_bytes
    print(f"[cells] {arch} × {shape} one period on the card: setup "
          f"{t_setup:.1f}s; {base / 2**20:.0f} MiB held before the cell "
          f"(not counted); {launches} dense launch(es) "
          f"{dict(lut_attention_cuda.route_launches)}; FLOPs {flops:.6e} "
          f"(dense_flops {attn_flops:.6e} of them; trace {tr.flops:.6e}); "
          f"peak {peak / 2**30:.3f} GiB against the "
          f"trace's {tr.live_bytes / 2**30:.3f} GiB ({off:.2%} off, held "
          f"within {C_MEM_TOL:.0%}) — {card}")
    if not off <= C_MEM_TOL:
        raise AssertionError(f"{arch}: peak {peak} vs estimate "
                             f"{tr.live_bytes}")
    q, k, v, policy, kw, out = calls[0]
    ref = plain_rows(q, k, v, policy, kw)
    err = float((out - ref).abs().max())
    top = float(ref.abs().max())
    zero_rows = float((ref.abs().amax(-1) == 0).float().mean())
    limit = 2.0 / qmax * float(v.float().abs().max())
    gap, smax = sigma_f64_gap(out, q, k, v, kw.get("kv_len"), policy)
    extra = (f"; Σ past 2^24: the kernel within {gap:.3g} of the plain "
             f"version with Σ in f64" if gap is not None else "")
    b, h, lq, dh = q.shape
    kvh, lk = k.shape[1], k.shape[2]
    kv_len = kw.get("kv_len")
    route = dense_route(q.dtype, dh, lq, qmax, "rexp")
    print(f"[cells] {arch} dense call q {tuple(q.shape)} k "
          f"{tuple(k.shape)} kv_len {kv_len} {route}: max|err| {err:.3g} "
          f"(one LUT step {limit:.3g}), max|ref| {top:.3g}, all-zero rows "
          f"{zero_rows:.2%} (σ = 0 where Σ/qmax reaches LUT_α's last bin, "
          f"α 0); largest integer Σ {smax:.0f}{extra}")
    if not err <= limit:
        raise AssertionError(f"{arch}: dense call off its plain version by "
                             f"{err} > {limit}")
    del logits, ref, state, params
    gc.collect()
    torch.cuda.empty_cache()
    b_ms, b_by = dense_bound(b, h, kvh, lq, lk, dh, q.dtype,
                             dense_pairs(lq, lk, True, kv_len))
    row = dict(route=route, launches=launches, max_abs_err=err,
               ms=device_ms(lambda: ops.lut_attention(q, k, v, policy,
                                                      **kw)),
               plain_ms=device_ms(lambda: plain_rows(q, k, v, policy, kw)),
               bound_ms=b_ms, bound_by=b_by, library_ms=None,
               sdpa_ms=sdpa_gqa_ms(q, k, v),
               sigma_max=smax, sigma_f64_gap=gap, flops=flops, peak=peak,
               estimate=tr.live_bytes)
    print(f"[time] lut_attention rexp bf16 {arch} × {shape} B={b} "
          f"H={h}/{kvh} Lq={lq} Lk={lk} kv_len={kv_len} Dh={dh} {route}: "
          f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms "
          f"({C_PLAIN_ROWS} rows a call), exact SDPA (GQA) "
          f"{row['sdpa_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
          f"{b_ms / row['ms']:.1%} of bound — {card}")
    if kv_len != lk or lq != 1:
        raise AssertionError(f"{arch}: the SDPA yardstick assumes every "
                             f"key visible, got kv_len {kv_len} of {lk}")
    row["peaked"] = peaked_checks(arch, q, k, v, policy, kw, limit)
    del q, k, v, out, calls
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_cells(card):
    """Phase 12 (lines ``[cells]``): the dry run of the reference's cells
    and two of them on the card (module docstring).  Returns the dense
    kernel's rows at the two cells' shapes."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    print(f"[cells] {card}")
    from repro_torch.launch.dryrun import HBM_PER_CARD
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[cells] the card's capacity {total} B ({total / 2**30:.4f} "
          f"GiB); the dry run's fits_hbm_80g limit {HBM_PER_CARD} B")
    if total < HBM_PER_CARD:
        raise AssertionError("the dry run's fits_hbm_80g limit exceeds the "
                             "card's capacity")
    traces = [cell_trace(*cell) for cell in C_CELLS]
    dry_records(card)
    print(f"[cells] phase 12a: {time.perf_counter() - t0:.1f}s")
    rows = {f"{cell.arch.name}-{cell.shape.name}": real_cell(cell, tr, card)
            for cell, tr in traces}
    print(f"[cells] phase 12: {time.perf_counter() - t0:.1f}s — {card}")
    return rows


#: phase 11d: Jamba-v0.1-52B at full width, one period, lockstep on a
#: (data 1, model 2) mesh against one rank: 4 prompts of 64 tokens, 8 new
#: tokens (the first from the prefill), REXP and exact in f32 — held —
#: and exact in bf16, the serving precision — printed: bf16 roundoff in
#: different summation orders moves the two drives apart by far more
#: than a fault of the cut's arithmetic in f32 would
J_MESH = {"data": 1, "model": 2}
J_RANK_BATCH, J_RANK_PROMPT, J_RANK_NEW = 4, 64, 8
J_DRIVES = ((MAIN_POLICY, "float32"), ("exact", "float32"),
            ("exact", "bfloat16"))
#: the f32 limits, of the largest logit, on the first token's (the
#: prefill's) and the last decode step's logits: about 100× the exact
#: readings and 5× REXP's (1.084e-05 and 9.517e-04 on the first token,
#: PR 26's card runs), whose uint8 tables turn a roundoff at a step's
#: edge into a step
J_LIMITS = {MAIN_POLICY: 5e-3, "exact": 1e-3}


def jamba_drive(model, params, prompt, policy, dtype, mesh=None):
    """The lockstep prefill of ``prompt`` and ``J_RANK_NEW − 1`` greedy
    decode steps under ``policy`` in ``dtype`` (on ``mesh``: the rank's
    cut of the weights and the state, every row on every rank): the
    first token's and the last step's logits (f32, on the host), the
    tokens and the last state."""
    from repro_torch.runtime.serve_loop import make_decode_step
    run = RunConfig(dtype=dtype, softmax_policy=POLICIES[policy])
    kw = dict(mesh=mesh, batch=prompt.shape[0]) if mesh is not None else {}
    prefill = make_prefill_step(model, run, J_RANK_PROMPT + J_RANK_NEW,
                                **kw)
    decode = make_decode_step(model, run, **kw)
    logits, state = prefill(params, prompt)
    first = logits[:, -1].float().cpu()
    toks = [logits[:, -1:].argmax(-1).to(torch.int32)]
    for _ in range(J_RANK_NEW - 1):
        logits, state = decode(params, toks[-1], state)
        toks.append(logits[:, -1:].argmax(-1).to(torch.int32))
    last = logits[:, -1].float().cpu()
    return first, last, torch.cat(toks, 1).cpu(), state


def reference_bytes(arch, mesh, params) -> int:
    """Bytes of every parameter leaf at the JAX package's shard shape on
    this rank (``param_pspec(path, shape, mesh, fsdp=True)``), in the
    dtype the rank holds it in."""
    from repro_torch.runtime import partitioning as PT
    held = dict(tree_flatten(params))
    return sum(int(np.prod(PT.local_shape(shape, PT.param_pspec(
        path, shape, mesh, fsdp=True), mesh))) * held[path].element_size()
        for path, shape in PT.full_shapes(arch).items())


def jamba_rank(mesh, arch, prompt, routes):
    """One rank of phase 11d: the seeded f32 init cut block by block to
    the serving layout (``Model.init(..., layout=)``: no more than one
    block whole; one rank at a time), then the lockstep drives of
    :func:`jamba_drive` on every row, replaying the single rank's expert
    choices.  Returns
    (rank 0) per drive (policy, dtype) the first token's and the last
    step's logits and the tokens, and every
    rank's resident parameter bytes beside the JAX package's shard
    shapes', its Mamba ``h`` bytes beside theirs, its collective bytes
    by site and its seconds."""
    from repro_torch.runtime.serve_loop import serving_layout
    model = build_model(arch)
    t0 = time.perf_counter()
    for r in range(mesh.world):
        if r == mesh.world_rank:
            params = model.init(
                torch.Generator(device=mesh.device).manual_seed(5),
                mesh.device, layout=serving_layout(model, mesh))
            _sync(mesh.device)
            if torch.device(mesh.device).type == "cuda":
                torch.cuda.empty_cache()
        torch.distributed.barrier()
    mine = dict(init=time.perf_counter() - t0,
                params=sum(x.nbytes for _, x in tree_flatten(params)),
                params_want=reference_bytes(arch, mesh, params))
    n_mamba = sum(s.mixer == "mamba" for s in arch.period) * arch.n_periods
    b, di = prompt.shape[0], SSM.EXPAND * arch.d_model
    mine["h_want"] = n_mamba * b * (di // mesh.tp) * SSM.D_STATE * 4
    out = {}
    for drive in J_DRIVES:
        flips = []
        mesh.log.clear()
        t0 = time.perf_counter()
        with pinned_routes(replay=[r.to(mesh.device)
                                   for r in routes[drive]], flips=flips):
            first, last, toks, state = jamba_drive(
                model, params, prompt.to(mesh.device), *drive, mesh)
        _sync(mesh.device)
        mine[drive] = dict(secs=time.perf_counter() - t0,
                           by_site=mesh.log.by_site(),
                           flips=int(torch.cat(flips).sum()))
        mine["h"] = sum(leaf.nbytes for name, leaf in state_leaves(state)
                        if name.endswith(" h"))
        out[drive] = dict(first=first, last=last, tokens=toks)
        del state
    ranks = [None] * mesh.world
    torch.distributed.all_gather_object(ranks, mine)
    return dict(out, ranks=ranks) if mesh.world_rank == 0 else None


def phase_ranks_jamba(card, device="cuda", arch=None):
    """Phase 11d: Jamba-v0.1-52B at full width, one period (13.3B
    parameters, f32), lockstep on a (data 1, model 2) mesh of 2 ranks
    sharing the card over gloo — channel-parallel Mamba with its state
    ``h`` cut, the norm scales stored cut and gathered before use, the
    experts cut, the heads cut — against a single-rank drive of the same
    seeded init and prompts, the ranks replaying its expert choices.  In
    f32 the first token's logits (the prefill) and the last decode
    step's (the conv tail and the cut ``h`` carried across steps) within
    :data:`J_LIMITS`, and the exact greedy tokens all equal; the bf16
    drive's figures printed; each rank's resident parameter and ``h``
    bytes equal to the JAX package's shard shapes'; the collective bytes
    by site printed."""
    from repro_torch.launch.mesh import start_ranks
    t_phase = time.perf_counter()
    arch = (arch or ARCHS["jamba-v0.1-52b"]).with_layers(1)
    model = build_model(arch)
    params = model.init(torch.Generator(device=device).manual_seed(5),
                        device)
    rng = np.random.default_rng(5)
    prompt = torch.as_tensor(rng.integers(0, arch.vocab_size, size=(
        J_RANK_BATCH, J_RANK_PROMPT)), dtype=torch.int32, device=device)
    refs, routes = {}, {}
    for drive in J_DRIVES:
        rec = []
        with pinned_routes(record=rec):
            refs[drive] = jamba_drive(model, params, prompt, *drive)[:3]
        routes[drive] = [r.cpu() for r in rec]
    del model, params
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    got = start_ranks(jamba_rank, backend="gloo", device=device,
                      axes=J_MESH, threads=0,
                      args=(arch, prompt.cpu(), routes)).join()
    label = (f"{arch.name} x{arch.n_layers} layers lockstep, mesh "
             f"(data {J_MESH['data']}, model {J_MESH['model']})")
    for rank, mine in enumerate(got["ranks"]):
        if mine["params"] != mine["params_want"]:
            raise AssertionError(f"{label}: rank {rank} holds "
                                 f"{mine['params']} B of parameters, the "
                                 f"JAX package's shards {mine['params_want']}")
        if mine["h"] != mine["h_want"]:
            raise AssertionError(f"{label}: rank {rank} holds {mine['h']} B "
                                 f"of Mamba h, the JAX package's shards "
                                 f"{mine['h_want']}")
    for drive in J_DRIVES:
        (first, last, toks), g = refs[drive], got[drive]
        policy, dtype = drive
        gaps = [float((g[k] - ref).abs().max() / ref.abs().max())
                for k, ref in (("first", first), ("last", last))]
        agree = float((g["tokens"] == toks).float().mean())
        # the last step's logits compare only where both drives fed the
        # same tokens: the exact drive's, which are held equal
        limit = J_LIMITS[policy] if dtype == "float32" else None
        exact = limit is not None and policy == "exact"
        if exact and agree != 1.0:
            raise AssertionError(f"{label} {policy} {dtype}: greedy tokens "
                                 f"equal {agree:.1%}, not all")
        if limit is not None and not max(gaps[:2 if exact else 1]) <= limit:
            raise AssertionError(f"{label} {policy} {dtype}: logits differ "
                                 f"by {gaps} (first token, last step) of "
                                 f"the largest, over {limit}")
        held = ("printed" if limit is None else
                f"both held within {limit}, every token held equal" if exact
                else f"first token held within {limit}")
        last_gap = (f"{gaps[1]:.4g}" if agree == 1.0 else
                    "not compared (the drives fed different tokens)")
        print(f"[ranks] {label} {policy} {dtype}: logits max|Δ|/max|logit| "
              f"first token {gaps[0]:.4g}, last step {last_gap} against "
              f"one rank ({held}); greedy tokens equal {agree:.1%}; flipped "
              f"routings replayed (rank: flipped) "
              f"{[m[drive]['flips'] for m in got['ranks']]}; collective "
              f"bytes of the drive by site (rank 0) "
              f"{got['ranks'][0][drive]['by_site']}; drive seconds "
              f"{[round(m[drive]['secs'], 2) for m in got['ranks']]} (gloo "
              f"over the host, 2 ranks on one card: not a speed) — {card}")
    print(f"[ranks] {label}: resident parameter bytes a rank "
          f"{[m['params'] for m in got['ranks']]} (the JAX package's shard "
          f"shapes: {[m['params_want'] for m in got['ranks']]}); Mamba h "
          f"bytes a rank {[m['h'] for m in got['ranks']]} (theirs "
          f"{[m['h_want'] for m in got['ranks']]}); init seconds a rank "
          f"{[round(m['init'], 1) for m in got['ranks']]} — {card}")
    print(f"[ranks] phase 11d: {time.perf_counter() - t_phase:.1f}s — "
          f"{card}")
    return got


def phase_ranks(card, device="cuda"):
    """Phase 11 (lines ``[ranks]``): the model across ranks — expert-
    parallel serving, the sharded train step with its checkpoint
    restored on another mesh, GPipe, and Jamba's lockstep serving on
    the reference's cut — each as rank processes sharing this card over
    gloo (one card: no NCCL)."""
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serving = phase_ranks_serving(card, device)
    train = phase_ranks_train(card, device)
    pipe = phase_ranks_pipeline(card, device)
    jamba = phase_ranks_jamba(card, device)
    print(f"[ranks] phase 11: {time.perf_counter() - t0:.1f}s — {card}")
    return dict(serving=serving, train=train, pipe=pipe, jamba=jamba)


#: phase 13: the torch examples, in the order of ROADMAP's queue
EXAMPLES = ("quickstart", "calibrate_luts", "serve_lut_softmax",
            "train_resilient")


def load_example(name: str):
    """``examples/<name>_torch.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", ROOT / "examples" / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples(card, device="cuda"):
    """Phase 13 (lines ``[examples]``): each torch example's
    ``main(device="cuda")`` in this process, its printed lines and the
    kernels it launched; quickstart's figures must equal its CPU run's,
    the others run to their end."""
    import contextlib
    import io
    t_phase = time.perf_counter()
    for name in EXAMPLES:
        mod = load_example(name)
        before = _all_launches()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            figures = mod.main(device=device)
        _sync(device)
        secs = time.perf_counter() - t0
        for line in buf.getvalue().splitlines():
            if line.strip():
                print(f"[examples] {name}: {line}")
        if name == "quickstart":
            with contextlib.redirect_stdout(io.StringIO()):
                cpu = mod.main(device="cpu")
            if figures != cpu:
                raise AssertionError(f"quickstart on the card {figures} is "
                                     f"not its CPU run's {cpu}")
            print(f"[examples] quickstart: the card's figures equal the "
                  f"CPU run's {cpu}")
        after = _all_launches()
        ran = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        print(f"[examples] {name}: {secs:.1f}s, kernel launches {ran} — "
              f"{card}")
    print(f"[examples] phase 13: {time.perf_counter() - t_phase:.1f}s — "
          f"{card}")


# ---------------------------------------------------------------------------
# Phase 14: the kernel guard's plans on the card, the step contracts
# ---------------------------------------------------------------------------

#: the split-key body's libraries (their ``<name>_attrs`` report an
#: instance), and the CTAs a multiprocessor each plan counts on: the
#: paged plan two for one-row-a-warp CTAs, one for heavier ones; the
#: dense split route at most kDensePerSm (3) on average
SPLIT_LIBS = ("paged_decode", "paged_prefill", "lut_attention")
#: the H100 SXM's multiprocessors (the guard's N_SMS)
N_SMS_H100 = 132


def guard_calls():
    """Every ``(library, plan ints)`` the kernel guard declares at its
    geometries (the reference's three and the shapes this script
    launches), and the paged sweep's grid (``sweep``: B 1–64 × kv_len
    1–8192, decode and a 16-row chunk, f32 / bf16 / int8 pools, both
    methods' tables, the engine's ``max_kv_len`` or none)."""
    from repro_torch.analysis import kernel_guard as KG
    calls = set()
    host_plan = build.host_plan

    def recording(name, ins):
        calls.add((name, tuple(int(x) for x in ins)))
        return host_plan(name, ins)
    build.host_plan = recording
    try:
        for geom in KG.GEOMETRIES.values():
            KG.kernel_registry(geom)
    finally:
        build.host_plan = host_plan
    tables = [KG.method_tables(m) for m in ("rexp", "lut2d")]
    for b in (1, 4, 16, 64):
        for kv in (1, 64, 512, 2048, 8192):
            mp = -(-kv // PS)
            for c, name in ((1, "paged_decode"), (CHUNK, "paged_prefill")):
                for dt, i8 in ((0, 0), (1, 0), (1, 1)):
                    for main, ar, ac in tables:
                        for live in (kv, 0):
                            calls.add((name, (dt, i8, b, H, KVH, c, DH,
                                              b * mp + 1, PS, mp, main, ar,
                                              ac, live, 0, N_SMS_H100)))
    return sorted(calls)


def phase_guard(card):
    """Phase 14: each CUDA library's ``<name>_plan`` against the host
    library's (``csrc/launch_plan.h`` built by the host compiler, what
    the kernel guard reads) at every call of :func:`guard_calls` —
    ``n_split``, ``rows_per_block``, ``cache_keys``, ``warp_split``,
    ``stages`` and shared memory, grid, cluster and threads equal — then
    each split-key instance those plans launch: its registers and local
    (spill) bytes a thread and the CTAs a multiprocessor holds at its
    plan's threads and shared memory
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) beside the CTAs
    the plan counts on; then the single-device step contracts
    (``analysis.contracts``) on the card, each step under
    ``set_sync_debug_mode("error")``: each must hold."""
    from repro_torch.analysis import contracts as CT
    t0 = time.perf_counter()
    calls = guard_calls()
    differ, instances = [], {}
    for name, ins in calls:
        mine = build.read_plan(build.load(name, f"{name}_plan"), ins)
        want = build.host_plan(name, ins)
        if mine != want:
            differ.append((name, ins, mine, want))
            continue
        split = name in SPLIT_LIBS and (name != "lut_attention"
                                        or ins[0] == 2)
        if not split or want is None:
            continue
        if name == "lut_attention":
            dt, i8, dh = ins[1], 0, ins[7]
            ctas = want["grid_x"] * want["grid_y"] * want["grid_z"]
            assumed = min(3, -(-ctas // N_SMS_H100))
        else:
            dt, i8, dh = ins[0], ins[1], ins[6]
            assumed = 2 if want["rpt"] == 1 else 1
        key = (name, ("f32", "bf16")[dt] + "/int8" * i8,
               "NV 1" if dh <= 128 else "NV 2", f"RPT {want['rpt']}")
        got = build.read_attrs(build.load(name, f"{name}_attrs"), ins)
        held = instances.setdefault(key, dict(got, assumed=assumed,
                                              smem=want["smem"],
                                              least=got["ctas_per_sm"]))
        if want["smem"] > held["smem"]:
            held.update(smem=want["smem"])
        held["least"] = min(held["least"], got["ctas_per_sm"])
    if differ:
        raise AssertionError(f"{len(differ)} of {len(calls)} plans differ "
                             f"between the CUDA and the host libraries, "
                             f"e.g. {differ[:3]}")
    print(f"[guard] {len(calls)} plans (the guard's geometries and the "
          f"paged sweep's grid): every CUDA library's plan equals the host "
          f"library's — {card}")
    for key, a in sorted(instances.items()):
        print(f"[guard] {' '.join(key)}: {a['registers']} registers, "
              f"{a['local_bytes']} B local (spill) a thread; "
              f"{a['least']} CTAs a multiprocessor at the largest plan's "
              f"{a['smem']} B (the plan counts on {a['assumed']})")
    results = CT.single_device_contracts("cuda")
    bad = [(r.spec.name, r.violations) for r in results if r.violations]
    if bad:
        raise AssertionError(f"step contracts on the card: {bad}")
    print(f"[guard] {len(results)} single-device step contracts hold on "
          f"the card ({', '.join(r.spec.name for r in results)}), each "
          f"step under set_sync_debug_mode('error')")
    print(f"[time] phase 14: {time.perf_counter() - t0:.1f}s")


def _all_launches() -> dict:
    """Every kernel wrapper's launch count, by kernel (and by mode)."""
    out = dict(paged_decode=paged_decode_attention.launches,
               paged_prefill=paged_prefill_attention.launches,
               paged_decode_int8=paged_decode_attention.int8_launches,
               paged_prefill_int8=paged_prefill_attention.int8_launches,
               lut_softmax_rexp=rexp_softmax_cuda.launches,
               lut_softmax_lut2d=lut2d_softmax_cuda.launches)
    out.update({f"lut_attention_{m}": n
                for m, n in lut_attention_cuda.launches.items()})
    out.update({f"flash_attention_{r}": n
                for r, n in flash_attention_cuda.launches.items()})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the plain versions are the reference: full f32 products, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_run = time.perf_counter()
    card = gpu_line()
    print(f"[device] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    phase_build()
    kernels = phase_kernels()
    model, params, requests = setup_model()
    launches, bf16_stats, sync_busy = phase_engine(model, params, requests)
    kernels.update(phase_kernels(int8=True))
    launches.update({k: v for k, v in phase_int8_engine(
        model, params, requests, bf16_stats).items() if k.endswith("int8")})
    phase_pipelined(model, params, requests, card, sync_busy)
    phase_tp(model, params, requests, card)
    del model, params
    torch.cuda.empty_cache()
    for arch, mine in phase_moe(card).items():
        for kernel, n in mine.items():
            kernels[f"paged_{kernel}"]["shapes"][arch]["launches"] = n
    dense_shapes = phase_ssm(card)
    kernels["lut_attention"] = phase_dense_kernel()
    kernels["lut_attention"]["shapes"] = dense_shapes
    launches["lut_attention"], dense_routes = phase_whisper()
    kernels["lut_attention"]["route_launches"] = dense_routes
    for phase in (phase_row_softmax, phase_flash):
        rows, counts = phase()
        kernels.update(rows)
        launches.update(counts)
    kernels["lut_attention"]["shapes"]["qwen3-32b-eval"] = phase_train(card)
    phase_ranks(card)
    kernels["lut_attention"]["shapes"].update(phase_cells(card))
    phase_examples(card)
    phase_guard(card)
    summary = {"kernels": [
        dict(name=name, route="cuda", source=f"src/repro_torch/csrc/{src}.cu",
             replaces=f"src/repro/kernels/{replaces}",
             launches=launches[name], **kernels[name])
        for name, src, replaces in (
            ("paged_decode", "paged_decode",
             "lut_attention/paged_decode.py:419"),
            ("paged_prefill", "paged_prefill",
             "lut_attention/paged_prefill.py:427"),
            ("paged_decode_int8", "paged_decode",
             "lut_attention/paged_decode.py:120"),
            ("paged_prefill_int8", "paged_prefill",
             "lut_attention/paged_prefill.py:118"),
            ("lut_attention", "lut_attention",
             "lut_attention/lut_attention.py:355"),
            ("lut_softmax_rexp", "lut_softmax",
             "lut_softmax/lut_softmax.py:128"),
            ("lut_softmax_lut2d", "lut_softmax",
             "lut_softmax/lut_softmax.py:128"),
            ("flash_attention", "flash_attention",
             "flash_attention/flash_attention.py:103"))]}
    print(f"[time] the whole run: {time.perf_counter() - t_run:.1f}s")
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
