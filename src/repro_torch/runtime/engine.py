"""Continuous-batching serving engine over the paged KV cache.

The counterpart of the JAX package's synchronous ``ServingEngine``
(``runtime/engine.py``).  Requests of different prompt lengths and
output budgets share one fixed-capacity decode batch: each step,
finished sequences leave, queued requests join, and every slot decodes
against its own block-table view of the shared page pool.

Prefill is chunked and paged (Sarathi-style): an admitted prompt is
walked in fixed-size chunks whose K/V are written straight into the page
pool through the sequence's block table, and a per-step token budget
interleaves prefill chunks with decode steps.  The attention softmax is
``run.softmax_policy`` (exact / REXP / 2D-LUT); both phases ship the
block tables to the paged dispatch (``run.paged_backend``), which on the
card launches the CUDA paged-decode and paged-prefill kernels.

The engine runs on ``device`` — ``cuda`` unless the caller passes
``device="cpu"`` (as the tests do); without a CUDA device a ``cuda``
engine raises rather than carrying on on the CPU.

Two engines share this machinery.  :class:`ServingEngine` copies each
step's logits to the host and samples there, waiting for the step.
:class:`PipelinedEngine` samples on the device and keeps up to
``pipeline_depth`` steps in flight, so the host plans step N+1 while the
card computes step N; only ``(n,)`` int32 tokens come back, through
pinned non-blocking copies and CUDA events.  Both sample with
``serve_loop.sample_tokens`` — greedy is the argmax; ``temperature > 0``
takes a Gumbel-max draw keyed by ``(seed, position)`` — so they give the
same tokens; a sampled stream replays exactly but is not the JAX
package's threefry stream.

Tensor parallelism (``EngineConfig.mesh``, a
``partitioning.Mesh``): every rank is a process with an engine of its
own over the same model, run and config.  Rank 0 owns the scheduler,
the prefix cache and the requests; each device program it runs — a
copy-on-write page copy, a prompt chunk, a decode step — it first sends
as a host plan (block tables, lengths, tokens, chunk spans,
``max_kv_len``, page copies, sampling metadata) to the other ranks,
whose :meth:`ServingEngine.follow` runs the same program, so the ranks
meet at the same collectives and never diverge; :meth:`close` sends the
stop.  Each rank's pools hold its share (its KV heads in the
``'heads'`` regime, a slab of the pages in ``'pages'``), the scheduler
interleaves page allocation across the slabs, and with
``shard_params`` each rank holds its cut of the weights as the JAX
package's serving spec ``param_pspec(fsdp=False)`` cuts every leaf
(``partitioning.Layout(..., fsdp=False)``: an MoE's experts by the 3-D
rows, the attention by its columns and rows, the stacked norm scales;
what a layer computes whole is gathered just before use, site
``tp_gather``).  The logits are the same on every
rank, so the pipelined engine's on-device sampling gives every rank the
same token, each into its own last-token buffer.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Sequence as SeqOf

import numpy as np
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models.convert import tree_map
from repro_torch.models.model_zoo import Model, resolve_device
from repro_torch.kernels.lut_attention.ops import paged_mesh_regime
from repro_torch.runtime import partitioning as PT
from repro_torch.runtime.paged_cache import (KV_DTYPES, PagedCacheConfig,
                                             decode_view, prefill_chunk_view,
                                             to_device, view_arrays)
from repro_torch.runtime.scheduler import (PENDING_TOKEN, Request, Scheduler,
                                           SeqState, Sequence)
from repro_torch.runtime.serve_loop import sample_row, sample_tokens


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Everything that shapes a :class:`ServingEngine`."""

    n_slots: int = 4                 # decode-batch capacity
    cache: PagedCacheConfig = PagedCacheConfig()
    prefill_chunk: int = 16          # prompt tokens per chunk program
    prefill_budget: int | None = None  # tokens per step (None → chunk)
    prefix_cache: bool = False       # copy-on-write prompt-prefix sharing
    #: KV page-pool storage: None inherits ``RunConfig.kv_dtype``; ``f32``
    #: pages in the run dtype, or ``int8`` pages with f32 row scales
    kv_dtype: str | None = None
    #: tensor-parallel serving: this rank's ``partitioning.Mesh``
    mesh: object = None
    #: with a mesh: this rank holds its cut of the weights
    #: (``partitioning.shard_params``) instead of all of them
    shard_params: bool = False
    #: :class:`PipelinedEngine` only — most device steps in flight before
    #: the host waits on a harvest (2: plan step N+1 while step N runs;
    #: 1: dispatch, harvest, dispatch, … with sampling still on-device)
    pipeline_depth: int = 2


class RequestHandle:
    """Ticket for one queued request: its id plus live accessors —
    ``done``, ``result()`` (drives the engine until this request
    finishes), ``ttft_s`` and ``prefix_hit_tokens``.  Hashes, compares
    and sorts as its integer id."""

    __slots__ = ("id", "_engine")

    def __init__(self, rid: int, engine: "ServingEngine"):
        self.id = rid
        self._engine = engine

    @property
    def done(self) -> bool:
        return self.id in self._engine._results

    def result(self) -> "GenerationResult":
        """Drive the engine until this request finishes; its result."""
        while not self.done:
            if not self._engine.has_work():
                raise RuntimeError(
                    f"request {self.id} cannot finish: engine has no work")
            self._engine.step()
        return self._engine._results[self.id]

    @property
    def ttft_s(self) -> float | None:
        """Enqueue → first token, wall clock (None until sampled)."""
        res = self._engine._results.get(self.id)
        if res is not None:
            return res.ttft_s
        return self._engine._ttft.get(self.id)

    @property
    def prefix_hit_tokens(self) -> int:
        """Prompt tokens this request served from shared pages."""
        res = self._engine._results.get(self.id)
        if res is not None:
            return res.prefix_hit_tokens
        seq = self._engine._seqs.get(self.id)
        return seq.prefix_hit_tokens if seq is not None else 0

    def __int__(self) -> int:
        return self.id

    __index__ = __int__

    def __hash__(self) -> int:
        return hash(self.id)

    def __eq__(self, other) -> bool:
        if isinstance(other, RequestHandle):
            return self.id == other.id
        if isinstance(other, int):
            return self.id == other
        return NotImplemented

    def __lt__(self, other) -> bool:
        if isinstance(other, (RequestHandle, int)):
            return self.id < int(other)
        return NotImplemented

    def __repr__(self) -> str:
        return f"RequestHandle(id={self.id}, done={self.done})"


@dataclasses.dataclass
class GenerationResult:
    request_id: int
    tokens: np.ndarray           # (n_generated,) int32
    finish_reason: str           # 'length' | 'eos'
    n_evictions: int
    ttft_s: float | None = None  # enqueue → first token (wall clock)
    prefix_hit_tokens: int = 0   # prompt tokens served from shared pages


@dataclasses.dataclass
class EngineStats:
    steps: int = 0               # decode steps executed
    prefill_steps: int = 0       # prefill-chunk steps (counted separately)
    prefills: int = 0            # prompts fully prefilled
    decode_tokens: int = 0       # useful tokens produced by decode steps
    first_tokens: int = 0        # first tokens, one per completed prefill
    prompt_tokens: int = 0       # prompt tokens pushed through chunks
    preemptions: int = 0
    prefix_hit_tokens: int = 0   # prompt tokens never re-prefilled
    pages_shared: int = 0        # trie pages mapped into block tables
    cow_copies: int = 0          # copy-on-write page duplications
    # longest wall-clock gap between consecutive decode-step completions
    max_decode_gap_s: float = 0.0
    wall_s: float = 0.0
    queue_depth_peak: int = 0    # max waiting-queue depth observed
    pool_bytes_per_layer: int = 0  # KV pool bytes of one layer (pages
                                   # plus, for int8, the scales)
    # pipelined-engine counters (all zero on the synchronous engine):
    speculative_wasted: int = 0  # dispatched slot-steps rolled back at EOS
    inflight_peak: int = 0       # max device steps simultaneously in flight
    harvest_wait_s: float = 0.0  # host time blocked fetching step tokens

    @property
    def tokens(self) -> int:
        """Generated (sampled) tokens: decode steps + first tokens."""
        return self.decode_tokens + self.first_tokens


class ServingEngine:
    """Fixed-capacity continuous-batching driver.

    Args:
      model/params/run: a decoder-only :class:`Model` of attention
        mixers with an MLP or MoE FFN (any other raises
        ``NotImplementedError``), its parameter tree (moved to ``device``
        as given — cast it with ``convert.cast_params`` to serve in
        bf16) and the run config.
      config: an :class:`EngineConfig` (``n_slots``, page-pool sizing,
        ``prefill_chunk`` and ``prefill_budget``, ``prefix_cache``,
        ``mesh`` and ``shard_params``).
      device: ``cuda`` (default) or ``cpu``; with a mesh the engine runs
        on the mesh's device, whose type ``device`` must name.

    ``kv_dtype="int8"`` (in ``config`` or ``run``) stores the pool as
    int8 pages with f32 per-token × KV-head scales; K/V are quantized
    once, at scatter time, and the paged kernels dequantize in place.

    With ``config.mesh`` (``tp > 1``) every rank builds this engine with
    the same arguments; rank 0 serves (``add_request``, ``step``,
    ``run``, then :meth:`close`), every other rank calls :meth:`follow`.
    ``shard_params`` cuts full weights to the rank's share (a tree
    already cut, as ``convert.params_from_jax(..., mesh=)`` gives it,
    passes as it is).
    """

    def __init__(self, model: Model, params, run: RunConfig,
                 config: EngineConfig | None = None, *, device="cuda"):
        config = config if config is not None else EngineConfig()
        model.check_paged("the paged serving engine")
        mesh = config.mesh
        if mesh is not None and not isinstance(mesh, PT.Mesh):
            raise TypeError(f"mesh must be a partitioning.Mesh "
                            f"(launch.mesh.make_serving_mesh), got "
                            f"{type(mesh).__name__}")
        if config.shard_params and mesh is None:
            raise ValueError("shard_params=True requires a mesh")
        if mesh is not None and torch.device(device).type != mesh.device.type:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        if config.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk {config.prefill_chunk} < 1")
        if config.prefill_budget is not None and config.prefill_budget < 1:
            raise ValueError(f"prefill_budget {config.prefill_budget} < 1")
        if config.kv_dtype is not None and config.kv_dtype != run.kv_dtype:
            run = dataclasses.replace(run, kv_dtype=config.kv_dtype)
        if run.kv_dtype not in KV_DTYPES:
            raise ValueError(f"unknown kv_dtype {run.kv_dtype!r}: expected "
                             f"one of {KV_DTYPES}")
        cache = config.cache
        # The integer Σ is accumulated in f32 (exact below 2^24), so rows
        # may carry at most max_lk = SIGMA_ACC_LIMIT // qmax keys.
        policy = run.softmax_policy
        if policy.impl != "exact":
            from repro_torch.core.precision import get_precision
            bound = get_precision(policy.precision).max_lk
            if cache.max_context > bound:
                raise ValueError(
                    f"cache max_context {cache.max_context} exceeds the "
                    f"integer-Σ overflow bound max_lk={bound} for "
                    f"{policy.impl}/{policy.precision}: qmax·Lk must stay "
                    f"under the f32-exact Σ limit; shrink max_pages_per_seq"
                    f"·page_size or pick a narrower table precision")
        self.device = resolve_device(mesh.device if mesh is not None
                                     else device)
        self.config = config
        self.model = model
        self.mesh = mesh
        self.tp = PT.mesh_model_tp(mesh)
        self.regime = paged_mesh_regime(mesh, model.cfg.n_kv_heads)
        # the serving weights' storage (the reference's serving spec,
        # param_pspec(fsdp=False)) and what each layer computes on
        self.layout = None
        if config.shard_params:
            self.layout = PT.Layout(model.cfg, mesh, fsdp=False,
                                    paged_layers=True)
            params = self.layout.cut(params)
        self.params = tree_map(lambda t, _: t.to(self.device), params)
        self.run_cfg = run
        self.cache = cache
        self.n_slots = config.n_slots
        self.prefill_chunk = config.prefill_chunk
        self.prefill_budget = (config.prefill_budget
                               if config.prefill_budget is not None
                               else config.prefill_chunk)
        self.scheduler = Scheduler(cache, config.n_slots, tp=self.tp,
                                   prefix_cache=config.prefix_cache)
        self.pools = model.init_paged_pools(cache.n_pages, cache.page_size,
                                            run, self.device, mesh=mesh)
        self._closed = False
        self.stats = EngineStats(pool_bytes_per_layer=sum(
            leaf[0].nbytes for leaf in self.pools[0].values()))
        self._results: dict[int, GenerationResult] = {}
        self._seqs: dict[int, Sequence] = {}
        self._t_added: dict[int, float] = {}
        self._ttft: dict[int, float] = {}
        self._on_token: dict[int, Callable[[int], None]] = {}
        self._n_streamed: dict[int, int] = {}
        self._last_decode_end: float | None = None
        self._next_id = 0

    # -- public API -------------------------------------------------------

    def add_request(self, prompt, max_new_tokens: int, *,
                    temperature: float = 0.0, seed: int = 0,
                    eos_id: int | None = None,
                    on_token: Callable[[int], None] | None = None,
                    ) -> RequestHandle:
        """Queue a request; returns its :class:`RequestHandle`.

        ``on_token`` streams: it is called once per generated token, in
        order.  Tokens re-generated after an eviction are not re-emitted.
        """
        rid = self._next_id
        self._next_id += 1
        self._seqs[rid] = self.scheduler.add(Request(
            id=rid, prompt=tuple(int(t) for t in np.asarray(prompt)),
            max_new_tokens=max_new_tokens, temperature=temperature,
            seed=seed, eos_id=eos_id))
        self._t_added[rid] = time.time()
        if on_token is not None:
            self._on_token[rid] = on_token
            self._n_streamed[rid] = 0
        self.stats.queue_depth_peak = max(self.stats.queue_depth_peak,
                                          len(self.scheduler.waiting))
        return RequestHandle(rid, self)

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def step(self) -> list[GenerationResult]:
        """Admit + COW page copies + budgeted prefill chunks + one
        decode step.  Returns requests finished this step."""
        finished: list[Sequence] = []
        while self.scheduler.try_admit() is not None:
            pass
        self._run_pending_copies()
        for seq, n in self.scheduler.plan_prefill(self.prefill_chunk,
                                                  self.prefill_budget):
            if self._prefill_chunk_step(seq, n):
                finished.append(seq)
        if self.scheduler.decode_slots():
            self.scheduler.grow_for_decode()
            decode = self.scheduler.decode_slots()  # eviction may shrink it
            if decode:
                finished.extend(self._decode_step(decode))
        self._sync_sched_stats()
        return [self._record(seq) for seq in finished]

    def run(self, requests: SeqOf[tuple] | None = None,
            ) -> dict[int, GenerationResult]:
        """Drive queued (plus optionally given) requests to completion.

        ``requests`` items are (prompt, max_new_tokens) pairs or dicts of
        :meth:`add_request` kwargs.
        """
        t0 = time.time()
        for r in requests or ():
            if isinstance(r, dict):
                self.add_request(**r)
            else:
                self.add_request(r[0], r[1])
        self._last_decode_end = None  # stall metric is per drive
        out: dict[int, GenerationResult] = {}
        while self.has_work():
            for res in self.step():
                out[res.request_id] = res
        self.stats.wall_s += time.time() - t0
        return out

    # -- tensor parallelism: the plans ------------------------------------

    def _launch(self, op: str, **plan):
        """Run device program ``op`` (``copy`` | ``chunk`` | ``decode``) of
        this step with its host ``plan``; under a mesh of ``tp > 1`` rank
        0 first sends the plan to the other ranks."""
        if self.tp > 1:
            if self.mesh.rank != 0:
                raise RuntimeError(f"rank {self.mesh.rank} runs rank 0's "
                                   f"plans: call follow(), not step()")
            if self._closed:
                raise RuntimeError("the engine was closed")
            PT.send_plan(self.mesh, (op, plan))
        with PT.mesh_scope(self.mesh, layout=self.layout):
            return getattr(self, "_op_" + op)(**plan)

    def follow(self) -> None:
        """Ranks other than 0: run rank 0's plans, in order, until it
        calls :meth:`close`."""
        if self.tp <= 1 or self.mesh.rank == 0:
            raise RuntimeError("only ranks other than 0 of a mesh follow")
        while True:
            op, plan = PT.recv_plan(self.mesh)
            if op == "stop":
                return
            with PT.mesh_scope(self.mesh, layout=self.layout):
                getattr(self, "_op_" + op)(**plan)

    def close(self) -> None:
        """Rank 0 of a mesh: send the stop that ends the other ranks'
        :meth:`follow`.  Nothing to do without a mesh."""
        if self.tp > 1 and self.mesh.rank == 0 and not self._closed:
            PT.send_plan(self.mesh, ("stop", {}))
            self._closed = True

    # -- internals --------------------------------------------------------

    def _run_pending_copies(self) -> None:
        """Execute the scheduler's queued copy-on-write page copies before
        any prefill chunk of this step writes into the duplicates."""
        if not self.scheduler.pending_copies:
            return
        copies, self.scheduler.pending_copies = \
            self.scheduler.pending_copies, []
        self._launch("copy", copies=copies)
        self.scheduler.confirm_copies(copies)

    def _op_copy(self, copies) -> None:
        """Duplicate each ``(src, dst)`` physical page in every pool leaf
        (axis 0 is the period stack, axis 1 the page id) — an int8 page's
        scales with it — bitwise.  In the ``'pages'`` regime a page whose
        copy lands on another rank's slab is sent there: one page of
        every layer per leaf, the only KV-shaped traffic of the mesh."""
        leaves = [leaf for pool in self.pools for leaf in pool.values()]
        if self.regime != "pages":
            for src, dst in copies:
                for leaf in leaves:
                    leaf[:, dst] = leaf[:, src]
            return
        lo, slab = PT.slab_of(self.mesh, leaves[0].shape[1])
        rank = self.mesh.rank
        for src, dst in copies:
            owner, to = PT.page_owner(src, slab), PT.page_owner(dst, slab)
            for leaf in leaves:
                if owner == to == rank:
                    leaf[:, dst - lo] = leaf[:, src - lo]
                elif owner == rank != to:
                    PT.send(leaf[:, src - lo], to, self.mesh, site="cow")
                elif to == rank != owner:
                    PT.recv_into(leaf[:, dst - lo], owner, self.mesh,
                                 site="cow")

    def _op_chunk(self, host, max_kv_len: int):
        """One prompt chunk through the model; its (1, 1, V) logits."""
        view = view_arrays(host, self.device)
        return self.model.prefill_chunk_paged(
            self.params, view.tokens, self.pools, view.block_tables,
            view.cache_lens, view.chunk_lens, self.run_cfg,
            max_kv_len=max_kv_len)

    def _op_decode(self, host, max_kv_len: int):
        """One decode step through the model; its (n_slots, 1, V) logits."""
        view = view_arrays(host, self.device)
        return self.model.decode_step_paged(
            self.params, view.tokens, self.pools, view.block_tables,
            view.lengths, self.run_cfg, max_kv_len=max_kv_len)

    def _prefill_chunk_step(self, seq: Sequence, n: int) -> bool:
        """Push one prompt chunk into the pool; True if the request
        finished outright (single-token budgets / instant EOS)."""
        host = prefill_chunk_view(seq, n, self.prefill_chunk, self.cache)
        # the chunk's keys end at cache_lens + n, known here on the host
        logits = self._launch("chunk", host=host,
                              max_kv_len=int(host.cache_lens[0]) + n)
        self.stats.prefill_steps += 1
        self.stats.prompt_tokens += n
        if not self.scheduler.on_prefill_chunk(seq, n):
            return False
        # prompt complete: the chunk's last-valid-position logits are the
        # whole-prompt logits — sample the first token right here
        self.stats.prefills += 1
        self.stats.first_tokens += 1
        tok = self._sample(seq, logits[0, 0].cpu().numpy())
        # stamp TTFT only now: the copy above waited for the device
        self._stamp_ttft(seq.request.id)
        done = self.scheduler.on_token(seq, tok)
        self._emit_new_tokens(seq)
        return done

    def _decode_step(self, running: dict[int, Sequence]) -> list[Sequence]:
        """One batched decode step over the running slots."""
        host = decode_view(running, self.n_slots, self.cache)
        # every slot attends to its cached tokens and the one entering
        logits = self._launch("decode", host=host,
                              max_kv_len=int(host.lengths.max()) + 1)
        logits = logits.cpu().numpy()  # (n_slots, 1, V); waits for the step
        now = time.time()
        if self._last_decode_end is not None:
            self.stats.max_decode_gap_s = max(
                self.stats.max_decode_gap_s, now - self._last_decode_end)
        self._last_decode_end = now
        self.stats.steps += 1
        finished = []
        for slot, seq in running.items():
            tok = self._sample(seq, logits[slot, 0])
            self.stats.decode_tokens += 1
            if self.scheduler.on_token(seq, tok):
                finished.append(seq)
            self._emit_new_tokens(seq)
        return finished

    def _sync_sched_stats(self) -> None:
        self.stats.preemptions = self.scheduler.n_preemptions
        self.stats.prefix_hit_tokens = self.scheduler.prefix_hit_tokens
        self.stats.pages_shared = self.scheduler.pages_shared
        self.stats.cow_copies = self.scheduler.cow_copies
        self.stats.queue_depth_peak = max(self.stats.queue_depth_peak,
                                          len(self.scheduler.waiting))

    def _stamp_ttft(self, rid: int) -> None:
        if rid in self._ttft:
            return
        assert rid in self._t_added, \
            f"request {rid} has no admission timestamp"
        self._ttft[rid] = time.time() - self._t_added[rid]

    def _emit_new_tokens(self, seq: Sequence) -> None:
        """Stream resolved tokens past the per-request watermark."""
        rid = seq.request.id
        cb = self._on_token.get(rid)
        if cb is None:
            return
        start = self._n_streamed.get(rid, 0)
        emit = []
        for tok in seq.generated[start:]:
            if tok == PENDING_TOKEN:
                break  # dispatched but not yet harvested
            emit.append(tok)
        # watermark BEFORE the callbacks: eviction replay regenerates
        # tokens [0, start) bit-identically, so they must not re-emit
        self._n_streamed[rid] = start + len(emit)
        for tok in emit:
            cb(tok)

    def _sample(self, seq: Sequence, logits_row: np.ndarray) -> int:
        req = seq.request
        return sample_row(logits_row, req.temperature, req.seed,
                          len(seq.generated))

    def _record(self, seq: Sequence) -> GenerationResult:
        rid = seq.request.id
        res = GenerationResult(
            request_id=rid,
            tokens=np.asarray(seq.generated, np.int32),
            finish_reason=seq.finish_reason or "length",
            n_evictions=seq.n_evictions,
            ttft_s=self._ttft.pop(rid, None),
            prefix_hit_tokens=seq.prefix_hit_tokens)
        self._t_added.pop(rid, None)
        self._seqs.pop(rid, None)
        self._on_token.pop(rid, None)
        self._n_streamed.pop(rid, None)
        self._results[rid] = res
        return res


@dataclasses.dataclass
class _InflightStep:
    """One dispatched-but-unharvested device step."""

    #: (n_slots,) decode / (1,) final chunk, int32 — on a CUDA engine a
    #: pinned host tensor that holds the tokens once ``ready`` has fired
    tokens: torch.Tensor
    #: (seq, index into ``tokens``, position in ``seq.generated`` this
    #: token resolves, ``seq.n_evictions`` at dispatch) — the epoch lets
    #: harvest drop tokens whose sequence was evicted after dispatch
    #: (replay regenerates them bit-identically).
    entries: list[tuple[Sequence, int, int, int]]
    kind: str                    # 'decode' | 'chunk'
    ready: object = None         # torch.cuda.Event after the copy (CUDA)


class PipelinedEngine(ServingEngine):
    """:class:`ServingEngine` with host scheduling overlapped onto device
    compute.

    Two changes, same token streams:

    * **On-device sampling.**  The decode step and a prompt's final chunk
      end in ``serve_loop.sample_tokens`` on the logits' device, so a
      step returns ``(n,)`` int32 tokens, never ``(n_slots, 1, V)``
      logits.  They come back through a pinned host tensor filled by a
      ``non_blocking`` copy, with a CUDA event recorded after it; the
      harvest waits on that event alone (``stats.harvest_wait_s``).
    * **One-step-ahead dispatch.**  Up to ``config.pipeline_depth``
      steps are in flight.  Step N+1 is planned and launched from step
      N's unfetched tokens, which live in a device ``(n_slots,)``
      last-token buffer: each decode's sampled tokens are the next
      decode's input, and a final chunk writes its token into its slot.
      The host marks speculated positions :data:`PENDING_TOKEN` and
      resolves them at harvest.  Block tables, lengths and sampling
      metadata go to the card by pinned non-blocking copies
      (``paged_cache.to_device``), and every paged call's
      ``max_kv_len`` comes from host counts, so a dispatch never waits
      for the device.

    The speculation rule: **length** finishes are known at dispatch and
    retire the slot at once; **EOS** shows one harvest later, so a
    sequence that hits EOS has dispatched at most one extra slot-step,
    which harvest rolls back (``stats.speculative_wasted``).  Eviction
    during speculation is handled by epoch tags: stale tokens are
    dropped and replay regenerates them.  The pools are updated in place;
    reusing a page across in-flight steps is safe because every kernel,
    copy-on-write copy and scatter runs in order on one stream, so step
    N+1's writes cannot overtake step N's reads.

    On the CPU the same code runs with synchronous copies and no events.
    """

    def __init__(self, model: Model, params, run: RunConfig,
                 config: EngineConfig | None = None, *, device="cuda"):
        super().__init__(model, params, run, config, device=device)
        if self.config.pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth {self.config.pipeline_depth} < 1")
        self.depth = self.config.pipeline_depth
        self._inflight: deque[_InflightStep] = deque()
        self._token_buf = torch.zeros((self.n_slots,), dtype=torch.int32,
                                      device=self.device)

    # -- step loop ---------------------------------------------------------

    def step(self) -> list[GenerationResult]:
        """Harvest until under the in-flight cap, dispatch one step's
        plan, and — when there was nothing to dispatch — drain one
        in-flight step so the loop always makes progress."""
        finished: list[Sequence] = []
        while len(self._inflight) >= self.depth:
            finished.extend(self._harvest())
        if not self._dispatch() and self._inflight:
            finished.extend(self._harvest())
        self._sync_sched_stats()
        return [self._record(seq) for seq in finished]

    def has_work(self) -> bool:
        return self.scheduler.has_work() or bool(self._inflight)

    # -- dispatch (plan one step ahead) ------------------------------------

    def _dispatch(self) -> bool:
        """Plan and launch one engine step's device work (admission, COW
        copies, budgeted prefill chunks, one decode batch) without
        waiting for any of it.  False when there was nothing to do."""
        dispatched = False
        while self.scheduler.try_admit() is not None:
            pass
        self._run_pending_copies()
        for seq, n in self.scheduler.plan_prefill(self.prefill_chunk,
                                                  self.prefill_budget):
            self._dispatch_chunk(seq, n)
            dispatched = True
        if self.scheduler.decode_slots():
            self.scheduler.grow_for_decode()
            decode = self.scheduler.decode_slots()  # eviction may shrink it
            if decode:
                self._dispatch_decode(decode)
                dispatched = True
        return dispatched

    def _sample_meta(self, seeds, positions, temps):
        """The sampling metadata on the device, by pinned copies."""
        return (to_device(np.asarray(seeds, np.int64), self.device),
                to_device(np.asarray(positions, np.int64), self.device),
                to_device(np.asarray(temps, np.float64), self.device))

    def _op_chunk(self, host, max_kv_len: int, first=None):
        """One prompt chunk; for a prompt's final chunk ``first`` is
        ``(slot, seed, temperature)``: its first token is sampled here —
        at position 0, even on re-admission after an eviction — and
        written into the slot's entry of the last-token buffer."""
        logits = super()._op_chunk(host, max_kv_len)
        if first is None:
            return None
        slot, seed, temperature = first
        greedy = temperature <= 0.0
        meta = ((None,) * 3 if greedy else
                self._sample_meta([seed], [0], [temperature]))
        toks = sample_tokens(logits, *meta, greedy=greedy)
        self._token_buf[slot] = toks[0]
        return toks

    def _op_decode(self, host, max_kv_len: int, meta=None):
        """One decode step from the last-token buffer, sampled on the
        device (``meta``: the ``(seeds, positions, temperatures)`` lists,
        None when every slot is greedy); the sampled batch becomes the
        buffer."""
        logits = self.model.decode_step_paged(
            self.params, self._token_buf[:, None], self.pools,
            to_device(host.block_tables, self.device),
            to_device(host.lengths, self.device), self.run_cfg,
            max_kv_len=max_kv_len)
        toks = sample_tokens(logits, *(self._sample_meta(*meta) if meta
                                       else (None,) * 3),
                             greedy=meta is None)
        # empty slots get garbage tokens, but their rows are dead (null
        # block table, zero length) and a re-admitted slot's final chunk
        # overwrites its entry before the slot decodes again
        self._token_buf = toks
        return toks

    def _dispatch_chunk(self, seq: Sequence, n: int) -> None:
        """Launch one prompt chunk; the final chunk samples the first
        token on the device and joins the in-flight queue."""
        host = prefill_chunk_view(seq, n, self.prefill_chunk, self.cache)
        req = seq.request
        first = ((seq.slot, req.seed, req.temperature)
                 if seq.prefilled + n == seq.prompt_len else None)
        toks = self._launch("chunk", host=host,
                            max_kv_len=int(host.cache_lens[0]) + n,
                            first=first)
        self.stats.prefill_steps += 1
        self.stats.prompt_tokens += n
        if not self.scheduler.on_prefill_chunk(seq, n):
            return
        # prompt complete (→ RUNNING, owns a slot)
        self.stats.prefills += 1
        self.stats.first_tokens += 1
        self._push_inflight(toks, [(seq, 0, 0, seq.n_evictions)], "chunk")
        self.scheduler.on_token_speculative(seq)

    def _dispatch_decode(self, running: dict[int, Sequence]) -> None:
        """Launch one batched decode step from the device-resident
        last-token buffer."""
        # the view is built BEFORE the speculative append: lengths count
        # only tokens whose K/V the pool holds (plus the input token,
        # written by this step) — exactly the sync math.  Its tokens
        # column (PENDING_TOKEN after a speculated step) stays here.
        host = decode_view(running, self.n_slots, self.cache)
        seeds = [0] * self.n_slots
        positions = [0] * self.n_slots
        temps = [0.0] * self.n_slots
        entries = []
        for slot, seq in running.items():
            req = seq.request
            seeds[slot] = req.seed
            positions[slot] = len(seq.generated)
            temps[slot] = req.temperature
            entries.append((seq, slot, len(seq.generated), seq.n_evictions))
        greedy = all(t <= 0.0 for t in temps)
        toks = self._launch("decode", host=host,
                            max_kv_len=int(host.lengths.max()) + 1,
                            meta=None if greedy else (seeds, positions,
                                                      temps))
        self.stats.steps += 1
        self.stats.decode_tokens += len(running)
        self._push_inflight(toks, entries, "decode")
        for seq in running.values():
            self.scheduler.on_token_speculative(seq)

    def _push_inflight(self, toks: torch.Tensor, entries, kind: str) -> None:
        """Queue the copy of ``toks`` to the host and an event after it;
        on the CPU the copy is made here (``toks`` may be the last-token
        buffer, which a final chunk rewrites in place)."""
        if toks.is_cuda:
            host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
            host.copy_(toks, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host, ready = toks.clone(), None
        self._inflight.append(_InflightStep(host, entries, kind, ready))
        self.stats.inflight_peak = max(self.stats.inflight_peak,
                                       len(self._inflight))

    # -- harvest (resolve one step late) -----------------------------------

    def _harvest(self) -> list[Sequence]:
        """Wait for the oldest in-flight step's tokens and resolve them.

        Returns sequences that finished AND have no pending positions
        left (ready to record)."""
        rec = self._inflight.popleft()
        t0 = time.time()
        if rec.ready is not None:
            rec.ready.synchronize()  # the one wait: this step's (n,) tokens
        host = rec.tokens.numpy()
        now = time.time()
        self.stats.harvest_wait_s += now - t0
        if rec.kind == "decode":
            # completion-to-completion stall metric, as in the sync path
            if self._last_decode_end is not None:
                self.stats.max_decode_gap_s = max(
                    self.stats.max_decode_gap_s,
                    now - self._last_decode_end)
            self._last_decode_end = now
        done: list[Sequence] = []
        for seq, bidx, idx, epoch in rec.entries:
            if seq.n_evictions != epoch:
                continue  # evicted after dispatch; replay regenerates it
            gen = seq.generated
            if idx >= len(gen) or gen[idx] != PENDING_TOKEN:
                continue  # rolled back by an earlier EOS resolution
            tok = int(host[bidx])
            gen[idx] = tok
            req = seq.request
            if idx == 0:
                self._stamp_ttft(req.id)
            if req.eos_id is not None and tok == req.eos_id:
                # EOS surfaced one step late: drop the speculated tail
                # (at most one slot-step per the dispatch rule)
                self.stats.speculative_wasted += len(gen) - (idx + 1)
                del gen[idx + 1:]
                if seq.state is not SeqState.FINISHED:
                    self.scheduler.finish(seq, "eos")
                else:
                    seq.finish_reason = "eos"  # length-cut was also EOS
            self._emit_new_tokens(seq)
            if (seq.state is SeqState.FINISHED
                    and PENDING_TOKEN not in gen):
                done.append(seq)
        return done
