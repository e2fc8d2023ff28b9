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
engine raises rather than carrying on on the CPU.  Sampling happens on
the host: greedy is argmax; ``temperature > 0`` draws from a
``torch.Generator`` seeded from ``(seed, position)``, so a sampled
stream replays exactly but is not the JAX package's threefry stream.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence as SeqOf

import numpy as np

from repro_torch.configs.base import RunConfig
from repro_torch.models.convert import tree_map
from repro_torch.models.model_zoo import Model, resolve_device
from repro_torch.runtime.paged_cache import (KV_DTYPES, PagedCacheConfig,
                                             decode_view, prefill_chunk_view,
                                             view_arrays)
from repro_torch.runtime.scheduler import Request, Scheduler, Sequence
from repro_torch.runtime.serve_loop import sample_row


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
    mesh: object = None              # tensor parallelism: not ported yet


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

    @property
    def tokens(self) -> int:
        """Generated (sampled) tokens: decode steps + first tokens."""
        return self.decode_tokens + self.first_tokens


class ServingEngine:
    """Fixed-capacity continuous-batching driver.

    Args:
      model/params/run: a decoder-only attention+MLP :class:`Model`, its
        parameter tree (moved to ``device`` as given — cast it with
        ``convert.cast_params`` to serve in bf16) and the run config.
      config: an :class:`EngineConfig` (``n_slots``, page-pool sizing,
        ``prefill_chunk`` and ``prefill_budget``, ``prefix_cache``).
      device: ``cuda`` (default) or ``cpu``.

    ``kv_dtype="int8"`` (in ``config`` or ``run``) stores the pool as
    int8 pages with f32 per-token × KV-head scales; K/V are quantized
    once, at scatter time, and the paged kernels dequantize in place.
    Tensor parallelism (``config.mesh``) raises ``NotImplementedError``.
    """

    def __init__(self, model: Model, params, run: RunConfig,
                 config: EngineConfig | None = None, *, device="cuda"):
        config = config if config is not None else EngineConfig()
        if config.mesh is not None:
            raise NotImplementedError("tensor-parallel serving (mesh) is not "
                                      "ported yet")
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
        self.device = resolve_device(device)
        self.config = config
        self.model = model
        self.params = tree_map(lambda t, _: t.to(self.device), params)
        self.run_cfg = run
        self.cache = cache
        self.n_slots = config.n_slots
        self.prefill_chunk = config.prefill_chunk
        self.prefill_budget = (config.prefill_budget
                               if config.prefill_budget is not None
                               else config.prefill_chunk)
        self.scheduler = Scheduler(cache, config.n_slots,
                                   prefix_cache=config.prefix_cache)
        self.pools = model.init_paged_pools(cache.n_pages, cache.page_size,
                                            run, self.device)
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

    # -- internals --------------------------------------------------------

    def _run_pending_copies(self) -> None:
        """Execute the scheduler's queued copy-on-write page copies: each
        duplicates one physical page in every pool leaf (axis 0 is the
        period stack, axis 1 the page id) — an int8 page's scales with
        it — bitwise, before any prefill chunk of this step writes into
        the duplicate."""
        if not self.scheduler.pending_copies:
            return
        copies, self.scheduler.pending_copies = \
            self.scheduler.pending_copies, []
        for src, dst in copies:
            for pool in self.pools:
                for leaf in pool.values():
                    leaf[:, dst] = leaf[:, src]
        self.scheduler.confirm_copies(copies)

    def _prefill_chunk_step(self, seq: Sequence, n: int) -> bool:
        """Push one prompt chunk into the pool; True if the request
        finished outright (single-token budgets / instant EOS)."""
        host = prefill_chunk_view(seq, n, self.prefill_chunk, self.cache)
        view = view_arrays(host, self.device)
        # the chunk's keys end at cache_lens + n, known here on the host
        logits = self.model.prefill_chunk_paged(
            self.params, view.tokens, self.pools, view.block_tables,
            view.cache_lens, view.chunk_lens, self.run_cfg,
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
        view = view_arrays(host, self.device)
        # every slot attends to its cached tokens and the one entering
        logits = self.model.decode_step_paged(
            self.params, view.tokens, self.pools, view.block_tables,
            view.lengths, self.run_cfg,
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
        emit = seq.generated[start:]
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
