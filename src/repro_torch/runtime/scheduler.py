"""Request scheduler for the continuous-batching serving engine.

Pure host-side state machine — no jax.  A request moves through

    WAITING ──admit──▶ PREFILLING ──last chunk──▶ RUNNING ──finish──▶ FINISHED
                 ▲          │                        │
                 └──────────┴────────evict───────────┘   (page-pool pressure)

Admission is FIFO with head-of-line blocking: the head request joins as
soon as a slot is free and its *prefill* pages fit.  An admitted
sequence prefills its prompt in fixed-size chunks interleaved with the
decode steps of the running slots (:meth:`Scheduler.plan_prefill`
budgets the chunk tokens per engine step, Sarathi-style), then joins
the decode batch; decode pages are appended on demand as it crosses
page boundaries.  When the pool cannot grow a running sequence, the
youngest slotted sequence (prefilling or running) is evicted — pages
freed, progress discarded, re-queued ahead of everything that arrived
after it.  Greedy decoding regenerates the same tokens on re-admission,
so eviction trades work for memory without changing output.
"""

from __future__ import annotations

import dataclasses
import enum
from collections import deque

import numpy as np

from repro_torch.runtime.paged_cache import (OutOfPagesError, PageAllocator,
                                       PagedCacheConfig)
from repro_torch.runtime.prefix_cache import PrefixCache

#: Placeholder the pipelined engine appends for a dispatched-but-unfetched
#: token (real token ids are ≥ 0).  Length accounting (page growth, the
#: max_new_tokens cut-off) treats it as real; the engine overwrites it with
#: the sampled id at harvest, or truncates it on a late EOS rollback.
PENDING_TOKEN = -1


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request (the engine's unit of admission)."""

    id: int
    prompt: tuple[int, ...]          # token ids, length ≥ 1
    max_new_tokens: int
    temperature: float = 0.0         # 0 → greedy
    seed: int = 0                    # sampling stream (temperature > 0)
    eos_id: int | None = None


class SeqState(enum.Enum):
    WAITING = "waiting"
    PREFILLING = "prefilling"
    RUNNING = "running"
    FINISHED = "finished"


@dataclasses.dataclass
class Sequence:
    """Scheduler-side state of one request."""

    request: Request
    state: SeqState = SeqState.WAITING
    slot: int | None = None
    pages: list[int] = dataclasses.field(default_factory=list)
    generated: list[int] = dataclasses.field(default_factory=list)
    arrival: int = -1                # add() order (re-queue priority)
    admitted_at: int = -1            # admission order (eviction priority)
    prefilled: int = 0               # prompt tokens already in the pool
    finish_reason: str | None = None
    n_evictions: int = 0
    prefix_hit_tokens: int = 0       # prompt tokens served from shared pages
    published_pages: int = 0         # prompt pages already offered to the trie

    @property
    def prompt_len(self) -> int:
        return len(self.request.prompt)

    @property
    def total_tokens(self) -> int:
        """Tokens the KV cache must hold before the next decode step."""
        return self.prompt_len + len(self.generated)


class Scheduler:
    """Admission queue + slot map + page accounting.

    ``tp`` > 1 (tensor-parallel serving) makes page allocation
    mesh-aware: the free list interleaves round-robin across the mesh's
    page slabs (see :class:`PageAllocator`), so in the page-sharded
    regime each device carries a balanced share of every sequence's
    keys.  Scheduling decisions are otherwise identical — physical page
    placement never changes output (permutation invariance).

    ``prefix_cache`` enables copy-on-write prompt sharing: admission
    matches the prompt's full-page prefixes against a
    :class:`PrefixCache` trie and maps hits straight into the block
    table (no prefill work), chunked prefill publishes each full prompt
    page back to the trie, and a prompt that is *entirely* resident
    copy-on-writes the last matched page so its final token — the one
    whose logits seed decoding — is recomputed into a privately-owned
    page (``pending_copies`` hands the device copy to the engine).
    Matching changes which physical pages a block table names and how
    much prefill runs, never the K/V bits a position holds, so tokens
    are identical to the no-sharing engine.
    """

    def __init__(self, cache: PagedCacheConfig, n_slots: int, tp: int = 1,
                 prefix_cache: bool = False):
        self.cache = cache
        self.n_slots = n_slots
        self.allocator = PageAllocator(cache.n_pages, tp=tp)
        self.prefix_cache = (PrefixCache(cache.page_size, self.allocator)
                             if prefix_cache else None)
        #: device page copies the engine must run before the next scatter:
        #: (src, dst) pairs, dst already in a block table, src kept alive by
        #: the match reference until :meth:`confirm_copies`.
        self.pending_copies: list[tuple[int, int]] = []
        self.waiting: deque[Sequence] = deque()
        self.running: dict[int, Sequence] = {}
        self._free_slots = list(range(n_slots - 1, -1, -1))  # pop() → slot 0 first
        self._admissions = 0
        self._arrivals = 0
        self.n_preemptions = 0
        self.prefix_hit_tokens = 0  # prompt tokens never re-prefilled
        self.pages_shared = 0       # trie pages mapped into block tables
        self.cow_copies = 0         # copy-on-write page duplications

    # -- queue ------------------------------------------------------------

    def add(self, request: Request) -> Sequence:
        if len(request.prompt) < 1:
            raise ValueError(f"request {request.id}: empty prompt")
        if request.max_new_tokens < 1:
            raise ValueError(f"request {request.id}: max_new_tokens < 1")
        need = request.max_new_tokens + len(request.prompt)
        if need > self.cache.max_context:
            raise ValueError(
                f"request {request.id}: prompt+max_new = {need} exceeds "
                f"max context {self.cache.max_context}")
        if self.cache.pages_for(need) > self.cache.usable_pages:
            raise ValueError(
                f"request {request.id}: needs {self.cache.pages_for(need)} "
                f"pages, pool has {self.cache.usable_pages}")
        seq = Sequence(request=request, arrival=self._arrivals)
        self._arrivals += 1
        self.waiting.append(seq)
        return seq

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # -- admission (join) -------------------------------------------------

    def _alloc(self, n: int) -> list[int]:
        """Allocate ``n`` fresh pages, reclaiming dead prefix-cache
        leaves (LRU) first when the free list alone cannot cover it."""
        if (self.prefix_cache is not None
                and n > self.allocator.n_free):
            self.prefix_cache.reclaim(n - self.allocator.n_free)
        return self.allocator.alloc(n)

    def try_admit(self) -> Sequence | None:
        """Admit the head request if a slot and its prefill pages fit.

        With the prefix cache on, the prompt's resident full-page
        prefixes are mapped in as shared pages and only the remainder is
        allocated fresh; ``seq.prefilled`` starts past the hit so
        chunked prefill walks only the divergent tail.  A fully-resident
        prompt is capped at ``prompt_len - 1`` hit tokens: the final
        token must be recomputed (its logits seed decoding), and since
        it would land mid-way into a *shared* page, that page is
        copy-on-written — a fresh page plus a queued device copy — so
        the scatter never touches a page another reader maps.

        The admitted sequence enters PREFILLING: it owns a slot and its
        prompt pages, but joins the decode batch only once
        :meth:`on_prefill_chunk` has walked the whole prompt.
        """
        if not self.waiting or not self._free_slots:
            return None
        seq = self.waiting[0]
        ps = self.cache.page_size
        matched: list[int] = []
        if self.prefix_cache is not None:
            matched = self.prefix_cache.match(seq.request.prompt)
        hit = len(matched) * ps
        cow = hit >= seq.prompt_len  # whole prompt resident → COW last page
        if cow:
            hit = seq.prompt_len - 1
        need = (self.cache.pages_for(seq.prompt_len) - len(matched)
                + (1 if cow else 0))
        try:
            fresh = self._alloc(need)
        except OutOfPagesError:
            if matched:
                self.allocator.free(matched)  # drop the match references
            return None  # head-of-line blocking until pages free up
        if cow:
            # matched[-1] stays shared; its match reference now backs the
            # pending device copy (freed in confirm_copies / cancel).
            self.pending_copies.append((matched[-1], fresh[0]))
            seq.pages = matched[:-1] + fresh
            self.cow_copies += 1
            self.pages_shared += len(matched) - 1
        else:
            seq.pages = matched + fresh
            self.pages_shared += len(matched)
        seq.prefilled = hit
        seq.prefix_hit_tokens += hit
        self.prefix_hit_tokens += hit
        seq.published_pages = len(matched)
        self.waiting.popleft()
        seq.slot = self._free_slots.pop()
        seq.state = SeqState.PREFILLING
        seq.admitted_at = self._admissions
        self._admissions += 1
        self.running[seq.slot] = seq
        return seq

    def confirm_copies(self, copies: list[tuple[int, int]]) -> None:
        """The engine ran these (src, dst) device copies: release the
        match reference that kept each src page alive."""
        self.allocator.free([src for src, _ in copies])

    # -- chunked prefill (Sarathi-style interleaving) ----------------------

    def prefilling(self) -> list[Sequence]:
        """Slotted sequences still walking their prompt, admission order."""
        return sorted((s for s in self.running.values()
                       if s.state is SeqState.PREFILLING),
                      key=lambda s: s.admitted_at)

    def decode_slots(self) -> dict[int, Sequence]:
        """slot → sequence for the decode batch (RUNNING only)."""
        return {slot: s for slot, s in self.running.items()
                if s.state is SeqState.RUNNING}

    def plan_prefill(self, chunk: int, budget: int
                     ) -> list[tuple[Sequence, int]]:
        """Chunk assignments for one engine step under a token budget.

        Admission-ordered prefilling sequences receive chunks of up to
        ``chunk`` prompt tokens until ``budget`` tokens are planned; at
        least one chunk is always planned when anything is prefilling,
        so prefill cannot starve.  The budget is what keeps a long
        prompt from head-of-line-stalling the decode slots: the engine
        runs this plan, then a decode step, every step.
        """
        if chunk < 1:
            raise ValueError(f"prefill chunk {chunk} < 1")
        plan: list[tuple[Sequence, int]] = []
        remaining = budget
        for seq in self.prefilling():
            done = seq.prefilled
            while done < seq.prompt_len and (remaining > 0 or not plan):
                n = min(chunk, seq.prompt_len - done)
                plan.append((seq, n))
                done += n
                remaining -= n
            if remaining <= 0 and plan:
                break
        return plan

    def on_prefill_chunk(self, seq: Sequence, n: int) -> bool:
        """Record ``n`` prompt tokens entering the pool; True when the
        prompt is complete (the sequence then joins the decode batch)."""
        if seq.state is not SeqState.PREFILLING:
            raise ValueError(f"request {seq.request.id} is not prefilling")
        seq.prefilled += n
        if seq.prefilled > seq.prompt_len:
            raise ValueError(
                f"request {seq.request.id}: prefilled {seq.prefilled} past "
                f"prompt length {seq.prompt_len}")
        if self.prefix_cache is not None:
            # Publish each prompt page the moment its last token is in the
            # pool: the page is full, its owner never writes it again
            # (decode appends into fresh pages), so it is safe to share.
            ps = self.cache.page_size
            for j in range(seq.published_pages, seq.prefilled // ps):
                self.prefix_cache.insert(seq.request.prompt, j, seq.pages[j])
                seq.published_pages = j + 1
        if seq.prefilled == seq.prompt_len:
            seq.state = SeqState.RUNNING
            return True
        return False

    # -- decode-time page growth (with eviction) --------------------------

    def grow_for_decode(self) -> tuple[list[Sequence], list[Sequence]]:
        """Ensure every running sequence owns pages for its next write.

        Returns (grown, evicted).  Grows oldest-first; on pool pressure
        the *youngest* running sequence is evicted — possibly the very
        one being grown.  A younger sequence never steals pages from an
        older one, so the oldest admission progresses monotonically and
        the engine cannot livelock even when the aggregate working set
        exceeds the pool.  (The per-request bound in :meth:`add`
        guarantees a sequence running alone can always grow: with the
        prefix cache on, every trie page *not* reclaimable as a dead
        leaf is pinned by some slotted sequence's own reference, so
        free + reclaimable still covers the pool minus the slotted
        working set.)
        """
        grown: list[Sequence] = []
        evicted: list[Sequence] = []
        for seq in sorted(self.running.values(), key=lambda s: s.admitted_at):
            if seq.state is not SeqState.RUNNING:
                continue  # prefilling, or evicted while growing an older seq
            need = self.cache.pages_for(seq.total_tokens) - len(seq.pages)
            while need > 0 and seq.state is SeqState.RUNNING:
                try:
                    seq.pages.extend(self._alloc(need))
                    grown.append(seq)
                    need = 0
                except OutOfPagesError:
                    victim = max(
                        (s for s in self.running.values()
                         if s.state in (SeqState.RUNNING,
                                        SeqState.PREFILLING)),
                        key=lambda s: s.admitted_at)
                    self._evict(victim)
                    evicted.append(victim)
        return grown, evicted

    def _evict(self, seq: Sequence) -> None:
        """Free a slotted sequence and re-queue it in arrival order.

        Re-queue position is by ``arrival`` (add() order), NOT a bare
        ``appendleft``: with several evictions in one
        :meth:`grow_for_decode` pass, head-pushes would re-enter the
        victims in reverse eviction order and let a later arrival jump
        an earlier one — admission must stay FIFO in arrival order no
        matter how many victims one pass produces.

        With the prefix cache on, freeing drops one *reference* per
        page: pages the trie (or another sequence) still holds survive
        — the victim's prefill work stays warm for its re-admission —
        and a not-yet-executed copy-on-write whose destination dies
        here is cancelled before the engine could copy into a page
        about to be re-allocated.
        """
        if self.pending_copies:
            doomed = set(seq.pages)
            kept, cancelled = [], []
            for src, dst in self.pending_copies:
                (cancelled if dst in doomed else kept).append((src, dst))
            self.pending_copies = kept
            self.allocator.free([src for src, _ in cancelled])
        self.allocator.free(seq.pages)
        self.running.pop(seq.slot)
        self._free_slots.append(seq.slot)
        seq.pages = []
        seq.generated = []
        seq.prefilled = 0
        seq.published_pages = 0
        seq.slot = None
        seq.state = SeqState.WAITING
        seq.n_evictions += 1
        self.n_preemptions += 1
        pos = 0
        for pos, w in enumerate(self.waiting):  # noqa: B007
            if w.arrival > seq.arrival:
                break
        else:
            pos = len(self.waiting)
        self.waiting.insert(pos, seq)

    # -- completion (exit) ------------------------------------------------

    def on_token(self, seq: Sequence, token: int) -> bool:
        """Record a sampled token; finish + free if the request is done."""
        seq.generated.append(token)
        req = seq.request
        done = (len(seq.generated) >= req.max_new_tokens
                or (req.eos_id is not None and token == req.eos_id))
        if done:
            self.finish(seq, "eos" if req.eos_id is not None
                        and token == req.eos_id else "length")
        return done

    def finish(self, seq: Sequence, reason: str) -> None:
        """Retire a sequence: free its pages, release its slot."""
        seq.finish_reason = reason
        self.allocator.free(seq.pages)
        seq.pages = []
        if seq.slot is not None:
            self.running.pop(seq.slot)
            self._free_slots.append(seq.slot)
            seq.slot = None
        seq.state = SeqState.FINISHED

    def on_token_speculative(self, seq: Sequence) -> bool:
        """Record a dispatched-but-unfetched token as :data:`PENDING_TOKEN`.

        The pipelined engine calls this at *dispatch* time, before the
        sampled id has crossed back to the host.  Length-based finishes
        are decided here — ``len(generated)`` is known without the token
        value, so the slot and pages are released immediately and the
        next dispatch can reuse them (pool-array threading through the
        jitted steps orders the reuse after the in-flight read).  EOS
        can only be detected at harvest, one step late: the engine then
        truncates the speculated tail and calls :meth:`finish` itself.
        Returns True when the sequence finished (by length) here.
        """
        seq.generated.append(PENDING_TOKEN)
        if len(seq.generated) >= seq.request.max_new_tokens:
            self.finish(seq, "length")
            return True
        return False
