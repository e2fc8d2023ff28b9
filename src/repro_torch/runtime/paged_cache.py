"""Host-side paged-KV bookkeeping for the continuous-batching engine.

The *device* side (pools, scatter-append, the paged-decode attention
kernel) lives in ``repro_torch.models`` / ``repro_torch.kernels.lut_attention``;
this module owns the host-side metadata — which physical pages are
free, which belong to which sequence — and assembles the device views
(block tables, per-slot lengths, entering tokens) the decode step
consumes.

Layout contract (shared with :class:`repro_torch.models.layers.PagedAttnCache`
and the CUDA kernels in ``csrc/paged_decode.cu`` / ``csrc/paged_prefill.cu``):

* each layer's pool is **page-major** ``(n_pages, page_size, KVH, Dh)``
  (:func:`pool_shape`) so one block-table entry addresses one contiguous
  page and the kernel can stream pages straight from HBM — no per-token
  indirection, no contiguous per-slot gather; with ``kv_dtype='int8'``
  the pages store int8 and a parallel f32 scale pool
  ``(n_pages, page_size, KVH)`` (:func:`scale_pool_shape`,
  :func:`pool_leaf_specs`) shares the page-major leading axis, so every
  page move (COW copy, 'pages'-regime sharding) moves page + scales
  atomically and the device views (:func:`view_arrays` is field-generic)
  need no new plumbing;
* physical page 0 is the reserved **null page** — never allocated, the
  target of every unused block-table entry, so inactive slots and
  padding writes land in garbage space by construction;
* a sequence of length L owns ``ceil(L / page_size)`` pages; pages are
  appended one at a time as decode crosses page boundaries and all
  returned to the free list when the sequence finishes or is evicted.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

NULL_PAGE = 0


def padded_n_pages(n_pages: int, tp: int) -> int:
    """Physical page count rounded up to a multiple of the TP degree.

    The 'pages' regime of the tensor-parallel paged dispatch shards the
    pool's page axis into ``tp`` equal slabs, so the device pool may be
    slightly larger than the allocator's view — the padding pages are
    simply never allocated.
    """
    if tp < 1:
        raise ValueError(f"tp {tp} < 1")
    return -(-n_pages // tp) * tp


def pool_shape(n_pages: int, page_size: int, n_kv_heads: int,
               head_dim: int, tp: int = 1) -> tuple[int, int, int, int]:
    """The kernel-facing page-major pool layout, per layer.

    Single source of truth for the device pool shape: the leading axis
    is the physical page id (what a block-table entry indexes), so a
    page's ``(page_size, KVH, Dh)`` tokens are contiguous — the unit the
    paged-decode kernel DMAs per grid step and the target the chunked
    prefill scatters each prompt token into through the block table.

    ``tp`` > 1 (tensor-parallel serving) rounds the page axis up to a
    multiple of the mesh's 'model' size so it splits into equal device
    slabs (:func:`padded_n_pages`); the head-sharded regime divides the
    KVH axis instead and needs no padding, but the rounding is harmless
    there, so callers pass the mesh's tp unconditionally.
    """
    return (padded_n_pages(n_pages, tp), page_size, n_kv_heads, head_dim)


#: the KV storage dtypes the pool contract admits (``RunConfig.kv_dtype``
#: / ``EngineConfig.kv_dtype`` / ``serve.py --kv-dtype``)
KV_DTYPES = ("f32", "int8")


def scale_pool_shape(n_pages: int, page_size: int, n_kv_heads: int,
                     tp: int = 1) -> tuple[int, int, int]:
    """Layout of a quantization-scale pool: one f32 scale per pool row.

    The int8 pool stores each ``(page, token, kv_head)`` row of
    :func:`pool_shape` as int8 over ``Dh`` with one f32 scale — i.e. the
    scale pool is the page pool minus its trailing head-dim axis.  Page
    granularity is what the COW copy and the sharded regimes move
    atomically (a page's scales live at the same leading index as the
    page itself); within a page scales are per token × KV head, which
    keeps the scatter a pure insert — appending a token never requants
    its neighbours, so engine and lockstep see identical values
    regardless of chunking or physical placement.
    """
    return (padded_n_pages(n_pages, tp), page_size, n_kv_heads)


def pool_leaf_specs(n_pages: int, page_size: int, n_kv_heads: int,
                    head_dim: int, *, kv_dtype: str = "f32",
                    page_dtype: str = "float32",
                    tp: int = 1) -> dict[str, tuple[tuple, str]]:
    """``leaf name → (shape, dtype)`` contract of one layer's pool pytree.

    Single source of truth for what ``init_paged_pools`` allocates and
    what the paged kernels expect: ``f32`` pools are the historical
    2-leaf ``{k_pages, v_pages}`` dict (dtype ``page_dtype``); ``int8``
    pools add ``{k_scales, v_scales}`` f32 leaves laid out by
    :func:`scale_pool_shape`.  Scales are zero-initialized — an
    unwritten row dequantizes to exact 0, mirroring the zero-initialized
    f32 pool.
    """
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype {kv_dtype!r} not in {KV_DTYPES}")
    pages = pool_shape(n_pages, page_size, n_kv_heads, head_dim, tp=tp)
    if kv_dtype == "f32":
        return {"k_pages": (pages, page_dtype),
                "v_pages": (pages, page_dtype)}
    scales = scale_pool_shape(n_pages, page_size, n_kv_heads, tp=tp)
    return {"k_pages": (pages, "int8"), "v_pages": (pages, "int8"),
            "k_scales": (scales, "float32"),
            "v_scales": (scales, "float32")}


class OutOfPagesError(RuntimeError):
    """The pool cannot satisfy an allocation (admission must wait)."""


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    """Sizing of the shared pool and of the per-slot block tables."""

    n_pages: int = 64           # physical pages incl. the null page
    page_size: int = 16         # tokens per page
    max_pages_per_seq: int = 8  # block-table width (max context / page_size)

    @property
    def max_context(self) -> int:
        return self.max_pages_per_seq * self.page_size

    @property
    def usable_pages(self) -> int:
        return self.n_pages - 1  # minus the null page

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)


class PageAllocator:
    """Refcounted FIFO free-list allocator over physical page ids
    [1, n_pages).

    FIFO (rather than LIFO) keeps page reuse order deterministic and
    maximally stale, which makes use-after-free bugs loud in tests.

    Every allocated page carries a reference count: :meth:`alloc` hands
    pages out at refcount 1, :meth:`share` adds a reader (prefix-cache
    sharing — the same physical page mapped into several block tables
    and/or held by the prefix trie), and :meth:`free` drops one
    reference, returning the page to its slab's FIFO only when the last
    reference dies.  Plain alloc/free pairs therefore behave exactly as
    before sharing existed.

    ``tp`` > 1 makes the free list one FIFO *per device slab* (the
    'pages' regime shards the pool's page axis into ``tp`` slabs of
    ``padded_n_pages / tp``) with a round-robin cursor across them:
    consecutive allocations land on different devices, so a sequence's
    keys — and with them the per-shard partial-reduction work — spread
    evenly over the mesh instead of piling onto slab 0, and because
    ``free()`` returns a page to its owning slab's FIFO the balance
    survives eviction/completion churn, not just the initial fill.
    Physical placement is semantically invisible (block-table
    permutation invariance), so this is purely a load-balance choice;
    it stays deterministic, and ``tp=1`` degenerates to the historical
    single-FIFO behavior exactly.
    """

    def __init__(self, n_pages: int, tp: int = 1):
        if n_pages < 2:
            raise ValueError("need at least 2 pages (one is the null page)")
        if tp < 1:
            raise ValueError(f"tp {tp} < 1")
        self.n_pages = n_pages
        self._slab = padded_n_pages(n_pages, tp) // tp
        self._free: list[deque[int]] = [deque() for _ in range(tp)]
        for p in range(1, n_pages):
            self._free[p // self._slab].append(p)
        self._cursor = 0
        self._ref: dict[int, int] = {}  # page -> live reference count

    @property
    def n_free(self) -> int:
        return sum(len(d) for d in self._free)

    def refcount(self, page: int) -> int:
        """Live references on ``page`` (0 when free / never allocated)."""
        return self._ref.get(page, 0)

    def alloc(self, n: int = 1) -> list[int]:
        """Take ``n`` pages at refcount 1, all-or-nothing.
        Raises OutOfPagesError."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > self.n_free:
            raise OutOfPagesError(
                f"need {n} pages, {self.n_free} free "
                f"(pool has {self.n_pages - 1} usable)")
        tp = len(self._free)
        pages: list[int] = []
        for _ in range(n):
            for k in range(tp):  # next non-empty slab from the cursor
                slab = (self._cursor + k) % tp
                if self._free[slab]:
                    pages.append(self._free[slab].popleft())
                    self._cursor = (slab + 1) % tp
                    break
        for pg in pages:
            self._ref[pg] = 1
        return pages

    def share(self, pages: list[int]) -> None:
        """Add one reference to each page (a new reader of its K/V).

        Sharing never copies — the caller is promising it will only
        *read* the page (writes go through copy-on-write: see
        ``Scheduler``/``PrefixCache``); every share must be balanced by
        one :meth:`free`.
        """
        for pg in pages:
            if pg not in self._ref:
                raise ValueError(f"cannot share unallocated page: {pg}")
            self._ref[pg] += 1

    def free(self, pages: list[int]) -> None:
        """Drop one reference per page; a page returns to its slab's
        FIFO only when its last reference dies."""
        for pg in pages:
            if pg == NULL_PAGE:
                raise ValueError("cannot free the null page")
            if pg not in self._ref:
                raise ValueError(f"double free / foreign page: {pg}")
            self._ref[pg] -= 1
            if self._ref[pg] == 0:
                del self._ref[pg]
                self._free[pg // self._slab].append(pg)


def block_table_row(pages: list[int], max_pages_per_seq: int) -> np.ndarray:
    """Block-table row for one sequence; unused entries → null page."""
    if len(pages) > max_pages_per_seq:
        raise ValueError(
            f"{len(pages)} pages exceed block-table width {max_pages_per_seq}")
    row = np.full((max_pages_per_seq,), NULL_PAGE, np.int32)
    row[:len(pages)] = pages
    return row


@dataclasses.dataclass(frozen=True)
class DecodeView:
    """Device-facing view of one decode step over the running slots.

    Exactly what ``decode_step_paged`` consumes — the engine ships these
    three arrays and the attention kernel walks the pool through them;
    no contiguous KV is ever assembled on either side.  Inactive slots
    keep all-null block tables, length 0 and token 0: their (masked)
    writes land on the null page by construction.
    """

    block_tables: np.ndarray  # (n_slots, max_pages_per_seq) int32
    lengths: np.ndarray       # (n_slots,) int32 — tokens already cached
    tokens: np.ndarray        # (n_slots, 1) int32 — token entering the cache


@dataclasses.dataclass(frozen=True)
class PrefillChunkView:
    """Device-facing view of one prompt chunk entering the pool.

    Exactly what ``prefill_chunk_paged`` consumes — fixed shapes
    ``(1, C)`` / ``(1, mp)`` regardless of prompt length, so one
    compiled chunk program serves every request.  ``tokens`` is
    zero-padded past ``chunk_lens``; the padded rows' K/V writes land
    on the null page and their attention rows are discarded.
    """

    tokens: np.ndarray        # (1, C) int32 — this chunk's prompt slice
    block_tables: np.ndarray  # (1, max_pages_per_seq) int32
    cache_lens: np.ndarray    # (1,) int32 — tokens already in the pool
    chunk_lens: np.ndarray    # (1,) int32 — valid tokens in this chunk


def prefill_chunk_view(seq: "object", n: int, chunk: int,
                       cache: PagedCacheConfig) -> PrefillChunkView:
    """Assemble the next-chunk device view for one prefilling sequence.

    ``seq`` is a scheduler ``Sequence`` (needs ``.request.prompt``,
    ``.prefilled`` and ``.pages``); ``n`` ≤ ``chunk`` is the number of
    prompt tokens this chunk carries (the last chunk of a prompt is
    usually partial).
    """
    if not 1 <= n <= chunk:
        raise ValueError(f"chunk carries {n} tokens, want 1..{chunk}")
    start = seq.prefilled
    tokens = np.zeros((1, chunk), np.int32)
    tokens[0, :n] = seq.request.prompt[start:start + n]
    return PrefillChunkView(
        tokens=tokens,
        block_tables=block_table_row(seq.pages,
                                     cache.max_pages_per_seq)[None],
        # lint: allow-host-sync — host scalars, no device wait
        cache_lens=np.asarray([start], np.int32),  # lint: allow-host-sync
        chunk_lens=np.asarray([n], np.int32))


def to_device(a: np.ndarray, device):
    """``a`` as a tensor on ``device`` without waiting for the copy.

    On a CUDA device the array is staged in pinned host memory and copied
    with ``non_blocking=True``: the copy is queued on the current stream
    and the host goes on at once (a copy from pageable memory would
    synchronise the stream).  PyTorch's caching host allocator keeps the
    pinned block from being reused until the copy has run, so the caller
    may drop or rewrite ``a`` straight away.  On the CPU it is the plain
    ``torch.as_tensor``.
    """
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return torch.as_tensor(a, device=device)
    return torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(
        device, non_blocking=True)


def view_arrays(view, device):
    """Device copy of a :class:`DecodeView` / :class:`PrefillChunkView`.

    Returns the same dataclass with every field as a tensor on
    ``device`` (each copied by :func:`to_device`, so building a view
    never waits for the device) — call sites keep addressing fields by
    name, no positional coupling.
    """
    return dataclasses.replace(
        view, **{f.name: to_device(getattr(view, f.name), device)
                 for f in dataclasses.fields(view)})


def decode_view(running: dict[int, "object"], n_slots: int,
                cache: PagedCacheConfig) -> DecodeView:
    """Assemble the decode-step device view from the scheduler's slot map.

    ``running`` maps slot → scheduler ``Sequence`` (needs ``.pages``,
    ``.total_tokens`` and ``.generated``).
    """
    bt = np.full((n_slots, cache.max_pages_per_seq), NULL_PAGE, np.int32)
    lengths = np.zeros((n_slots,), np.int32)
    tokens = np.zeros((n_slots, 1), np.int32)
    for slot, seq in running.items():
        bt[slot] = block_table_row(seq.pages, cache.max_pages_per_seq)
        lengths[slot] = seq.total_tokens - 1  # cached so far
        tokens[slot, 0] = seq.generated[-1]   # token entering the cache
    return DecodeView(block_tables=bt, lengths=lengths, tokens=tokens)
