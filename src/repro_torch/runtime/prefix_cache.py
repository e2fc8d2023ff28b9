"""Radix-trie prefix index: full-page prompt prefixes → physical pages.

The index that makes KV sharing possible: a prompt's K/V content at
page ``j`` is a bitwise-deterministic function of tokens
``0 .. (j+1)*page_size - 1`` alone — independent of chunk boundaries
(the chunk-reassembly parity tests pin this) and of physical placement
(block-table permutation invariance) — so two prompts that agree on a
full page of tokens can *read the same physical page*.  The trie maps
each full-page token prefix a prompt has ever written to the page that
holds it; :meth:`PrefixCache.match` walks an incoming prompt down the
trie and hands back the longest chain of already-resident pages, which
the scheduler maps straight into the new sequence's block table with
zero prefill work.

Only *full* pages are indexed: a partially-filled page is still being
appended to by its owner, so sharing it would alias live writes.  The
divergence point of a new prompt therefore always lands either in a
fresh page (tail diverges past the matched pages) or — when the whole
prompt is already resident — in a copy-on-write duplicate the scheduler
makes of the last matched page (see ``Scheduler.try_admit``).

Reference discipline (see :class:`~.paged_cache.PageAllocator`):

* the trie itself holds **one** reference per indexed page (taken at
  :meth:`insert`, released when the node is evicted);
* :meth:`match` takes one reference per returned page *on behalf of the
  caller* — the scheduler frees them when the sequence finishes or is
  evicted, exactly like pages it allocated itself.

Eviction is LRU over *dead leaves*: a leaf node whose page has refcount
1 (the trie's own reference — no live sequence reads it) may be
reclaimed; live-shared pages (refcount ≥ 2) are pinned.  Recency is a
logical tick bumped on every match/insert touch, never wall-clock time,
so replaying a schedule reproduces the same evictions bit-for-bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .paged_cache import PageAllocator


@dataclasses.dataclass
class _Node:
    """One full page of prompt tokens resident in the pool."""

    key: tuple[int, ...]            # the page_size tokens this page holds
    page: int                       # physical page id
    parent: Optional["_Node"]
    children: dict[tuple[int, ...], "_Node"] = \
        dataclasses.field(default_factory=dict)
    tick: int = 0                   # logical LRU clock at last touch


class PrefixCache:
    """Trie of full-page prompt prefixes over a :class:`PageAllocator`."""

    def __init__(self, page_size: int, allocator: PageAllocator):
        if page_size < 1:
            raise ValueError(f"page_size {page_size} < 1")
        self.page_size = page_size
        self.allocator = allocator
        self._root = _Node(key=(), page=-1, parent=None)
        self._tick = 0

    # -- introspection (tests / leak accounting) --------------------------

    @property
    def n_nodes(self) -> int:
        """Indexed pages currently held by the trie."""
        n = 0
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            n += 1
            stack.extend(node.children.values())
        return n

    def pages(self) -> list[int]:
        """Physical pages the trie holds a reference on."""
        out = []
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            out.append(node.page)
            stack.extend(node.children.values())
        return out

    # -- lookup / publish -------------------------------------------------

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.tick = self._tick

    def match(self, prompt) -> list[int]:
        """Longest chain of resident full-page prefixes of ``prompt``.

        Returns the physical pages holding tokens
        ``prompt[: len(result) * page_size]`` — one allocator reference
        per returned page is taken *for the caller*, who must balance
        each with ``allocator.free``.  Partial trailing pages are never
        matched (only full pages are indexed).
        """
        ps = self.page_size
        node, pages = self._root, []
        for j in range(len(prompt) // ps):
            key = tuple(int(t) for t in prompt[j * ps:(j + 1) * ps])
            child = node.children.get(key)
            if child is None:
                break
            self._touch(child)
            pages.append(child.page)
            node = child
        self.allocator.share(pages)
        return pages

    def insert(self, prompt, page_idx: int, page: int) -> bool:
        """Publish ``page`` as holding full page ``page_idx`` of ``prompt``.

        The parent chain (pages ``0..page_idx-1`` of the same prompt)
        must already be indexed — callers publish pages in order as
        prefill completes them, so a missing parent means an ancestor
        was evicted meanwhile and this subtree is no longer reachable:
        returns False, holds nothing.  If the node already exists
        (another sequence published the same prefix first) this is a
        no-op — the existing page stays canonical, the caller's ``page``
        stays private to it — so the trie never holds two pages for one
        prefix.  On success the trie takes its own reference on
        ``page``; returns True.
        """
        ps = self.page_size
        key = tuple(int(t) for t in prompt[page_idx * ps:(page_idx + 1) * ps])
        if len(key) != ps:
            raise ValueError(
                f"page {page_idx} of a {len(prompt)}-token prompt is not full")
        node = self._root
        for j in range(page_idx):
            pkey = tuple(int(t) for t in prompt[j * ps:(j + 1) * ps])
            node = node.children.get(pkey)
            if node is None:
                return False
        existing = node.children.get(key)
        if existing is not None:
            self._touch(existing)
            return False
        self.allocator.share([page])
        child = _Node(key=key, page=page, parent=node)
        node.children[key] = child
        self._touch(child)
        return True

    # -- eviction ---------------------------------------------------------

    def _evictable_leaves(self) -> list[_Node]:
        out = []
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            elif self.allocator.refcount(node.page) == 1:
                out.append(node)  # dead leaf: only the trie reads it
        return out

    def reclaim(self, n: int) -> int:
        """Evict up to ``n`` dead leaves, LRU first; returns pages freed.

        Only leaves whose page has refcount 1 (the trie's own reference)
        are candidates — a page any live sequence still reads is pinned,
        and an interior node's page is reachable through its children so
        it stays until the subtree below it dies.  Evicting a leaf can
        expose its parent as the next dead leaf, so candidates are
        re-scanned after each eviction.
        """
        freed = 0
        while freed < n:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            victim = min(leaves, key=lambda nd: nd.tick)
            del victim.parent.children[victim.key]
            self.allocator.free([victim.page])
            freed += 1
        return freed
