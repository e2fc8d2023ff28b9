"""The port's copies of the host runtime against the JAX package's.

``repro_torch.runtime`` keeps copies of ``paged_cache``, ``prefix_cache``
and ``scheduler`` (numpy-only, but ``repro.runtime`` imports JAX).  On
seeded schedules — admission, chunked prefill, decode growth, eviction
under a tiny pool, shared-prefix copy-on-write — both copies are driven
through the same operations the engine performs, with deterministic
stand-in tokens, and must produce the same traces: page ids, block
tables, device views, eviction order and copy-on-write pairs.
"""

import numpy as np
import pytest
import torch

from repro.runtime import paged_cache as JC
from repro.runtime import prefix_cache as JPX
from repro.runtime import scheduler as JS
from repro_torch.runtime import paged_cache as TC
from repro_torch.runtime import prefix_cache as TPX
from repro_torch.runtime import scheduler as TS

torch.set_num_threads(1)


def _token(seq, vocab=50):
    """Deterministic stand-in for a sampled token: a function of the
    request and position only, so eviction replay regenerates it."""
    return (seq.request.id * 7 + len(seq.generated) * 3) % vocab


def _drive(sched_mod, cache_mod, requests, *, n_pages, page_size, mp,
           n_slots, prefix, chunk, budget, waves):
    cache = cache_mod.PagedCacheConfig(n_pages=n_pages, page_size=page_size,
                                       max_pages_per_seq=mp)
    s = sched_mod.Scheduler(cache, n_slots, prefix_cache=prefix)
    trace = []
    rid = 0
    for wave in waves:
        for prompt, n_new in requests[wave[0]:wave[1]]:
            s.add(sched_mod.Request(id=rid, prompt=tuple(prompt),
                                    max_new_tokens=n_new))
            rid += 1
        for _ in range(2000):
            if not s.has_work():
                break
            while (seq := s.try_admit()) is not None:
                trace.append(("admit", seq.request.id, seq.slot,
                              list(seq.pages), seq.prefilled))
            if s.pending_copies:
                copies, s.pending_copies = s.pending_copies, []
                trace.append(("cow", copies))
                s.confirm_copies(copies)
            for seq, n in s.plan_prefill(chunk, budget):
                v = cache_mod.prefill_chunk_view(seq, n, chunk, cache)
                trace.append(("chunk", seq.request.id, v.tokens.tolist(),
                              v.block_tables.tolist(), v.cache_lens.tolist(),
                              v.chunk_lens.tolist()))
                if s.on_prefill_chunk(seq, n):
                    s.on_token(seq, _token(seq))
            if s.decode_slots():
                grown, evicted = s.grow_for_decode()
                trace.append(("grow", [q.request.id for q in grown],
                              [q.request.id for q in evicted]))
                running = s.decode_slots()
                if running:
                    v = cache_mod.decode_view(running, n_slots, cache)
                    trace.append(("decode", v.block_tables.tolist(),
                                  v.lengths.tolist(), v.tokens.tolist()))
                    for seq in running.values():
                        s.on_token(seq, _token(seq))
            trace.append(("pool", s.allocator.n_free, s.n_preemptions,
                          s.prefix_hit_tokens, s.pages_shared, s.cow_copies))
        else:
            raise AssertionError("schedule did not drain")
    if s.prefix_cache is not None:
        trace.append(("trie", sorted(s.prefix_cache.pages()),
                      s.prefix_cache.n_nodes))
    return trace


def _requests(seed, n, *, preamble=0, lo=2, hi=30, vocab=50):
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, size=preamble).tolist()
    return [(pre + rng.integers(0, vocab, size=int(ln)).tolist(), int(m))
            for ln, m in zip(rng.integers(lo, hi, size=n),
                             rng.integers(1, 12, size=n))]


SCHEDULES = {
    # mixed lengths, roomy pool
    "mixed": dict(reqs=dict(seed=0, n=8), n_pages=64, page_size=4, mp=12,
                  n_slots=3, prefix=False, chunk=6, budget=6,
                  waves=[(0, 8)]),
    # tiny pool: decode growth evicts the youngest, re-queued by arrival
    "eviction": dict(reqs=dict(seed=1, n=8, lo=6, hi=20), n_pages=12,
                     page_size=4, mp=8, n_slots=4, prefix=False, chunk=4,
                     budget=8, waves=[(0, 8)]),
    # shared preamble in two waves: hits, COW of fully-resident prompts
    "prefix": dict(reqs=dict(seed=2, n=8, preamble=8, lo=0, hi=6),
                   n_pages=48, page_size=4, mp=8, n_slots=3, prefix=True,
                   chunk=4, budget=8, waves=[(0, 3), (3, 8)]),
    # prefix sharing under pool pressure: trie leaves reclaimed LRU
    "prefix-pressure": dict(reqs=dict(seed=3, n=10, preamble=8, lo=1, hi=9),
                            n_pages=14, page_size=4, mp=6, n_slots=3,
                            prefix=True, chunk=4, budget=4,
                            waves=[(0, 4), (4, 10)]),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_scheduler_traces_match(name):
    cfg = dict(SCHEDULES[name])
    requests = _requests(**cfg.pop("reqs"))
    if name == "prefix":  # one prompt exactly the preamble: fully resident
        requests[4] = (requests[0][0][:8], 3)
    jt = _drive(JS, JC, requests, **cfg)
    tt = _drive(TS, TC, requests, **cfg)
    assert tt == jt
    kinds = {e[0] for e in jt}
    if name == "eviction":
        assert any(e[0] == "grow" and e[2] for e in jt)  # evictions happened
    if name == "prefix":
        assert "cow" in kinds and jt[-2][3] > 0  # hits and a COW copy


@pytest.mark.parametrize("tp", [1, 2])
def test_allocator_and_trie_match(tp):
    """Random alloc / share / free / match / insert / reclaim sequences."""
    rng = np.random.default_rng(tp)
    ja, ta = JC.PageAllocator(23, tp=tp), TC.PageAllocator(23, tp=tp)
    jx, tx = JPX.PrefixCache(2, ja), TPX.PrefixCache(2, ta)
    held_j, held_t = [], []
    prompts = [rng.integers(0, 3, size=int(n)).tolist()
               for n in rng.integers(2, 9, size=12)]
    for step in range(200):
        op = rng.integers(0, 5)
        if op == 0:
            n = int(rng.integers(1, 4))
            try:
                pj = ja.alloc(n)
            except JC.OutOfPagesError:
                with pytest.raises(TC.OutOfPagesError):
                    ta.alloc(n)
                continue
            assert ta.alloc(n) == pj
            held_j.append(pj)
            held_t.append(list(pj))
        elif op == 1 and held_j:
            i = int(rng.integers(len(held_j)))
            ja.free(held_j.pop(i))
            ta.free(held_t.pop(i))
        elif op == 2:
            prompt = prompts[int(rng.integers(len(prompts)))]
            pj, pt = jx.match(prompt), tx.match(prompt)
            assert pt == pj
            held_j.append(pj)
            held_t.append(list(pt))
        elif op == 3 and held_j:
            prompt = prompts[int(rng.integers(len(prompts)))]
            i = int(rng.integers(len(held_j)))
            for j, page in enumerate(held_j[i][:len(prompt) // 2]):
                assert tx.insert(prompt, j, page) == jx.insert(prompt, j,
                                                               page)
        else:
            n = int(rng.integers(1, 3))
            assert tx.reclaim(n) == jx.reclaim(n)
        assert ta.n_free == ja.n_free
        assert sorted(tx.pages()) == sorted(jx.pages())
    assert [ta.refcount(p) for p in range(23)] == \
        [ja.refcount(p) for p in range(23)]


def test_pool_contracts_match():
    for args in ((64, 16, 8, 128), (10, 4, 2, 16)):
        assert TC.pool_shape(*args) == JC.pool_shape(*args)
        assert TC.pool_leaf_specs(*args) == JC.pool_leaf_specs(*args)
    assert TC.NULL_PAGE == JC.NULL_PAGE == 0
    np.testing.assert_array_equal(TC.block_table_row([3, 1], 4),
                                  JC.block_table_row([3, 1], 4))
    view = TC.view_arrays(TC.DecodeView(
        block_tables=np.zeros((2, 3), np.int32),
        lengths=np.array([1, 2], np.int32),
        tokens=np.array([[4], [5]], np.int32)), "cpu")
    assert isinstance(view.lengths, torch.Tensor)
    assert view.tokens.dtype == torch.int32 and view.tokens.tolist() == \
        [[4], [5]]
