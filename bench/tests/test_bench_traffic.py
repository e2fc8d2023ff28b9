"""The traffic generator: one seed gives the same inputs; every seed the
same work in each block of the stream, in another order within it."""

import numpy as np
import pytest
from conftest import ROOT, TINY_CHAT

from harness.manifest import load_cell
from harness.traffic import Traffic, quantile_sizes

BIG = 2 ** 31 + 12345
#: the cells' mixes, and one without documents (the prompt path)
MIXES = {"docqa": load_cell("internlm2-20b.docqa", ROOT).traffic,
         "chat": dict(TINY_CHAT, block=16)}


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_inputs(name):
    mix = MIXES[name]
    a, b = Traffic(mix, BIG, 1000), Traffic(mix, BIG, 1000)
    for d1, d2 in zip(a.documents, b.documents):
        assert np.array_equal(d1, d2)
    for i in (0, 1, 77, 4000):
        ra, rb = a.request(i), b.request(i)
        assert np.array_equal(ra.prompt, rb.prompt)
        assert (ra.max_new_tokens, ra.doc) == (rb.max_new_tokens, rb.doc)


@pytest.mark.parametrize("name", MIXES)
def test_every_block_holds_the_same_sizes_whatever_the_seed(name):
    mix = MIXES[name]
    a, b = Traffic(mix, 1, 1000), Traffic(mix, BIG, 1000)
    n = mix["block"]

    def blocks(x):
        return np.sort(x.reshape(-1, n), axis=1)
    assert np.array_equal(blocks(a.body), blocks(b.body))
    assert np.array_equal(blocks(a.out), blocks(b.out))
    assert not np.array_equal(a.body, b.body)
    assert not np.array_equal(a.out, b.out)
    assert list(map(len, a.documents)) == list(map(len, b.documents))
    if a.documents:
        assert np.array_equal(blocks(a.doc_of), blocks(b.doc_of))
        assert (np.bincount(a.doc_of[:n]) == n // len(a.documents)).all()
        assert not np.array_equal(a.documents[0], b.documents[0])


@pytest.mark.parametrize("name", MIXES)
def test_each_block_spans_the_distribution(name):
    mix = MIXES[name]
    t = Traffic(mix, 5, 1000)
    n = mix["block"]
    spec = mix.get("prompt") or mix["question"]
    grid = quantile_sizes(spec, t.pool).reshape(n, -1)
    for blk in np.sort(t.body.reshape(-1, n), axis=1)[:50]:
        # one length from each stratum of the distribution
        assert all(lo <= x <= hi for x, lo, hi in
                   zip(blk, grid[:, 0], grid[:, -1]))


def test_lengths_follow_the_mix():
    mix = load_cell("internlm2-20b.docqa", ROOT).traffic
    t = Traffic(mix, 7, 92544)
    assert list(map(len, t.documents)) == [4096, 4681, 5266, 5851, 6437,
                                           7022, 7607, 8192]
    r = t.request(3)
    assert np.array_equal(r.prompt[:len(t.documents[r.doc])],
                          t.documents[r.doc])
    assert 64 <= r.body <= 192 and r.max_new_tokens in (64, 128)
    assert r.prompt.max() < 92544 and r.prompt.min() >= 0
    sizes = quantile_sizes(mix["question"], 1001)
    assert sizes[500] == 96 and sizes.min() >= 64 and sizes.max() <= 192
    assert sorted(set(t.out[:16])) == [64, 128]
    assert (t.out[:16] == 64).sum() == 8
    assert t.max_context() == 8192 + 192 + 128
