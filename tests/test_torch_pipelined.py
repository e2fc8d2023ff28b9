"""The port's ``PipelinedEngine`` against the JAX package's, and against the
port's own synchronous ``ServingEngine``.

Weights come from the JAX package through ``params_from_jax``, as in
``tests/test_torch_model.py``: Qwen3-32B scaled down to d_model 64, 4/2
heads, vocab 128, two layers, f32, on the CPU.  The contract mirrors
``tests/test_async_engine.py``: one-step-ahead dispatch, on-device
sampling and late harvests are invisible in the token streams.

* Greedy tokens equal the JAX ``PipelinedEngine``'s and the port's
  ``ServingEngine``'s under exact / REXP / 2D-LUT at depths 1, 2 and 4
  (the JAX engine runs at depth 2: its own suite pins depth as
  unobservable), f32 and int8 pools.  One known parting: REXP on an int8
  pool under eviction, request 0, the decision ``ROADMAP.md`` queue 3
  names (f32 projection roundoff crossing a REXP bin; see
  ``tests/test_torch_serve_loop.py``).
* Sampled tokens equal the synchronous engine's: both draw from
  ``serve_loop.sample_tokens``, whose rows depend only on their
  ``(seed, position)`` and logits.
* Eviction leaks no page and leaves no ``PENDING_TOKEN``; EOS rolls the
  speculated tail back; a step ships only ``(n,)`` int32 tokens; the
  pools are updated in place; streaming emits each token once.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import RunConfig as JRun
from repro.core.policies import SoftmaxPolicy as JPol
from repro.models import build_model as jax_build
from repro.runtime import EngineConfig as JEngineConfig
from repro.runtime import PagedCacheConfig as JCache
from repro.runtime import PipelinedEngine as JPipelined
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import RunConfig as TRun
from repro_torch.core.policies import SoftmaxPolicy as TPol
from repro_torch.kernels.lut_attention import ops as tops
from repro_torch.models import build_model as torch_build
from repro_torch.models import layers as LAYERS
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import serve_loop as TSL
from repro_torch.runtime.engine import EngineConfig, PipelinedEngine
from repro_torch.runtime.engine import ServingEngine
from repro_torch.runtime.paged_cache import PagedCacheConfig
from repro_torch.runtime.scheduler import PENDING_TOKEN

torch.set_num_threads(1)

IMPLS = ("exact", "rexp", "lut2d")
VOCAB = 128
CACHE = PagedCacheConfig(n_pages=40, page_size=8, max_pages_per_seq=8)
#: usable pages cannot hold the aggregate working set → forced evictions
TIGHT = PagedCacheConfig(n_pages=10, page_size=8, max_pages_per_seq=8)


def _arch(archs):
    return archs["qwen3-32b"].scaled_down(d_model=64, n_heads=4,
                                          n_kv_heads=2, vocab=VOCAB,
                                          n_periods=2)


@pytest.fixture(scope="module")
def models():
    jm, tm = jax_build(_arch(JARCHS)), torch_build(_arch(TARCHS))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def jax_tokens(models):
    """The JAX ``PipelinedEngine``'s results by (schedule, impl, kv_dtype),
    each drive run once per module."""
    jm, jp, _, _ = models
    memo = {}

    def get(schedule, impl, kv_dtype):
        key = (schedule, impl, kv_dtype)
        if key not in memo:
            waves, knobs = _schedule(schedule)
            eng = JPipelined(jm, jp, _runs(impl)[0], _config(
                JEngineConfig, JCache, knobs, kv_dtype))
            memo[key] = (_drive(eng, waves), eng.stats)
        return memo[key]
    return get


def _kw(impl):
    return dict(impl=impl, precision="uint8") if impl != "exact" else {}


def _runs(impl):
    return (JRun(dtype="float32", attention_backend="naive",
                 softmax_policy=JPol(**_kw(impl))),
            TRun(dtype="float32", softmax_policy=TPol(**_kw(impl))))


def _schedule(name):
    """(request waves, engine knobs) — the greedy schedules of
    ``tests/test_torch_model.py``."""
    rng = np.random.default_rng({"mixed": 0, "eviction": 1, "prefix": 2}[
        name])
    if name == "mixed":
        reqs = [(rng.integers(0, VOCAB, size=int(n)).tolist(), int(m))
                for n, m in zip(rng.integers(2, 32, size=6),
                                rng.integers(1, 28, size=6))]
        return [reqs], dict(n_slots=3, n_pages=40, page_size=8, mp=8,
                            chunk=16, prefix=False)
    if name == "eviction":    # 4 slots on 11 usable pages: decode evicts
        reqs = [(rng.integers(0, VOCAB, size=int(n)).tolist(), 20)
                for n in rng.integers(6, 16, size=6)]
        return [reqs], dict(n_slots=4, n_pages=12, page_size=4, mp=10,
                            chunk=8, prefix=False)
    pre = rng.integers(0, VOCAB, size=16).tolist()
    first = [(pre + rng.integers(0, VOCAB, size=int(n)).tolist(), 6)
             for n in (3, 9)]
    second = [(pre + rng.integers(0, VOCAB, size=int(n)).tolist(), 6)
              for n in (5, 1)] + [(pre, 4)]   # the last: fully resident
    return [first, second], dict(n_slots=2, n_pages=40, page_size=4, mp=10,
                                 chunk=8, prefix=True)


def _config(cfg_cls, cache_cls, knobs, kv_dtype="f32", **kw):
    return cfg_cls(n_slots=knobs["n_slots"], prefill_chunk=knobs["chunk"],
                   prefix_cache=knobs["prefix"], kv_dtype=kv_dtype,
                   cache=cache_cls(n_pages=knobs["n_pages"],
                                   page_size=knobs["page_size"],
                                   max_pages_per_seq=knobs["mp"]), **kw)


def _drive(eng, waves):
    out = {}
    for wave in waves:
        out.update(eng.run(wave))
    return {rid: r.tokens.tolist() for rid, r in out.items()}


def _port(models, cls, schedule, impl, kv_dtype="f32", depth=2):
    _, _, tm, tp = models
    waves, knobs = _schedule(schedule)
    kw = dict(pipeline_depth=depth) if cls is PipelinedEngine else {}
    eng = cls(tm, tp, _runs(impl)[1], _config(EngineConfig, PagedCacheConfig,
                                               knobs, kv_dtype, **kw),
              device="cpu")
    return _drive(eng, waves), eng


STAT_FIELDS = ("steps", "prefill_steps", "prompt_tokens", "preemptions",
               "prefix_hit_tokens", "cow_copies", "tokens",
               "speculative_wasted")


# ---------------------------------------------------------------------------
# Greedy token identity: port pipelined == JAX pipelined == port sync
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("impl", IMPLS)
def test_pipelined_greedy_tokens_identical(models, jax_tokens, impl, depth):
    jtok, jstats = jax_tokens("mixed", impl, "f32")
    ttok, eng = _port(models, PipelinedEngine, "mixed", impl, depth=depth)
    stok, _ = _port(models, ServingEngine, "mixed", impl)
    assert eng.depth == depth
    assert ttok == jtok
    assert ttok == stok
    for field in STAT_FIELDS:
        assert getattr(eng.stats, field) == getattr(jstats, field), field
    assert eng.stats.inflight_peak >= min(depth, 2)
    assert not eng.has_work() and not eng._inflight


# (schedule, impl) → the requests whose greedy stream on an int8 pool
# leaves the JAX engine's: REXP under eviction parts at request 0,
# decision 10 (top-2 margin 0.0128), the one parting of the synchronous
# int8 engine that ROADMAP.md queue 3 names and
# ``test_int8_rexp_parting_is_projection_roundoff`` takes apart.  The
# pipelined engine must part exactly there too, and nowhere else.
INT8_PARTINGS = {("eviction", "rexp"): {0}}


@pytest.mark.parametrize("schedule,impl", [
    ("mixed", "exact"), ("mixed", "rexp"), ("mixed", "lut2d"),
    ("eviction", "exact"), ("eviction", "rexp"), ("eviction", "lut2d"),
    ("prefix", "rexp")])
def test_pipelined_int8_pool_tokens_identical(models, jax_tokens, schedule,
                                              impl):
    jtok, jstats = jax_tokens(schedule, impl, "int8")
    ttok, eng = _port(models, PipelinedEngine, schedule, impl, "int8")
    stok, _ = _port(models, ServingEngine, schedule, impl, "int8")
    assert eng.pools[0]["k_pages"].dtype == torch.int8
    assert ttok == stok
    parted = {rid for rid in jtok if ttok[rid] != jtok[rid]}
    assert parted == INT8_PARTINGS.get((schedule, impl), set())
    for field in STAT_FIELDS:
        assert getattr(eng.stats, field) == getattr(jstats, field), field
    if schedule == "eviction":
        assert eng.stats.preemptions > 0
    if schedule == "prefix":
        assert eng.stats.prefix_hit_tokens > 0 and eng.stats.cow_copies > 0


def test_pipelined_prefix_cache_tokens_identical(models, jax_tokens):
    """Shared prefixes in two waves on an f32 pool: copy-on-write page
    copies run inside a dispatch, before its chunks write."""
    jtok, _ = jax_tokens("prefix", "lut2d", "f32")
    ttok, eng = _port(models, PipelinedEngine, "prefix", "lut2d")
    assert ttok == jtok
    assert eng.stats.prefix_hit_tokens > 0 and eng.stats.cow_copies > 0


# ---------------------------------------------------------------------------
# Eviction, EOS, sampling
# ---------------------------------------------------------------------------


def _engines(models, impl, cfg, depth=2):
    _, _, tm, tp = models
    run = _runs(impl)[1]
    return (ServingEngine(tm, tp, run, cfg, device="cpu"),
            PipelinedEngine(tm, tp, run, dataclasses.replace(
                cfg, pipeline_depth=depth), device="cpu"))


def _assert_same_outputs(out_a, out_b):
    assert set(out_a) == set(out_b)
    for rid in out_a:
        np.testing.assert_array_equal(out_a[rid].tokens, out_b[rid].tokens,
                                      err_msg=f"request {rid}")
        assert out_a[rid].finish_reason == out_b[rid].finish_reason


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_pipelined_under_eviction_pressure_no_leaks(models, depth):
    """Speculation + eviction, greedy and sampled requests: replayed
    requests finish as on the sync engine, every page comes back and no
    placeholder reaches a result."""
    rng = np.random.default_rng(1)
    reqs = [dict(prompt=rng.integers(0, VOCAB, size=n).tolist(),
                 max_new_tokens=m, temperature=t, seed=i)
            for i, (n, m, t) in enumerate(
                [(20, 30, 0.0), (16, 30, 0.9), (12, 20, 0.0), (8, 16, 1.1)])]
    sync, pipe = _engines(models, "rexp", EngineConfig(n_slots=3,
                                                       cache=TIGHT), depth)
    out_s = sync.run([dict(r) for r in reqs])
    out_p = pipe.run([dict(r) for r in reqs])
    assert pipe.stats.preemptions > 0
    assert pipe.stats.preemptions == sync.stats.preemptions
    assert pipe.scheduler.allocator.n_free == TIGHT.usable_pages
    assert not any(PENDING_TOKEN in r.tokens for r in out_p.values())
    _assert_same_outputs(out_s, out_p)


def test_pipelined_speculative_eos_rollback(models):
    """EOS lands one harvest late: the tokens speculated past it are
    rolled back (``stats.speculative_wasted``), the finish reason says
    "eos" and no page leaks."""
    _, _, tm, tp = models
    run = _runs("exact")[1]
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, VOCAB, size=6).tolist()
    probe = ServingEngine(tm, tp, run, EngineConfig(n_slots=2, cache=CACHE),
                          device="cpu").run([(prompt, 12)])
    eos = int(probe[0].tokens[4])
    stop_at = int(np.argmax(probe[0].tokens == eos)) + 1
    sync, pipe = _engines(models, "exact", EngineConfig(n_slots=2,
                                                        cache=CACHE))
    out_s = sync.run([dict(prompt=prompt, max_new_tokens=12, eos_id=eos)])
    out_p = pipe.run([dict(prompt=prompt, max_new_tokens=12, eos_id=eos)])
    _assert_same_outputs(out_s, out_p)
    assert out_p[0].finish_reason == "eos"
    assert len(out_p[0].tokens) == stop_at and out_p[0].tokens[-1] == eos
    assert pipe.stats.speculative_wasted > 0
    assert pipe.scheduler.allocator.n_free == CACHE.usable_pages
    assert not any(PENDING_TOKEN in r.tokens for r in out_p.values())


@pytest.mark.parametrize("impl", ["rexp", "lut2d"])
def test_pipelined_sampled_bitwise(models, impl):
    """temperature > 0: two pipelined engines agree, and agree with the
    sync engine's host-side ``sample_row`` bit for bit."""
    _, _, tm, tp = models
    run = _runs(impl)[1]
    rng = np.random.default_rng(3)
    reqs = [dict(prompt=rng.integers(0, VOCAB, size=n).tolist(),
                 max_new_tokens=m, temperature=t, seed=s)
            for n, m, t, s in [(9, 10, 0.9, 0), (4, 12, 0.0, 1),
                               (13, 8, 1.3, 2), (5, 9, 0.5, 3)]]
    cfg = EngineConfig(n_slots=2, cache=CACHE, prefill_chunk=4)
    outs = [cls(tm, tp, run, cfg, device="cpu").run([dict(r) for r in reqs])
            for cls in (PipelinedEngine, PipelinedEngine, ServingEngine)]
    _assert_same_outputs(outs[0], outs[1])
    _assert_same_outputs(outs[2], outs[0])
    greedy = ServingEngine(tm, tp, run, cfg, device="cpu").run(
        [dict(r, temperature=0.0) for r in reqs])
    assert any((outs[0][i].tokens != greedy[i].tokens).any()
               for i in (0, 2, 3)), "sampling never left the argmax"


def _hash_reference(seed, position, vocab):
    """``serve_loop.gumbel_noise``'s integers in plain Python ints: the
    52-bit counter hash of (seed, position, vocab index)."""
    m = 0xFFFFFFFF

    def mix(x):
        x ^= x >> 16
        x = (x * 0x7FEB352D) & m
        x ^= x >> 15
        x = (x * 0x846CA68B) & m
        return x ^ (x >> 16)

    key = mix(mix((seed & m) ^ 0x9E3779B9) ^ (position & m))
    return [(mix(mix(key ^ 2 * v)) >> 6) << 26 | (mix(mix(key ^ (2 * v + 1)))
                                                  >> 6)
            for v in range(vocab)]


def test_sampler_is_a_function_of_the_row_alone():
    """The sampler's draws: its integers are the plain-integer hash (no
    int64 overflow, so the same on every device), ``u`` lies inside
    (0, 1), a row's token does not depend on the batch or the slot it
    sits in, ``sample_row`` is the same function on one host row, greedy
    rows take the argmax, and the draws follow softmax(logits / t)."""
    seeds = torch.tensor([0, 7, -3, 2 ** 40 + 5])
    positions = torch.tensor([0, 1, 31, 2 ** 33])
    bits = TSL.hash_bits(seeds, positions, 50)
    g = TSL.gumbel_noise(seeds, positions, 50)
    assert g.dtype == torch.float64 and g.shape == (4, 50)
    for b in range(4):
        k = _hash_reference(int(seeds[b]), int(positions[b]), 50)
        assert bits[b].tolist() == k
        assert 0 <= min(k) and max(k) < 2 ** 52 and len(set(k)) == 50
        u = (2 * np.array(k, np.float64) + 1) * 2.0 ** -53
        assert ((u > 0) & (u < 1)).all()
        np.testing.assert_allclose(g[b].numpy(), -np.log(-np.log(u)),
                                   rtol=1e-15, atol=0)

    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(6, 1, 50)).astype(np.float32))
    seeds = np.array([3, 3, 9, 1, 4, 4])
    pos = np.array([0, 5, 5, 2, 7, 0])
    temps = np.array([1.0, 0.0, 0.7, 1.0, 2.0, 0.3])
    batch = TSL.sample_tokens(logits, seeds, pos, temps)
    assert batch.dtype == torch.int32 and batch.shape == (6,)
    assert int(batch[1]) == int(torch.argmax(logits[1, 0]))
    perm = [4, 2, 0, 5, 3, 1]
    shuffled = TSL.sample_tokens(logits[perm], seeds[perm], pos[perm],
                                 temps[perm])
    for b in range(6):
        alone = TSL.sample_tokens(logits[b:b + 1], seeds[b:b + 1],
                                  pos[b:b + 1], temps[b:b + 1])
        assert int(alone[0]) == int(batch[b]) == int(shuffled[perm.index(b)])
        assert TSL.sample_row(logits[b, 0].numpy(), float(temps[b]),
                              int(seeds[b]), int(pos[b])) == int(batch[b])

    row = torch.tensor([[[0.0, 1.0, 2.0, -1.0]]]).expand(4000, 1, 4)
    n = torch.arange(4000)
    draws = TSL.sample_tokens(row, torch.full((4000,), 11), n,
                              torch.full((4000,), 0.8))
    freq = np.bincount(draws.numpy(), minlength=4) / 4000
    want = torch.softmax(row[0, 0].double() / 0.8, -1).numpy()
    np.testing.assert_allclose(freq, want, atol=0.03)


# ---------------------------------------------------------------------------
# What a step moves, and where the pools live
# ---------------------------------------------------------------------------


def _mixed_requests(rng, n, temperatures=(0.0, 0.8)):
    return [dict(prompt=rng.integers(0, VOCAB,
                                     size=int(rng.integers(2, 30))).tolist(),
                 max_new_tokens=int(rng.integers(2, 24)),
                 temperature=float(rng.choice(temperatures)), seed=i)
            for i in range(n)]


def test_pipelined_never_ships_logits(models):
    """Everything a step hands to the harvest is a token vector —
    ``(n_slots,)`` for decode, ``(1,)`` for a final prefill chunk, int32
    — never ``(B, 1, V)`` logits; the harvested host copies too."""
    _, _, tm, tp = models
    eng = PipelinedEngine(tm, tp, _runs("exact")[1],
                          EngineConfig(n_slots=3, cache=CACHE), device="cpu")
    shapes = set()
    orig = eng._push_inflight

    def spy(toks, entries, kind):
        shapes.add((kind, tuple(toks.shape), toks.dtype))
        orig(toks, entries, kind)
        rec = eng._inflight[-1]
        shapes.add((kind, tuple(rec.tokens.shape), rec.tokens.dtype))

    eng._push_inflight = spy
    eng.run(_mixed_requests(np.random.default_rng(4), 5))
    assert {k for k, _, _ in shapes} == {"decode", "chunk"}
    for kind, shape, dtype in shapes:
        assert dtype == torch.int32
        assert shape == ((3,) if kind == "decode" else (1,)), \
            f"{kind} step shipped {shape}, not a token vector"


def test_pipelined_pools_stay_in_place(models):
    """The pools are updated in place: every leaf keeps its storage
    across a drive with eviction and copy-on-write."""
    _, _, tm, tp = models
    waves, knobs = _schedule("prefix")
    eng = PipelinedEngine(tm, tp, _runs("rexp")[1], _config(
        EngineConfig, PagedCacheConfig, knobs, "int8"), device="cpu")
    before = [(id(leaf), leaf.data_ptr()) for pool in eng.pools
              for leaf in pool.values()]
    snapshot = [leaf.clone() for pool in eng.pools for leaf in pool.values()]
    _drive(eng, waves)
    after = [(id(leaf), leaf.data_ptr()) for pool in eng.pools
             for leaf in pool.values()]
    assert after == before
    leaves = [leaf for pool in eng.pools for leaf in pool.values()]
    assert any(not torch.equal(a, b) for a, b in zip(leaves, snapshot))
    assert eng.stats.cow_copies > 0


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_pipelined_passes_the_tightest_host_bound(monkeypatch, models,
                                                  kv_dtype):
    """Every paged call of a pipelined drive gets ``max_kv_len`` equal to
    the largest kv_len of that call, counted on the host at dispatch
    (before the speculative append), as the sync engine passes it."""
    _, _, tm, tp = models
    seen = []

    def spy(dispatch):
        def call(*args, **kw):
            seen.append((dispatch.__name__, kw["max_kv_len"],
                         int(kw["kv_lens"].max())))
            return dispatch(*args, **kw)
        return call

    monkeypatch.setattr(LAYERS, "lut_attention_paged_decode",
                        spy(tops.lut_attention_paged_decode))
    monkeypatch.setattr(LAYERS, "lut_attention_paged_prefill",
                        spy(tops.lut_attention_paged_prefill))
    eng = PipelinedEngine(tm, tp, _runs("rexp")[1], EngineConfig(
        n_slots=3, prefill_chunk=8, kv_dtype=kv_dtype,
        cache=PagedCacheConfig(n_pages=40, page_size=4,
                               max_pages_per_seq=16)), device="cpu")
    rng = np.random.default_rng(5)
    for n in (3, 17, 30):
        eng.add_request(rng.integers(0, VOCAB, size=n).tolist(), 6)
    eng.run()
    assert {name for name, _, _ in seen} == {"lut_attention_paged_decode",
                                             "lut_attention_paged_prefill"}
    for name, bound, longest in seen:
        assert bound == longest, (name, bound, longest)


# ---------------------------------------------------------------------------
# Streaming, depth, stats
# ---------------------------------------------------------------------------


def test_pipelined_streaming_exactly_once_under_eviction(models):
    """``on_token`` fires once per token, in order, through eviction
    replay — streamed == final result, no placeholders."""
    _, _, tm, tp = models
    eng = PipelinedEngine(tm, tp, _runs("exact")[1],
                          EngineConfig(n_slots=3, cache=TIGHT), device="cpu")
    rng = np.random.default_rng(6)
    reqs = [dict(prompt=rng.integers(0, VOCAB, size=n).tolist(),
                 max_new_tokens=m)
            for n, m in [(20, 30), (16, 30), (12, 20), (8, 16)]]
    streamed = {i: [] for i in range(len(reqs))}
    rids = [eng.add_request(**r, on_token=streamed[i].append)
            for i, r in enumerate(reqs)]
    out = eng.run()
    assert eng.stats.preemptions > 0
    for i, rid in enumerate(rids):
        assert streamed[i] == list(out[rid].tokens), f"request {i}"
        assert PENDING_TOKEN not in streamed[i]


def test_pipelined_rejects_zero_depth(models):
    _, _, tm, tp = models
    with pytest.raises(ValueError, match="pipeline_depth"):
        PipelinedEngine(tm, tp, _runs("exact")[1],
                        EngineConfig(n_slots=2, cache=CACHE,
                                     pipeline_depth=0), device="cpu")


def test_pipelined_stats_and_handle(models):
    """The pipelined counters are live, and a ``RequestHandle`` drives
    ``result()`` through speculative harvests."""
    _, _, tm, tp = models
    eng = PipelinedEngine(tm, tp, _runs("exact")[1],
                          EngineConfig(n_slots=2, cache=CACHE), device="cpu")
    rng = np.random.default_rng(8)
    h = eng.add_request(rng.integers(0, VOCAB, size=9).tolist(), 6)
    assert not h.done
    res = h.result()
    assert h.done and len(res.tokens) == 6
    assert h.ttft_s is not None and h.ttft_s >= 0.0
    assert eng.stats.inflight_peak >= 1
    assert eng.stats.harvest_wait_s >= 0.0
    assert not eng.has_work() and not eng._inflight
