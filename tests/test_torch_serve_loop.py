"""The port's lockstep path and int8 serving against the JAX package's.

Weights come from the JAX package (``model.init``) through
``params_from_jax``, as in ``tests/test_torch_model.py``: Qwen3-32B
scaled down to d_model 64, 4/2 heads, vocab 128, two layers, f32, the
attention on the ``naive`` backend (the JAX package's lockstep path).

* ``lut_attention``'s naive backend, with and without ``kv_len``,
  agrees with the JAX function within 2e-6 (the paged suites'
  tolerance: the same integer LUT pipeline, f32 sums in another order).
* Teacher-forced ``prefill`` logits agree with the JAX package's within
  1e-4 for every (policy, kv_dtype) — XLA and torch order the f32
  matmul sums differently — and so do the f32-vs-int8 logit deltas that
  the JAX package's accuracy harness (``tests/test_kv_quant.py``)
  measures; the 1 % budget itself is the reference's test, not
  re-asserted here.
* Greedy ``generate`` gives the JAX package's tokens, f32 and int8.
* The int8 ``ServingEngine`` makes the JAX int8 engine's greedy
  decisions under exact / REXP / 2D-LUT, with eviction and with prefix
  caching, and those of the port's own int8 lockstep ``generate``; its
  copy-on-write copies move each page's scales with it.  The streams
  part once, under REXP with eviction, at a decision whose top-2 margin
  is 0.0128: the tests name that decision, and one of them shows it is a
  REXP bin edge crossed on f32 projection roundoff.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import RunConfig as JRun
from repro.core.policies import SoftmaxPolicy as JPol
from repro.kernels.lut_attention import ops as jops
from repro.models import build_model as jax_build
from repro.runtime import EngineConfig as JEngineConfig
from repro.runtime import PagedCacheConfig as JCache
from repro.runtime import ServingEngine as JEngine
from repro.runtime import serve_loop as JSL
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import RunConfig as TRun
from repro_torch.core.policies import SoftmaxPolicy as TPol
from repro_torch.kernels.lut_attention import ops as tops
from repro_torch.kernels.lut_attention import ref as tref
from repro_torch.models import build_model as torch_build
from repro_torch.models.convert import params_from_jax, pool_from_jax
from repro_torch.runtime import serve_loop as TSL
from repro_torch.runtime.engine import EngineConfig as TEngineConfig
from repro_torch.runtime.engine import ServingEngine as TEngine
from repro_torch.runtime.paged_cache import PagedCacheConfig as TCache

torch.set_num_threads(1)

IMPLS = ("exact", "rexp", "lut2d")
VOCAB = 128
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
ATTN_TOL = dict(rtol=2e-6, atol=2e-6)


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


def _kw(impl):
    return dict(impl=impl, precision="uint8") if impl != "exact" else {}


def _runs(impl, kv_dtype="f32"):
    return (JRun(dtype="float32", attention_backend="naive",
                 softmax_policy=JPol(**_kw(impl)), kv_dtype=kv_dtype),
            TRun(dtype="float32", softmax_policy=TPol(**_kw(impl)),
                 kv_dtype=kv_dtype))


# ---------------------------------------------------------------------------
# lut_attention (naive backend)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kv_len,causal", [(None, True), (None, False),
                                           (13, True)])
def test_lut_attention_naive_matches_jax(impl, kv_len, causal):
    """Without ``kv_len`` the naive oracle (REXP with the fused α
    requant, the JAX default); with it the tail-masked path whose
    causal queries are right-aligned to the valid length."""
    rng = np.random.default_rng(len(impl))
    q = rng.normal(size=(2, 4, 5, 16)).astype(np.float32)
    k = rng.normal(size=(2, 2, 20, 16)).astype(np.float32)
    v = rng.normal(size=(2, 2, 20, 16)).astype(np.float32)
    ref = jops.lut_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             JPol(**_kw(impl)), causal=causal,
                             kv_len=kv_len, backend="naive")
    out = tops.lut_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), TPol(**_kw(impl)),
                             causal=causal, kv_len=kv_len)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ATTN_TOL)
    if kv_len is None and impl == "rexp":  # the oracle's faithful REXP
        from repro.kernels.lut_attention import ref as jref
        faithful = tref.lut_attention_ref(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            method=impl, tables=tops._tables_for(TPol(**_kw(impl))),
            causal=causal)
        np.testing.assert_allclose(
            faithful.numpy(),
            np.asarray(jref.lut_attention_ref(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), method=impl,
                tables=jops._tables_for(JPol(**_kw(impl))),
                causal=causal)), **ATTN_TOL)
        assert not np.allclose(faithful.numpy(), out.numpy())


@pytest.mark.parametrize("backend,impl,expect", [
    ("blocked", "rexp", None), ("blocked", "exact", None),
    ("pallas", "rexp", ValueError),       # the JAX knob; the port's 'cuda'
    ("flash", "lut2d", ValueError),
    ("cuda", "rexp", ValueError),         # CPU tensors: no kernel to take
    ("cuda", "exact", ValueError),
    ("auto", "rexp", None), ("auto", "lut2d", None), ("auto", "exact", None),
    ("naive", "rexp", None), ("naive", "exact", None)])
def test_lut_attention_unported_backends_raise(backend, impl, expect,
                                               monkeypatch):
    """The dense dispatch matrix on CPU tensors: unknown knobs raise,
    ``cuda`` raises without CUDA tensors, ``auto`` and ``naive`` run the
    plain version (the oracle, REXP in its fused form without a kv_len),
    ``blocked`` the chunked path (the oracle's function, its sums in
    another order); no call counts a kernel launch.  The exact policy
    never reaches the kernel, even where the knob resolves to it."""
    from repro_torch.kernels.lut_attention import lut_attention as dense
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 3, 8))
                                .astype(np.float32)) for _ in range(3))
    pol = TPol(**_kw(impl))
    before = dict(dense.lut_attention_cuda.launches)
    if expect is not None:
        with pytest.raises(expect, match=backend):
            tops.lut_attention(q, k, v, pol, backend=backend)
    else:
        out = tops.lut_attention(q, k, v, pol, backend=backend)
        ref = tref.lut_attention_ref(
            q, k, v, method=impl, tables=tops._tables_for(pol),
            fused_requant=True)
        if backend == "blocked":
            torch.testing.assert_close(
                out, tops.lut_attention_blocked(q, k, v, pol), rtol=0,
                atol=0)
            torch.testing.assert_close(out, ref, **ATTN_TOL)
        else:
            torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert dense.lut_attention_cuda.launches == before
    if impl == "exact":  # resolve to the kernel: exact still stays plain
        monkeypatch.setattr(tops, "resolve_attention_backend",
                            lambda *a: "cuda")
        monkeypatch.setattr(dense, "lut_attention_cuda", None)
        tops.lut_attention(q, k, v, pol, backend=backend)


# ---------------------------------------------------------------------------
# Lockstep prefill / generate
# ---------------------------------------------------------------------------


def _forced(jm, jp, tm, tp, toks, impl, kv_dtype):
    """Teacher-forced per-step logits (B, S, V) of both packages."""
    jrun, trun = _runs(impl, kv_dtype)
    jl, _ = jm.prefill(jp, jnp.asarray(toks), jrun, max_len=32)
    tl, caches = tm.prefill(tp, torch.from_numpy(toks), trun, max_len=32)
    assert caches[0][0].length == toks.shape[1]
    return np.asarray(jl), tl.numpy()


@pytest.mark.parametrize("impl", IMPLS)
def test_teacher_forced_prefill_matches_jax(models, impl):
    """The accuracy harness: per (policy, kv_dtype) the prefill logits
    agree within 1e-4, and so does the f32 → int8 logit delta the
    reference measures, position by position."""
    jm, jp, tm, tp = models
    toks = np.random.default_rng(7).integers(0, VOCAB, size=(4, 24)) \
        .astype(np.int32)
    jf, tf = _forced(jm, jp, tm, tp, toks, impl, "f32")
    jq, tq = _forced(jm, jp, tm, tp, toks, impl, "int8")
    np.testing.assert_allclose(tf, jf, **LOGIT_TOL)
    np.testing.assert_allclose(tq, jq, **LOGIT_TOL)
    assert np.abs(jf - jq).max() > 1e-3    # int8 really moved the logits
    np.testing.assert_allclose(tf - tq, jf - jq, rtol=0, atol=2e-4)


@pytest.mark.parametrize("impl,kv_dtype", [
    ("exact", "f32"), ("rexp", "f32"), ("lut2d", "int8"),
    ("rexp", "int8")])
def test_generate_matches_jax(models, impl, kv_dtype):
    jm, jp, tm, tp = models
    jrun, trun = _runs(impl, kv_dtype)
    prompt = np.random.default_rng(3).integers(0, VOCAB, size=(3, 11)) \
        .astype(np.int32)
    ref = JSL.generate(jm, jp, jnp.asarray(prompt), jrun, max_new_tokens=12)
    out = TSL.generate(tm, tp, torch.from_numpy(prompt), trun,
                       max_new_tokens=12)
    assert out.dtype == torch.int32 and out.shape == (3, 12)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_sampling_greedy_and_seeded_replay(models):
    """Greedy rows take the JAX argmax; sampled rows replay from their
    (seed, position) and ignore the batch they share, and a sampled
    ``generate`` replays from its seed."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 1, 50)).astype(np.float32)
    seeds, pos = np.array([3, 3, 9, 1]), np.array([0, 5, 5, 2])
    ref = JSL.sample_tokens(jnp.asarray(logits), jnp.asarray(seeds),
                            jnp.asarray(pos), jnp.zeros(4), greedy=True)
    t = torch.from_numpy(logits)
    np.testing.assert_array_equal(
        TSL.sample_tokens(t, seeds, pos, np.zeros(4)).numpy(),
        np.asarray(ref))
    temps = np.array([1.0, 0.0, 0.7, 1.0])
    mixed = TSL.sample_tokens(t, seeds, pos, temps)
    assert int(mixed[1]) == int(np.asarray(ref)[1])
    for b in (0, 2, 3):
        alone = TSL.sample_tokens(t[b:b + 1], seeds[b:b + 1], pos[b:b + 1],
                                  temps[b:b + 1])
        assert int(alone[0]) == int(mixed[b])
    _, _, tm, tp = models
    _, trun = _runs("rexp")
    prompt = torch.from_numpy(rng.integers(0, VOCAB, size=(2, 5)))

    def sample(seed):
        return TSL.generate(tm, tp, prompt, trun, max_new_tokens=6,
                            temperature=1.0, seed=seed).tolist()

    assert sample(4) == sample(4)


# ---------------------------------------------------------------------------
# int8 continuous batching
# ---------------------------------------------------------------------------


def _schedule(name):
    """(request waves, engine knobs) — the schedules of
    ``tests/test_torch_model.py``."""
    rng = np.random.default_rng({"mixed": 0, "eviction": 1, "prefix": 2}[
        name])
    if name == "mixed":
        reqs = [(rng.integers(0, VOCAB, size=int(n)).tolist(), int(m))
                for n, m in zip(rng.integers(2, 32, size=6),
                                rng.integers(1, 28, size=6))]
        return [reqs], dict(n_slots=3, n_pages=40, page_size=8, mp=8,
                            chunk=16, prefix=False)
    if name == "eviction":
        reqs = [(rng.integers(0, VOCAB, size=int(n)).tolist(), 20)
                for n in rng.integers(6, 16, size=6)]
        return [reqs], dict(n_slots=4, n_pages=12, page_size=4, mp=10,
                            chunk=8, prefix=False)
    pre = rng.integers(0, VOCAB, size=16).tolist()
    first = [(pre + rng.integers(0, VOCAB, size=int(n)).tolist(), 6)
             for n in (3, 9)]
    second = [(pre + rng.integers(0, VOCAB, size=int(n)).tolist(), 6)
              for n in (5, 1)] + [(pre, 4)]
    return [first, second], dict(n_slots=2, n_pages=40, page_size=4, mp=10,
                                 chunk=8, prefix=True)


def _engine(engine_cls, cfg_cls, cache_cls, model, params, run, knobs,
            **kw):
    return engine_cls(model, params, run, cfg_cls(
        n_slots=knobs["n_slots"], prefill_chunk=knobs["chunk"],
        prefix_cache=knobs["prefix"], kv_dtype="int8",
        cache=cache_cls(n_pages=knobs["n_pages"],
                        page_size=knobs["page_size"],
                        max_pages_per_seq=knobs["mp"])), **kw)


def _drive(eng, waves):
    out = {}
    for wave in waves:
        out.update(eng.run(wave))
    return {rid: r.tokens.tolist() for rid, r in out.items()}


# Greedy streams of two f32 computations may part only where a REXP bin
# edge lies within their roundoff of a logit.  A crossed bin moves a
# logit by a whole LUT step (0.22 at the one parting below), so this
# margin does not bound where that can happen: it flags decisions near a
# tie, and every parting must also be one the test names.
MARGIN = 0.02


def _record_decisions(eng):
    """Log every greedy decision of ``eng`` by request id, in order, as
    (index within the request's current attempt, top-2 logit margin,
    token); an eviction restarts the attempt at index 0."""
    log = {}
    sample = eng._sample

    def record(seq, row):
        tok = sample(seq, row)
        top2 = np.sort(np.asarray(row, np.float32))[-2:]
        log.setdefault(int(seq.request.id), []).append(
            (len(seq.generated), float(top2[1] - top2[0]), tok))
        return tok

    eng._sample = record
    return log


def _engine_partings(ref, got):
    """Each request's first decision at which ``got`` leaves ``ref``, as
    (request id, decision number, ref's top-2 margin there)."""
    out = []
    for rid, dec in ref.items():
        for n, (a, b) in enumerate(zip(dec, got[rid])):
            if a[2] != b[2]:
                out.append((rid, n, a[1]))
                break
    return out


def _print_partings(partings):
    for rid, n, margin in partings:
        print(f"request {rid} parts at decision {n}: reference top-2 "
              f"margin {margin:.5f}")


# (schedule, policy) → the (request id, decision number) where the
# port's int8 engine leaves the JAX int8 engine; everywhere else none.
ENGINE_PARTINGS = {("eviction", "rexp"): [(0, 10)]}


@pytest.mark.parametrize("schedule,impl", [
    ("mixed", "exact"), ("mixed", "rexp"), ("mixed", "lut2d"),
    ("eviction", "exact"), ("eviction", "rexp"), ("eviction", "lut2d"),
    ("prefix", "rexp"), ("prefix", "lut2d")])
def test_int8_engine_greedy_tokens_identical(models, schedule, impl):
    """Every greedy decision of the port's int8 engine is the JAX int8
    engine's, but at the partings ``ENGINE_PARTINGS`` names.  There is
    one: REXP on the eviction schedule, request 0, decision 10, at a
    0.0128 top-2 margin.  Its cause is pinned by
    :func:`test_int8_rexp_parting_is_projection_roundoff`."""
    jm, jp, tm, tp = models
    jrun, trun = _runs(impl)        # the engines' kv_dtype makes it int8
    waves, knobs = _schedule(schedule)
    jeng = _engine(JEngine, JEngineConfig, JCache, jm, jp, jrun, knobs)
    teng = _engine(TEngine, TEngineConfig, TCache, tm, tp, trun, knobs,
                   device="cpu")
    assert teng.pools[0]["k_pages"].dtype == torch.int8
    jlog, tlog = _record_decisions(jeng), _record_decisions(teng)
    jtok, ttok = _drive(jeng, waves), _drive(teng, waves)
    partings = _engine_partings(jlog, tlog)
    _print_partings(partings)
    assert all(margin < MARGIN for _, _, margin in partings)
    assert [(rid, n) for rid, n, _ in partings] == ENGINE_PARTINGS.get(
        (schedule, impl), [])
    parted = {rid for rid, _, _ in partings}
    assert len(tlog) == len(jlog) and all(
        len(tlog[rid]) == len(jlog[rid]) for rid in jlog)
    assert {r: t for r, t in ttok.items() if r not in parted} == \
        {r: t for r, t in jtok.items() if r not in parted}
    for field in ("steps", "prefill_steps", "preemptions",
                  "prefix_hit_tokens", "cow_copies", "tokens"):
        assert getattr(teng.stats, field) == getattr(jeng.stats, field)
    if schedule == "eviction":
        assert teng.stats.preemptions > 0
    if schedule == "prefix":
        assert teng.stats.prefix_hit_tokens > 0 and teng.stats.cow_copies > 0
    # per layer: int8 K+V pages plus f32 K+V scales, (2·Dh + 8) B a row
    n_rows = knobs["n_pages"] * knobs["page_size"] * 2
    assert teng.stats.pool_bytes_per_layer == n_rows * (2 * 16 + 8)


def test_int8_rexp_parting_is_projection_roundoff(models):
    """The one parting of the test above, taken apart.  Both engines run
    to the decode step that makes request 0's decision 10; the int8 pools
    they hold then have identical codes and scales within 1e-6 relative.
    One decode step of each package on the JAX engine's state: in layer
    1, q differs by f32 projection roundoff (under 2e-6), the attention
    outputs by a whole REXP LUT step (over 0.1), and the port's attention
    fed the JAX q gives the JAX output within 2e-6.  So the step crosses
    a REXP bin edge on roundoff, and the port's int8 attention is not at
    fault."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers

    jm, jp, tm, tp = models
    jrun, trun = _runs("rexp")
    waves, knobs = _schedule("eviction")
    jeng = _engine(JEngine, JEngineConfig, JCache, jm, jp, jrun, knobs)
    teng = _engine(TEngine, TEngineConfig, TCache, tm, tp, trun, knobs,
                   device="cpu")
    jlog, tlog = _record_decisions(jeng), _record_decisions(teng)
    view = {}
    decode_fn = jeng._decode_fn

    def capture(params, token, pools, block_tables, lengths):
        view.update(token=np.asarray(token), lengths=np.asarray(lengths),
                    block_tables=np.asarray(block_tables),
                    pools=[pool_from_jax(p, device="cpu") for p in pools])
        return decode_fn(params, token, pools, block_tables, lengths)

    jeng._decode_fn = capture
    for eng in (jeng, teng):
        for prompt, n_new in waves[0]:
            eng.add_request(prompt, n_new)
    while len(jlog.get(0, ())) <= 10:   # through the step of decision 10
        jeng.step()
        teng.step()
    assert [d[2] for d in tlog[0][:10]] == [d[2] for d in jlog[0][:10]]
    assert tlog[0][10][2] != jlog[0][10][2]
    jpool, tpool = jeng.pools[0], teng.pools[0]
    for name in ("k_pages", "v_pages"):
        assert torch.equal(torch.from_numpy(np.array(jpool[name])),
                           tpool[name])
    for name in ("k_scales", "v_scales"):
        np.testing.assert_allclose(tpool[name].numpy(),
                                   np.asarray(jpool[name]), rtol=1e-6,
                                   atol=0)
    slot = next(s.slot for s in jeng.scheduler.running.values()
                if int(s.request.id) == 0)

    trec, jrec, tcalls = [], [], []
    t_decode = tlayers.lut_attention_paged_decode
    j_decode = jlayers.lut_attention_paged_decode

    def t_shadow(q, *args, **kw):
        out = t_decode(q, *args, **kw)
        trec.append((q.numpy().copy(), out.numpy().copy()))
        tcalls.append((args, kw))
        return out

    def j_shadow(q, *args, **kw):
        out = j_decode(q, *args, **kw)
        jax.debug.callback(lambda a, b: jrec.append((np.asarray(a),
                                                     np.asarray(b))),
                           q, out)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlayers, "lut_attention_paged_decode", t_shadow)
        mp.setattr(jlayers, "lut_attention_paged_decode", j_shadow)
        tm.decode_step_paged(
            tp, torch.from_numpy(view["token"]), view["pools"],
            torch.from_numpy(view["block_tables"]),
            torch.from_numpy(view["lengths"]), trun)
        jm.decode_step_paged(
            jp, jnp.asarray(view["token"]),
            [{k: jnp.asarray(v.numpy()) for k, v in p.items()}
             for p in view["pools"]],
            jnp.asarray(view["block_tables"]),
            jnp.asarray(view["lengths"]), jrun)[0].block_until_ready()
    assert len(trec) == len(jrec) == 2
    (tq, tout), (jq, jout) = trec[1], jrec[1]
    assert np.abs(tq[slot] - jq[slot]).max() < 2e-6
    jump = np.abs(tout[slot] - jout[slot]).max()
    print(f"layer 1, slot {slot}: q differs by "
          f"{np.abs(tq[slot] - jq[slot]).max():.2e}, attention by {jump:.3f}")
    assert jump > 0.1
    args, kw = tcalls[1]
    fed = t_decode(torch.from_numpy(jq), *args, **kw).numpy()
    np.testing.assert_allclose(fed, jout, rtol=0, atol=2e-6)


def test_int8_cow_copy_moves_scales(models):
    """Each copy-on-write duplicate carries its source page's int8 codes
    AND scales, in every layer, before a chunk writes into it — and the
    scales it copies are real ones, not the zero-initialized pool."""
    _, _, tm, tp = models
    _, trun = _runs("lut2d")
    waves, knobs = _schedule("prefix")
    eng = _engine(TEngine, TEngineConfig, TCache, tm, tp, trun, knobs,
                  device="cpu")
    seen = []
    confirm = eng.scheduler.confirm_copies

    def check(copies):
        for src, dst in copies:
            pool = eng.pools[0]
            assert pool["k_scales"][:, src].abs().min() > 0
            for leaf in pool.values():
                assert torch.equal(leaf[:, dst], leaf[:, src])
            seen.append((src, dst))
        return confirm(copies)

    eng.scheduler.confirm_copies = check
    _drive(eng, waves)
    assert seen and eng.stats.cow_copies == len(seen)


def _lockstep_decisions(model, params, run, prompt, n_new):
    """The (top-2 margin, token) of each greedy decision of the port's
    int8 lockstep ``generate`` serving ``prompt`` alone at B = 1."""
    rows, sample = [], TSL.sample_token

    def record(logits, *args, **kw):
        tok = sample(logits, *args, **kw)
        top2 = np.sort(logits.reshape(-1).numpy())[-2:]
        rows.append((float(top2[1] - top2[0]), int(tok.reshape(-1)[0])))
        return tok

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TSL, "sample_token", record)
        out = TSL.generate(model, params, torch.tensor([prompt]), run,
                           max_new_tokens=n_new)
    assert [t for _, t in rows] == out[0].tolist()
    return rows


def _lockstep_partings(ref, got):
    """Each engine attempt's first decision that leaves the lockstep
    stream, as (request id, decision number, lockstep top-2 margin at
    that index).  An eviction starts a new attempt from index 0, on the
    lockstep's context again."""
    out = []
    for rid, dec in got.items():
        parted = False
        for n, (i, _, tok) in enumerate(dec):
            parted = parted and i > 0
            if not parted and tok != ref[rid][i][1]:
                out.append((rid, n, ref[rid][i][0]))
                parted = True
    return out


# (schedule, policy) → the (request id, decision number) where the int8
# engine leaves the port's own int8 lockstep; everywhere else none.
LOCKSTEP_PARTINGS = {("eviction", "rexp"): [(0, 10)]}


@pytest.mark.parametrize("schedule,impl", [
    ("roomy", "exact"), ("roomy", "rexp"), ("roomy", "lut2d"),
    ("eviction", "exact"), ("eviction", "rexp"), ("eviction", "lut2d")])
def test_int8_engine_matches_own_lockstep(models, schedule, impl):
    """Each request through the int8 engine (sharing the batch, chunked,
    paged, and on the eviction schedule preempted and prefilled again)
    makes the greedy decisions of the int8 lockstep path serving it
    alone at B = 1 over a contiguous fake-quantized cache, but at the
    partings ``LOCKSTEP_PARTINGS`` names.  The one there is the step of
    :func:`test_int8_rexp_parting_is_projection_roundoff`: the lockstep
    path, whose projections sum in another order than the chunked
    engine's, takes the JAX engine's token there."""
    _, _, tm, tp = models
    _, trun = _runs(impl, "int8")
    if schedule == "roomy":
        rng = np.random.default_rng(11)
        reqs = [(rng.integers(0, VOCAB, size=int(n)).tolist(), 8)
                for n in (5, 17, 9, 12)]
        knobs = dict(n_slots=2, n_pages=24, page_size=4, mp=8, chunk=8,
                     prefix=False)
    else:
        [reqs], knobs = _schedule(schedule)
    eng = _engine(TEngine, TEngineConfig, TCache, tm, tp, trun, knobs,
                  device="cpu")
    log = _record_decisions(eng)
    served = _drive(eng, [reqs])
    assert (eng.stats.preemptions > 0) == (schedule == "eviction")
    ref = {rid: _lockstep_decisions(tm, tp, trun, prompt, n_new)
           for rid, (prompt, n_new) in enumerate(reqs)}
    partings = _lockstep_partings(ref, log)
    _print_partings(partings)
    assert all(margin < MARGIN for _, _, margin in partings)
    assert [(rid, n) for rid, n, _ in partings] == LOCKSTEP_PARTINGS.get(
        (schedule, impl), [])
    parted = {rid for rid, _, _ in partings}
    for rid in served.keys() - parted:
        assert served[rid] == [t for _, t in ref[rid]], rid
