"""The port's decoder and serving engine against the JAX package's.

Weights come from the JAX package (``model.init``) and reach the port
through ``params_from_jax``, so both run the same parameters:
``ARCHS["qwen3-32b"]`` scaled down to d_model 64, 4/2 heads, vocab 128,
two layers, f32.

* ``prefill_chunk_paged`` / ``decode_step_paged`` logits agree within
  1e-4: XLA and torch order the f32 matmul sums differently, so the
  logits differ at roundoff, never in the integer LUT pipeline's
  decisions on these inputs.
* The CPU ``ServingEngine`` gives greedy tokens identical to the JAX
  ``ServingEngine`` under exact / rexp-uint8 / lut2d-uint8 on mixed
  prompt lengths, under eviction pressure, and with prefix caching.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import RunConfig as JRun
from repro.core.policies import SoftmaxPolicy as JPol
from repro.models import build_model as jax_build
from repro.runtime import EngineConfig as JEngineConfig
from repro.runtime import PagedCacheConfig as JCache
from repro.runtime import ServingEngine as JEngine
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import RunConfig as TRun
from repro_torch.core.policies import SoftmaxPolicy as TPol
from repro_torch.models import build_model as torch_build
from repro_torch.models import encdec as ED
from repro_torch.models import model_zoo
from repro_torch.models import transformer as TF
from repro_torch.models.convert import (cast_params, params_from_jax,
                                        pool_from_jax)
from repro_torch.models.device import resolve_device
from repro_torch.runtime.engine import EngineConfig as TEngineConfig
from repro_torch.runtime.engine import PipelinedEngine
from repro_torch.runtime.engine import ServingEngine as TEngine
from repro_torch.runtime.paged_cache import PagedCacheConfig as TCache

torch.set_num_threads(1)

IMPLS = ("exact", "rexp", "lut2d")
VOCAB = 128
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


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


def _runs(impl, paged_backend="auto"):
    kw = dict(impl=impl, precision="uint8") if impl != "exact" else {}
    return (JRun(dtype="float32", attention_backend="naive",
                 softmax_policy=JPol(**kw)),
            TRun(dtype="float32", softmax_policy=TPol(**kw),
                 paged_backend=paged_backend))


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tuple(tree.shape)


def test_params_from_jax_covers_every_leaf_once(models):
    """No leaf dropped, none invented, shapes equal, values copied
    without a transpose; the port's own init builds the same tree."""
    jm, jp, tm, tp = models
    jleaves = list(_paths(jax.tree_util.tree_map(np.asarray, jp)))
    tleaves = list(_paths(tp))
    assert len({p for p, _ in tleaves}) == len(tleaves)
    assert sorted(tleaves, key=str) == sorted(jleaves, key=str)
    wq_j = np.asarray(jp["periods"][0]["mixer"]["wq"])
    np.testing.assert_array_equal(tp["periods"][0]["mixer"]["wq"].numpy(),
                                  wq_j)
    own = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert sorted(_paths(own), key=str) == sorted(jleaves, key=str)
    bf = cast_params(tp, torch.bfloat16)
    assert bf["periods"][0]["mixer"]["wq"].dtype == torch.bfloat16
    assert bf["final_norm"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("impl", IMPLS)
def test_paged_step_logits_match(models, impl):
    """Three prompt chunks of two slots, then decode steps, with the
    same block tables and cursors on both sides."""
    jm, jp, tm, tp = models
    jrun, trun = _runs(impl)
    n_pages, ps, mp, c = 16, 4, 8, 6
    jpools = jm.init_paged_pools(n_pages, ps, jrun)
    jchunk = jax.jit(lambda *a: jm.prefill_chunk_paged(*a, jrun))
    jdecode = jax.jit(lambda *a: jm.decode_step_paged(*a, jrun))
    tpools = tm.init_paged_pools(n_pages, ps, trun, "cpu")
    rng = np.random.default_rng(IMPLS.index(impl))
    prompts = [rng.integers(0, VOCAB, size=n) for n in (14, 9)]
    bt = np.zeros((2, mp), np.int32)
    bt[0, :6] = [3, 9, 1, 12, 5, 7]
    bt[1, :6] = [2, 14, 6, 11, 8, 4]
    lens = np.zeros(2, np.int32)
    for start in range(0, 14, c):
        tok = np.zeros((2, c), np.int32)
        n = np.array([max(0, min(c, len(p) - start)) for p in prompts],
                     np.int32)
        for i, p in enumerate(prompts):
            tok[i, :n[i]] = p[start:start + n[i]]
        jl, jpools = jchunk(jp, jnp.asarray(tok), jpools, jnp.asarray(bt),
                            jnp.asarray(lens), jnp.asarray(n))
        tl = tm.prefill_chunk_paged(
            tp, torch.from_numpy(tok), tpools, torch.from_numpy(bt),
            torch.from_numpy(lens), torch.from_numpy(n), trun)
        live = n > 0
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   **LOGIT_TOL)
        lens = lens + n
    tok = np.array([[5], [17]], np.int32)
    for _ in range(3):
        jl, jpools = jdecode(jp, jnp.asarray(tok), jpools, jnp.asarray(bt),
                             jnp.asarray(lens))
        tl = tm.decode_step_paged(tp, torch.from_numpy(tok), tpools,
                                  torch.from_numpy(bt),
                                  torch.from_numpy(lens), trun)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        lens = lens + 1
    for name in ("k_pages", "v_pages"):
        np.testing.assert_allclose(tpools[0][name].numpy(),
                                   np.asarray(jpools[0][name]), **LOGIT_TOL)


def _schedule(name):
    """(requests, engine knobs) for the three engine schedules."""
    rng = np.random.default_rng({"mixed": 0, "eviction": 1, "prefix": 2}[
        name])
    if name == "mixed":       # like tests/test_engine.py::_mixed_requests
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


def _serve(engine_cls, cfg_cls, cache_cls, model, params, run, waves, knobs,
           **kw):
    eng = engine_cls(model, params, run, cfg_cls(
        n_slots=knobs["n_slots"], prefill_chunk=knobs["chunk"],
        prefix_cache=knobs["prefix"],
        cache=cache_cls(n_pages=knobs["n_pages"],
                        page_size=knobs["page_size"],
                        max_pages_per_seq=knobs["mp"])), **kw)
    out = {}
    for wave in waves:
        out.update(eng.run(wave))
    return {rid: r.tokens.tolist() for rid, r in out.items()}, eng.stats


@pytest.mark.parametrize("schedule,impl", [
    ("mixed", "exact"), ("mixed", "rexp"), ("mixed", "lut2d"),
    ("eviction", "rexp"), ("prefix", "lut2d")])
def test_engine_greedy_tokens_identical(models, schedule, impl):
    jm, jp, tm, tp = models
    jrun, trun = _runs(impl)
    waves, knobs = _schedule(schedule)
    jtok, jstats = _serve(JEngine, JEngineConfig, JCache, jm, jp, jrun,
                          waves, knobs)
    ttok, tstats = _serve(TEngine, TEngineConfig, TCache, tm, tp, trun,
                          waves, knobs, device="cpu")
    assert ttok == jtok
    for field in ("steps", "prefill_steps", "prompt_tokens", "preemptions",
                  "prefix_hit_tokens", "cow_copies", "tokens"):
        assert getattr(tstats, field) == getattr(jstats, field), field
    if schedule == "eviction":
        assert tstats.preemptions > 0
    if schedule == "prefix":
        assert tstats.prefix_hit_tokens > 0 and tstats.cow_copies > 0


def test_engine_sampling_replays_by_seed(models):
    """Sampled streams cannot match JAX's threefry; they replay exactly
    from the same seed and do not depend on the batch's composition."""
    _, _, tm, tp = models
    _, trun = _runs("rexp")
    cfg = TEngineConfig(n_slots=2, cache=TCache(n_pages=24, page_size=4,
                                                max_pages_per_seq=8))

    def sample(extra):
        eng = TEngine(tm, tp, trun, cfg, device="cpu")
        h = eng.add_request([1, 2, 3], 10, temperature=1.0, seed=7)
        for p in extra:
            eng.add_request(p, 6, temperature=1.0, seed=3)
        return h.result().tokens.tolist()

    alone = sample([])
    assert sample([]) == alone
    assert sample([[9, 9, 9, 9, 9], [4]]) == alone


def test_engine_refuses_what_is_not_ported(models):
    _, _, tm, tp = models
    _, trun = _runs("rexp")
    cache = TCache(n_pages=8, page_size=4, max_pages_per_seq=4)
    with pytest.raises(TypeError, match="mesh"):
        TEngine(tm, tp, trun, TEngineConfig(cache=cache, mesh=object()),
                device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        TEngine(tm, tp, trun, TEngineConfig(cache=cache, kv_dtype="int4"),
                device="cpu")
    with pytest.raises(ValueError, match="max_lk"):
        TEngine(tm, tp, dataclasses.replace(
            trun, softmax_policy=TPol(impl="rexp", precision="int16")),
            TEngineConfig(cache=TCache(n_pages=8, page_size=64,
                                       max_pages_per_seq=16)), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TEngine(tm, tp, trun, TEngineConfig(cache=cache))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.init(torch.Generator().manual_seed(0))


DEVICE_DEFAULTS = {
    "transformer.init_params": lambda: TF.init_params(
        _arch(TARCHS), torch.Generator().manual_seed(0)),
    "encdec.init_params": lambda: ED.init_params(
        TARCHS["whisper-small"].scaled_down(d_model=64, n_heads=4, vocab=128),
        torch.Generator().manual_seed(0)),
    "encdec.sinusoidal_positions": lambda: ED.sinusoidal_positions(8, 64),
    "convert.params_from_jax": lambda: params_from_jax(
        {"w": np.zeros((2, 2), np.float32)}),
    "convert.pool_from_jax": lambda: pool_from_jax(
        {"k_pages": np.zeros((2, 4, 1, 8), np.float32)}),
    "engine.PipelinedEngine": lambda: PipelinedEngine(
        torch_build(_arch(TARCHS)), {}, TRun(dtype="float32"),
        TEngineConfig(cache=TCache(n_pages=8, page_size=4,
                                   max_pages_per_seq=4))),
}


@pytest.mark.parametrize("entry", sorted(DEVICE_DEFAULTS))
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """Every entry point that allocates puts its tensors on the card unless
    the caller passes ``device="cpu"``: with no CUDA device each raises,
    through the one ``resolve_device`` that ``model_zoo`` also exports."""
    assert model_zoo.resolve_device is resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DEVICE_DEFAULTS[entry]()
