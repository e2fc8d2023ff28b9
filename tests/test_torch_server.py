"""The port's asyncio front end (``repro_torch.runtime.server``) against
the JAX package's ``tests/test_server.py``: streaming, admission control
and failure propagation over the engine's driver thread, on the CPU.

Weights come from the JAX package through ``params_from_jax``
(Qwen3-32B scaled down to d_model 64, 4/2 heads, vocab 128, two layers,
f32, REXP uint8).  Each test owns its loop via ``asyncio.run``; every
wait has a timeout.  The launcher's ``--serve`` path is driven at the
end.
"""

import asyncio

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
from repro_torch.configs import RunConfig
from repro_torch.core.policies import SoftmaxPolicy
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import (AsyncServingServer, EngineConfig,
                                 PagedCacheConfig, PipelinedEngine,
                                 ServerSaturatedError, ServingEngine)

torch.set_num_threads(1)

CACHE = PagedCacheConfig(n_pages=40, page_size=8, max_pages_per_seq=8)
TIMEOUT = 60


def _arch(archs):
    return archs["qwen3-32b"].scaled_down(d_model=64, n_heads=4,
                                          n_kv_heads=2, vocab=128,
                                          n_periods=2)


@pytest.fixture(scope="module")
def models():
    jm = jax_build(_arch(JARCHS))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jm, jp, build_model(_arch(TARCHS)), tp


@pytest.fixture(scope="module")
def small_lm(models):
    return models[2:]


def _run_cfg():
    return RunConfig(dtype="float32", softmax_policy=SoftmaxPolicy(
        impl="rexp", precision="uint8"))


def _engine(small_lm, cls=PipelinedEngine, **over):
    model, params = small_lm
    cfg = EngineConfig(**{"n_slots": 2, "cache": CACHE, **over})
    return cls(model, params, _run_cfg(), cfg, device="cpu")


def _requests(temperatures):
    rng = np.random.default_rng(0)
    return [dict(prompt=rng.integers(0, 128, size=int(n)).tolist(),
                 max_new_tokens=int(m), temperature=t, seed=i)
            for i, ((n, m), t) in enumerate(zip(
                [(9, 8), (17, 12), (4, 6), (24, 10), (6, 14), (12, 9)],
                temperatures))]


def _serve_all(engine, reqs, **server_kw):
    """Submit every request concurrently, consume each stream with
    ``async for``; (streamed tokens, result) per request."""
    async def go():
        async with AsyncServingServer(engine, **server_kw) as srv:
            streams = [await srv.submit(**r) for r in reqs]

            async def consume(stream):
                toks = [tok async for tok in stream]
                return toks, await stream.result()

            return await asyncio.wait_for(
                asyncio.gather(*map(consume, streams)), TIMEOUT)
    return asyncio.run(go())


def test_server_streams_match_sync_engine(small_lm):
    """Concurrent streamed requests, greedy and sampled, yield token for
    token exactly what the synchronous engine gives for the same set."""
    reqs = _requests([0.0, 0.9, 0.0, 1.1, 0.0, 0.7])
    ref = _engine(small_lm, ServingEngine).run([dict(r) for r in reqs])
    outs = _serve_all(_engine(small_lm), reqs)
    for i, (toks, res) in enumerate(outs):
        np.testing.assert_array_equal(toks, ref[i].tokens,
                                      err_msg=f"request {i} (streamed)")
        np.testing.assert_array_equal(res.tokens, ref[i].tokens,
                                      err_msg=f"request {i} (result)")
        assert res.finish_reason == ref[i].finish_reason
        assert res.ttft_s is not None


@pytest.mark.parametrize("cls", [PipelinedEngine, ServingEngine],
                         ids=["pipelined", "sync"])
def test_server_greedy_streams_match_jax_pipelined(models, cls):
    """Greedy streams through the server over either port engine equal
    the JAX ``PipelinedEngine``'s batch results."""
    jm, jp, tm, tp = models
    reqs = _requests([0.0] * 6)
    jeng = JPipelined(jm, jp, JRun(
        dtype="float32", attention_backend="naive",
        softmax_policy=JPol(impl="rexp", precision="uint8")),
        JEngineConfig(n_slots=2, cache=JCache(n_pages=40, page_size=8,
                                              max_pages_per_seq=8)))
    ref = jeng.run([dict(r) for r in reqs])
    outs = _serve_all(_engine((tm, tp), cls), reqs, max_queue=2,
                      backpressure="wait")
    for i, (toks, res) in enumerate(outs):
        assert toks == ref[i].tokens.tolist(), f"request {i}"
        assert res.tokens.tolist() == toks


def test_server_backpressure_reject(small_lm):
    """``max_queue`` bounds waiting requests: with the one slot busy and
    one request waiting, the next submit is shed; the queued work still
    completes and admission works again afterwards."""
    async def go():
        async with AsyncServingServer(_engine(small_lm, n_slots=1),
                                      max_queue=1) as srv:
            prompt = list(range(8))
            long = await srv.submit(prompt, 48)   # takes the only slot
            while srv._n_waiting:                 # wait out its credit
                await asyncio.sleep(0.001)
            queued = await srv.submit(prompt, 4)  # waits (queue now full)
            with pytest.raises(ServerSaturatedError):
                await srv.submit(prompt, 4)
            r_long, r_queued = await asyncio.wait_for(
                asyncio.gather(long.result(), queued.result()), TIMEOUT)
            assert len(r_long.tokens) == 48 and len(r_queued.tokens) == 4
            retry = await srv.submit(prompt, 3)
            assert len((await retry.result()).tokens) == 3
    asyncio.run(go())


def test_server_backpressure_wait(small_lm):
    """``backpressure='wait'`` parks submit until a waiting request takes
    a slot, instead of shedding it."""
    async def go():
        async with AsyncServingServer(_engine(small_lm, n_slots=1),
                                      max_queue=1,
                                      backpressure="wait") as srv:
            prompt = list(range(8))
            long = await srv.submit(prompt, 48)
            while srv._n_waiting:
                await asyncio.sleep(0.001)
            queued = await srv.submit(prompt, 4)
            parked = asyncio.ensure_future(srv.submit(prompt, 5))
            await asyncio.sleep(0)          # let it hit the bound
            assert not parked.done(), "submit must block at the bound"
            stream = await asyncio.wait_for(parked, timeout=TIMEOUT)
            results = await asyncio.wait_for(asyncio.gather(
                long.result(), queued.result(), stream.result()), TIMEOUT)
            assert [len(r.tokens) for r in results] == [48, 4, 5]
    asyncio.run(go())


def test_server_bad_request_fails_its_stream_only(small_lm):
    """A prompt past the cache's context fails its own stream with the
    engine's ValueError, without poisoning the server or leaking its
    admission credit."""
    async def go():
        async with AsyncServingServer(_engine(small_lm),
                                      max_queue=2) as srv:
            bad = await srv.submit(list(range(CACHE.max_context + 1)), 4)
            with pytest.raises(ValueError):
                await bad.result()
            with pytest.raises(ValueError):
                async for _ in bad:
                    pass
            ok = await srv.submit(list(range(6)), 5)
            assert len((await ok.result()).tokens) == 5
            assert srv._n_waiting == 0
    asyncio.run(go())


def test_server_shutdown_fails_inflight_streams(small_lm):
    """Shutdown mid-generation: awaiting clients get a RuntimeError
    instead of hanging, and the driver thread has ended."""
    async def go():
        srv = AsyncServingServer(_engine(small_lm, n_slots=1))
        await srv.start()
        thread = srv._thread
        streams = [await srv.submit(list(range(8)), 48) for _ in range(3)]
        waiter = asyncio.ensure_future(streams[-1].result())
        await srv.shutdown()
        assert not thread.is_alive()
        with pytest.raises(RuntimeError, match="shut down"):
            await asyncio.wait_for(waiter, timeout=10)
    asyncio.run(go())


def test_server_lifecycle_and_arg_validation(small_lm):
    eng = _engine(small_lm)
    with pytest.raises(ValueError, match="backpressure"):
        AsyncServingServer(eng, backpressure="drop")
    with pytest.raises(ValueError, match="max_queue"):
        AsyncServingServer(eng, max_queue=0)

    async def go():
        srv = AsyncServingServer(eng)
        with pytest.raises(RuntimeError, match="not started"):
            await srv.submit([1, 2], 2)
        await srv.start()
        with pytest.raises(RuntimeError, match="already started"):
            await srv.start()
        await srv.shutdown()
        await srv.shutdown()   # idempotent
    asyncio.run(go())


def test_request_handle_done_under_concurrent_completion(small_lm):
    """A handle whose request another handle's ``result()`` finished
    reports done without stepping further, and its stream saw exactly
    the returned tokens."""
    eng = _engine(small_lm)
    rng = np.random.default_rng(1)
    streamed = []
    h_a = eng.add_request(rng.integers(0, 128, size=6).tolist(), 4,
                          on_token=streamed.append)
    h_b = eng.add_request(rng.integers(0, 128, size=20).tolist(), 12)
    res_b = h_b.result()
    assert h_b.done and len(res_b.tokens) == 12
    assert h_a.done
    steps_before = eng.stats.steps
    res_a = h_a.result()
    assert eng.stats.steps == steps_before, "done handle must not step"
    assert streamed == list(res_a.tokens) and len(res_a.tokens) == 4


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

ARGV = ["--arch", "qwen3-32b", "--scale-down", "64,4,128", "--layers", "2",
        "--device", "cpu", "--batch", "3", "--prompt-len", "12",
        "--new-tokens", "6"]


def _sample_line(out):
    return [line for line in out.splitlines()
            if line.startswith("sample token ids:")]


@pytest.mark.parametrize("extra", [[], ["--temperature", "0.8"],
                                   ["--prefix-cache", "--prefill-budget",
                                    "32"]],
                         ids=["greedy", "sampled", "prefix"])
def test_launcher_pipelined_serve_matches_continuous(capsys, extra):
    """``--engine pipelined --serve`` streams the sample token ids that
    ``--engine continuous`` prints for the same seed (and
    ``--engine pipelined`` without ``--serve`` too)."""
    serve.main(ARGV + extra + ["--engine", "continuous"])
    want = _sample_line(capsys.readouterr().out)
    assert len(want) == 1
    serve.main(ARGV + extra + ["--engine", "pipelined"])
    assert _sample_line(capsys.readouterr().out) == want
    serve.main(ARGV + extra + ["--engine", "pipelined", "--serve",
                               "--max-queue", "2", "--backpressure", "wait",
                               "--pipeline-depth", "3"])
    out = capsys.readouterr().out
    assert _sample_line(out) == want
    assert "PipelinedEngine" in out and "server: clean shutdown" in out
    assert out.count("streamed 6 tokens") == (6 if "--prefix-cache" in extra
                                              else 3)


def test_launcher_flag_checks(capsys):
    with pytest.raises(SystemExit):
        serve.main(ARGV + ["--engine", "lockstep", "--serve"])
    assert "--serve requires" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        serve.main(ARGV + ["--engine", "lockstep", "--prefix-cache"])
    with pytest.raises(ValueError, match="pipeline_depth"):
        serve.main(ARGV + ["--engine", "pipelined", "--pipeline-depth", "0"])
