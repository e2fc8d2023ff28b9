"""The port's MoE FFN and MoE decoders against the JAX package's.

* ``models.moe.apply_moe`` against ``repro.models.moe.apply_moe`` on the
  same numpy weights and inputs, f32: with and without shared experts;
  router exact, REXP uint8 and 2D-LUT uint8; a padded tail group; exact
  ties among router probabilities; 1024 tokens in one group with a
  skewed router, where assignments are dropped.  The expert indices and
  the kept mask equal the JAX routing's exactly (its ``lax.top_k`` and
  cumulative-sum slots, evaluated here in JAX on the JAX probabilities),
  and the outputs agree within 1e-5 · max|out| (f32 products summed in
  other orders).
* DeepSeek-MoE-16B and Granite-MoE-3B scaled down (d_model 64, 4 heads,
  vocab 128, two layers, 4 experts, top-2; DeepSeek's 2 shared experts
  kept, Granite's tied embeddings): the port's ``ServingEngine`` gives
  the JAX ``ServingEngine``'s greedy tokens under exact, REXP and 2D-LUT
  attention, with the router exact and REXP, on the mixed, eviction and
  prefix schedules of ``tests/test_torch_model.py``, on f32 and int8
  pools; so does the ``PipelinedEngine``; the lockstep ``generate``
  gives the JAX lockstep path's tokens.
* The parameter tree converts leaf for leaf, ``cast_params`` keeps the
  router f32, and ``shard_params`` cuts an MoE arch's experts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import RunConfig as JRun
from repro.core.lut_softmax import make_softmax_fn as j_softmax_fn
from repro.core.policies import SoftmaxPolicy as JPol
from repro.models import build_model as jax_build
from repro.models import moe as JMOE
from repro.runtime import EngineConfig as JEngineConfig
from repro.runtime import PagedCacheConfig as JCache
from repro.runtime import ServingEngine as JEngine
from repro.runtime import serve_loop as JSL
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import RunConfig as TRun
from repro_torch.core.policies import SoftmaxPolicy as TPol
from repro_torch.models import build_model as torch_build
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TF
from repro_torch.models.convert import cast_params, params_from_jax
from repro_torch.runtime import partitioning as PT
from repro_torch.runtime import serve_loop as TSL
from repro_torch.runtime.engine import EngineConfig as TEngineConfig
from repro_torch.runtime.engine import PipelinedEngine
from repro_torch.runtime.engine import ServingEngine as TEngine
from repro_torch.runtime.paged_cache import PagedCacheConfig as TCache

torch.set_num_threads(1)

VOCAB = 128
ARCH_NAMES = ("deepseek-moe-16b", "granite-moe-3b-a800m")
IMPLS = ("exact", "rexp", "lut2d")
OUT_TOL = 1e-5                 # of max|out|


def _kw(impl):
    return dict(impl=impl, precision="uint8") if impl != "exact" else {}


# ---------------------------------------------------------------------------
# apply_moe
# ---------------------------------------------------------------------------


def _jax_routing(jp, x, *, n_experts, top_k, capacity_factor, policy,
                 group_size):
    """The JAX package's routing (``repro/models/moe.py``, the lines from
    the router logits to ``keep``), evaluated in JAX: expert indices and
    kept mask of the real (unpadded) tokens."""
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    t = xt.shape[0]
    logits = xt.astype(jnp.float32) @ jnp.asarray(jp["router"])
    probs = j_softmax_fn(policy)(logits, axis=-1)
    _, gate_idx = jax.lax.top_k(probs, top_k)
    g = min(group_size, t)
    n_groups = -(-t // g)
    gate_idx = jnp.pad(gate_idx, [(0, n_groups * g - t), (0, 0)])
    capacity = max(int(capacity_factor * top_k * g / n_experts),
                   min(g, 256))
    assign = jax.nn.one_hot(gate_idx.reshape(n_groups, g, top_k), n_experts,
                            dtype=jnp.int32)
    flat = assign.reshape(n_groups, g * top_k, n_experts)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - flat).reshape(assign.shape)
                  * assign, axis=-1)
    keep = (pos < capacity).reshape(-1, top_k)[:t]
    return np.asarray(gate_idx[:t]), np.asarray(keep)


def _moe_case(name):
    """(weights, x, knobs) of an ``apply_moe`` case, from numpy seeds."""
    d, f = 32, 24
    e, k, shared, group = 8, 2, 0, 4096
    b, s, router, skew, tie = 2, 7, "exact", 0.0, False
    if name.startswith("shared"):
        shared = 2
    if name.endswith("-rexp"):
        router = "rexp"
    elif name.endswith("-lut2d"):
        router = "lut2d"
    if name == "tail":                 # 3 groups of 5: the last padded
        b, s, group, shared, router = 1, 13, 5, 1, "rexp"
    if name == "ties":                 # columns equal in pairs
        e, k, tie = 6, 3, True
    if name == "drops":                # 1024 tokens, one group, skewed
        b, s, skew = 1, 1024, 4.0
    seed = MOE_CASES.index(name)
    rng = np.random.default_rng(seed)
    jp = jax.tree_util.tree_map(np.asarray, JMOE.init_moe(
        jax.random.PRNGKey(seed), d, f, e, shared))
    router_w = np.array(jp["router"])
    if tie:
        router_w[:, 1::2] = router_w[:, 0::2]
    router_w[:, 0] += skew / np.sqrt(d)
    jp["router"] = router_w
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    if skew:
        x += 1.0
    return jp, x, dict(n_experts=e, top_k=k, capacity_factor=1.25,
                       group_size=group, router=router)


MOE_CASES = ["plain-exact", "plain-rexp", "plain-lut2d", "shared-exact",
             "shared-rexp", "shared-lut2d", "tail", "ties", "drops"]


@pytest.mark.parametrize("name", MOE_CASES)
def test_apply_moe_matches_jax(name):
    jp, x, kn = _moe_case(name)
    router = kn.pop("router")
    out_j, _ = JMOE.apply_moe(jp, jnp.asarray(x), router_policy=JPol(
        **_kw(router)), return_aux=False, **kn)
    tp = params_from_jax(jp, device="cpu")
    pol = TPol(**_kw(router))
    out_t = TMOE.apply_moe(tp, torch.from_numpy(x), router_policy=pol, **kn)
    ref = np.asarray(out_j)
    assert out_t.shape == x.shape and out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), ref, rtol=0,
                               atol=OUT_TOL * np.abs(ref).max())
    idx_j, keep_j = _jax_routing(jp, x, policy=JPol(**_kw(router)), **kn)
    _, idx_t, _, keep_t, _, _ = TMOE.route(
        tp, torch.from_numpy(x).reshape(-1, x.shape[-1]), router_policy=pol,
        **kn)
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    np.testing.assert_array_equal(keep_t.numpy(), keep_j)
    if name == "drops":
        assert not keep_j.all(), "the skewed router dropped nothing"
    else:
        assert keep_j.all()
    if name == "ties":
        logits = x.reshape(-1, x.shape[-1]) @ jp["router"]
        assert (logits[:, 0::2] == logits[:, 1::2]).all()
        assert (idx_j[:, 0] % 2 == 0).all()   # the lower of a tied pair


def test_apply_moe_keeps_dtype_and_rounds_gates_like_jax():
    """bf16: dispatch exact, ``silu`` in f32 cast back, the gate weights
    rounded to bf16 before they weigh the expert outputs — within bf16
    roundoff of the JAX package (one bf16 ulp of max|out|, both sides
    summing f32 products of bf16 values in other orders)."""
    jp, x, kn = _moe_case("shared-exact")
    kn.pop("router")
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(JMOE.apply_moe(jp, xb, return_aux=False, **kn)[0]
                     .astype(jnp.float32))
    tp = cast_params(params_from_jax(jp, device="cpu"), torch.bfloat16)
    out = TMOE.apply_moe(tp, torch.from_numpy(x).to(torch.bfloat16), **kn)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                               atol=2 ** -7 * np.abs(ref).max())


def test_capacity_and_top_k_ties():
    assert TMOE.capacity(4096, 64, 6, 1.25) == 480
    assert TMOE.capacity(4, 64, 6, 1.25) == 4           # decode: no drop
    assert TMOE.capacity(1024, 8, 2, 1.25) == 320
    probs = torch.tensor([[0.25, 0.25, 0.5, 0.0], [0.0, 0.0, 0.0, 0.0]])
    vals, idx = TMOE.top_k_experts(probs, 3)
    assert idx.tolist() == [[2, 0, 1], [0, 1, 2]]
    assert vals[0].tolist() == [0.5, 0.25, 0.25]


# ---------------------------------------------------------------------------
# The scaled-down MoE decoders through the engines
# ---------------------------------------------------------------------------


def _arch(archs, name):
    return archs[name].scaled_down(d_model=64, n_heads=4, vocab=VOCAB,
                                   n_periods=2)


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in ARCH_NAMES:
        jm, tm = jax_build(_arch(JARCHS, name)), torch_build(_arch(TARCHS,
                                                                  name))
        jp = jm.init(jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")
        out[name] = (jm, jp, tm, tp)
    return out


def _runs(impl, router, kv_dtype="f32"):
    return (JRun(dtype="float32", attention_backend="naive",
                 softmax_policy=JPol(**_kw(impl)),
                 router_policy=JPol(**_kw(router)), kv_dtype=kv_dtype),
            TRun(dtype="float32", softmax_policy=TPol(**_kw(impl)),
                 router_policy=TPol(**_kw(router)), kv_dtype=kv_dtype))


def _schedule(name):
    """(request waves, engine knobs): the schedules of
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
              for n in (5, 1)] + [(pre, 4)]
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


#: (schedule, attention softmax, router softmax, KV pool): every
#: attention policy under both routers on each schedule on the f32 pool,
#: and each schedule under both routers on the int8 pool
ENGINE_CASES = (
    [(sched, impl, router, "f32") for sched in ("mixed", "eviction",
                                                "prefix")
     for impl in IMPLS for router in ("exact", "rexp")]
    + [(sched, impl, router, "int8")
       for sched, impl in (("mixed", "rexp"), ("eviction", "lut2d"),
                           ("prefix", "exact"))
       for router in ("exact", "rexp")])


@pytest.fixture(scope="module")
def jax_runs(models):
    """The JAX ``ServingEngine``'s tokens and stats by (arch, case), run
    once: the sync and the pipelined tests compare against the same
    run."""
    done = {}

    def get(arch, sched, impl, router, kv):
        key = (arch, sched, impl, router, kv)
        if key not in done:
            jm, jp, _, _ = models[arch]
            waves, knobs = _schedule(sched)
            done[key] = _serve(JEngine, JEngineConfig, JCache, jm, jp,
                               _runs(impl, router, kv)[0], waves, knobs)
        return done[key]
    return get


@pytest.mark.parametrize("case", ENGINE_CASES, ids="-".join)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_engine_greedy_tokens_identical(models, jax_runs, arch, case):
    sched, impl, router, kv = case
    _, _, tm, tp = models[arch]
    jtok, jstats = jax_runs(arch, *case)
    waves, knobs = _schedule(sched)
    ttok, tstats = _serve(TEngine, TEngineConfig, TCache, tm, tp,
                          _runs(impl, router, kv)[1], waves, knobs,
                          device="cpu")
    assert ttok == jtok
    for field in ("steps", "prefill_steps", "prompt_tokens", "preemptions",
                  "prefix_hit_tokens", "cow_copies", "tokens"):
        assert getattr(tstats, field) == getattr(jstats, field), field
    if sched == "eviction":
        assert tstats.preemptions > 0
    if sched == "prefix":
        assert tstats.prefix_hit_tokens > 0 and tstats.cow_copies > 0


PIPELINED_CASES = [("mixed", "rexp", "rexp", "f32"),
                   ("eviction", "lut2d", "exact", "f32"),
                   ("prefix", "exact", "rexp", "int8")]


@pytest.mark.parametrize("case", PIPELINED_CASES, ids="-".join)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_pipelined_engine_tokens_identical(models, jax_runs, arch, case):
    """The ``PipelinedEngine`` (sampling on the device, one step
    dispatched ahead) gives the JAX sync engine's greedy tokens."""
    _, _, tm, tp = models[arch]
    jtok, jstats = jax_runs(arch, *case)
    waves, knobs = _schedule(case[0])
    ttok, tstats = _serve(PipelinedEngine, TEngineConfig, TCache, tm, tp,
                          _runs(*case[1:])[1], waves, knobs, device="cpu")
    assert ttok == jtok
    assert tstats.tokens == jstats.tokens


@pytest.mark.parametrize("impl,router,kv", [
    ("exact", "exact", "f32"), ("rexp", "rexp", "f32"),
    ("lut2d", "exact", "f32"), ("rexp", "exact", "int8")])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_lockstep_generate_matches_jax(models, arch, impl, router, kv):
    """``serve_loop.generate`` (whole prompts through the MoE FFN in one
    group, then B-token decode steps) gives the JAX lockstep tokens."""
    jm, jp, tm, tp = models[arch]
    jrun, trun = _runs(impl, router, kv)
    prompt = np.random.default_rng(3).integers(0, VOCAB, size=(3, 11)) \
        .astype(np.int32)
    ref = JSL.generate(jm, jp, jnp.asarray(prompt), jrun, max_new_tokens=10)
    out = TSL.generate(tm, tp, torch.from_numpy(prompt), trun,
                       max_new_tokens=10)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _paths(tree):
    return [(p, tuple(leaf.shape)) for p, leaf in _leaves(tree)]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_params_from_jax_covers_every_moe_leaf_once(models, arch):
    """Every leaf once, shapes equal, values copied as they are; the
    port's own init builds the same tree, and its bf16 init equals
    ``cast_params`` of its f32 init with the router and norms f32."""
    jm, jp, tm, tp = models[arch]
    jleaves = list(_paths(jax.tree_util.tree_map(np.asarray, jp)))
    tleaves = list(_paths(tp))
    assert len({p for p, _ in tleaves}) == len(tleaves)
    assert sorted(tleaves, key=str) == sorted(jleaves, key=str)
    ffn = {p[3:] for p, _ in tleaves if p[:3] == ("periods", 0, "ffn")}
    want = {("router",), ("w_gate",), ("w_up",), ("w_down",)}
    if tm.cfg.moe.n_shared:
        want |= {("shared", "w_gate"), ("shared", "w_up"),
                 ("shared", "w_down")}
    assert ffn == want
    for leaf in ("router", "w_gate", "w_down"):
        np.testing.assert_array_equal(
            tp["periods"][0]["ffn"][leaf].numpy(),
            np.asarray(jp["periods"][0]["ffn"][leaf]))
    own = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert sorted(_paths(own), key=str) == sorted(jleaves, key=str)
    bf = tm.init(torch.Generator().manual_seed(0), device="cpu",
                 dtype=torch.bfloat16)
    cast = dict(_leaves(cast_params(own, torch.bfloat16)))
    for path, leaf in _leaves(bf):
        assert leaf.dtype == cast[path].dtype and torch.equal(leaf,
                                                              cast[path])
    ffn_bf = bf["periods"][0]["ffn"]
    assert ffn_bf["router"].dtype == torch.float32
    assert ffn_bf["w_gate"].dtype == torch.bfloat16
    assert bf["periods"][0]["norm2"]["scale"].dtype == torch.float32


def test_shard_params_refuses_an_moe_arch(models):
    """``shard_params`` (and an engine with ``shard_params``) cuts an MoE
    arch's experts by the JAX package's 3-D rules: at tp 2 each rank
    holds 2 of the 4 experts whole, the shared MLP by its columns and
    rows, the router whole; the parts reassemble the leaves."""
    _, _, tm, tp = models["deepseek-moe-16b"]
    cuts = [PT.shard_params(tp, tm.cfg, PT.Mesh(
        tp=2, rank=r, device=torch.device("cpu"), backend="gloo"))
        for r in range(2)]
    whole = tp["periods"][0]["ffn"]
    for leaf in ("w_gate", "w_up", "w_down"):
        parts = [c["periods"][0]["ffn"][leaf] for c in cuts]
        assert parts[0].shape[1] == 2 == whole[leaf].shape[1] // 2
        assert torch.equal(torch.cat(parts, 1), whole[leaf])
    for leaf, axis in (("w_gate", 2), ("w_up", 2), ("w_down", 1)):
        parts = [c["periods"][0]["ffn"]["shared"][leaf] for c in cuts]
        assert torch.equal(torch.cat(parts, axis), whole["shared"][leaf])
    assert all(c["periods"][0]["ffn"]["router"] is whole["router"]
               for c in cuts)
    mesh = PT.Mesh(tp=2, rank=1, device=torch.device("cpu"), backend="gloo")
    eng = TEngine(tm, tp, _runs("rexp", "exact")[1], TEngineConfig(
        mesh=mesh, shard_params=True,
        cache=TCache(n_pages=8, page_size=4, max_pages_per_seq=4)),
        device="cpu")
    assert torch.equal(eng.params["periods"][0]["ffn"]["w_up"],
                       cuts[1]["periods"][0]["ffn"]["w_up"])
    assert PT.shard_params(tp, tm.cfg, None) is tp


def test_paged_path_accepts_moe_and_refuses_other_ffn():
    TF.check_paged_supported(TARCHS["deepseek-moe-16b"])
    TF.check_paged_supported(TARCHS["granite-moe-3b-a800m"])
    from repro_torch.configs.base import LayerSpec
    odd = dataclasses.replace(TARCHS["qwen3-32b"],
                              period=(LayerSpec(ffn="none"),))
    with pytest.raises(NotImplementedError, match="MLP or MoE"):
        TF.check_paged_supported(odd)


def test_run_config_router_policy_mirrors_jax():
    assert TRun().router_policy == TPol() and JRun().router_policy == JPol()


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("engine", ["continuous", "pipelined", "lockstep"])
def test_launcher_serves_the_moe_archs(capsys, arch, engine):
    """``--arch`` takes both MoE configs (scaled down on the CPU), and
    every engine serves them."""
    from repro_torch.launch import serve as SERVE
    base = ["--arch", arch, "--scale-down", "64,4,128", "--layers", "2",
            "--device", "cpu", "--batch", "2", "--prompt-len", "12",
            "--new-tokens", "5"]
    SERVE.main(base + ["--engine", engine])
    out = capsys.readouterr().out
    assert f"{arch} x2 layers on cpu" in out
    assert "sample token ids:" in out


def test_launcher_refuses_shard_params_on_an_moe_arch():
    """``--tp 2 --shard-params`` serves both MoE archs with their experts
    cut over the ranks and prints ``--tp 1``'s sample tokens."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for arch in ARCH_NAMES:
        outs = []
        for extra in ([], ["--tp", "2", "--shard-params"]):
            out = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                 arch, "--scale-down", "64,4,128", "--layers", "2",
                 "--device", "cpu", "--batch", "2", "--prompt-len", "12",
                 "--new-tokens", "5", *extra],
                env=dict(os.environ, PYTHONPATH=os.path.join(repo, "src")),
                capture_output=True, text=True, timeout=300)
            assert out.returncode == 0, out.stderr
            outs.append(out.stdout)
        assert "weights cut over the ranks" in outs[1]
        tokens = [[ln for ln in o.splitlines()
                   if ln.startswith("sample token")] for o in outs]
        assert tokens[0] and tokens[1] == tokens[0], arch
