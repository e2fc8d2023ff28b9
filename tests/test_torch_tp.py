"""Tensor-parallel paged serving in the port against the JAX package.

The port's counterpart of ``tests/test_engine_tp.py``.  The JAX package
runs its mesh from one process (4 forced host devices, ``shard_map``);
the port runs one process a rank over ``torch.distributed``: here 4
spawned gloo ranks over a ``file://`` store in ``tmp_path``
(``repro_torch.launch.mesh.start_ranks``; no network), on the CPU,
through the plain versions of the paged kernels.  One spawn serves every
engine case (``torch_tp_ranks.engine_cases``) while this process runs
the references:

* the JAX single-device ``ServingEngine`` on the same numpy weights and
  requests (every case), and the JAX TP engine on its 4-device mesh in a
  subprocess (the three regimes under REXP), as ``test_engine_tp.py``
  runs it;
* the port's own single-device engine, for what the JAX package cannot
  give: sampled tokens (the port's counter-hash sampler is not JAX's
  threefry stream) and the logits of ``shard_params``.

Regimes: ``'heads'`` with KVH = H = 4, ``'heads'`` GQA (KVH 4, H 8), and
``'pages'`` with KVH = 1 (slabs of pages, max/Σ/σ·V partials).  Token
identity holds for exact, REXP and 2D-LUT, f32 and int8 pools, prefix
copy-on-write, pipelined engines, evictions with staggered arrivals and
cut weights.  The collective log bounds the wire: a decode step moves
only ``(B, H, 1)`` max and Σ plus ``(B, H, 1, D)`` outputs (plus
``(B, d_model)`` activations under ``shard_params``), and the one
KV-shaped transfer is a cross-slab copy-on-write page.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.compat import make_abstract_mesh
from repro.configs import ARCHS as JARCHS
from repro.configs import RunConfig as JRun
from repro.core.policies import SoftmaxPolicy as JPol
from repro.kernels.lut_attention.ops import paged_mesh_regime as j_regime
from repro.models import build_model as jax_build
from repro.runtime import EngineConfig as JEngineConfig
from repro.runtime import PagedCacheConfig as JCache
from repro.runtime import ServingEngine as JEngine
from repro.runtime import paged_cache as JPC
from repro.runtime import partitioning as JPT
from repro_torch.kernels.lut_attention.ops import paged_mesh_regime
from repro_torch.launch import serve as SERVE
from repro_torch.launch.mesh import check_backend, start_ranks
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import paged_cache as TPC
from repro_torch.runtime import partitioning as PT
from repro_torch.runtime.engine import EngineConfig

import torch_tp_ranks as R

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TP = 4
IMPLS = ("exact", "rexp", "lut2d")
CACHE = (30, 8, 8)            # n_pages, page_size, max_pages_per_seq
TINY = (10, 8, 8)             # forces evictions
#: the JAX suite's three regimes: (kvh, heads) → name
REGIMES = {(4, 4): "heads", (4, 8): "heads-gqa", (1, 4): "pages"}


def _reqs(seed, spec, temps=None):
    rng = np.random.default_rng(seed)
    return [dict(prompt=rng.integers(0, R.VOCAB, size=int(n)).tolist(),
                 max_new_tokens=int(m),
                 temperature=float(temps[i]) if temps else 0.0, seed=i)
            for i, (n, m) in enumerate(spec)]


def _prefix_reqs(ps=8):
    rng = np.random.default_rng(11)
    pre = rng.integers(0, R.VOCAB, size=2 * ps).tolist()
    return [dict(prompt=pre + rng.integers(0, R.VOCAB, size=t).tolist(),
                 max_new_tokens=int(m), temperature=0.0, seed=i)
            for i, (t, m) in enumerate([(5, 6), (0, 7), (ps, 5), (0, 6),
                                        (3, 8)])]


def _cases():
    ident = [(9, 7), (21, 6), (4, 8), (14, 5)]
    cases = []
    for (kvh, heads), tag in REGIMES.items():
        for impl in IMPLS:
            cases.append(dict(name=f"ident-{tag}-{impl}", kvh=kvh,
                              heads=heads, impl=impl, cache=CACHE, chunk=5,
                              requests=_reqs(3, ident)))
    for kvh in (4, 1):
        for impl in ("exact", "rexp"):
            cases.append(dict(name=f"int8-{REGIMES[kvh, 4]}-{impl}",
                              kvh=kvh, heads=4, impl=impl, kv_dtype="int8",
                              cache=CACHE, chunk=5,
                              requests=_reqs(5, ident)))
    cases.append(dict(name="int8-cow-pages", kvh=1, heads=4, impl="lut2d",
                      kv_dtype="int8", cache=CACHE, chunk=16,
                      staggered=True, prefix_cache=True,
                      requests=_prefix_reqs()))
    for kvh in (4, 1):
        for impl in ("exact", "lut2d"):
            cases.append(dict(
                name=f"pipelined-{REGIMES[kvh, 4]}-{impl}", kvh=kvh,
                heads=4, impl=impl, cache=CACHE, chunk=5,
                engine="pipelined",
                requests=_reqs(4, [(9, 7), (21, 6), (4, 8), (14, 5)],
                               temps=(0.0, 0.9, 0.0, 1.1))))
    cases.append(dict(name="evict-pages-rexp", kvh=1, heads=4, impl="rexp",
                      cache=TINY, chunk=16, staggered=True,
                      requests=_reqs(1, [(20, 30), (16, 30), (12, 20),
                                         (8, 16)])))
    for kvh in (1, 4):
        cases.append(dict(name=f"prefix-{REGIMES[kvh, 4]}", kvh=kvh,
                          heads=4, impl="lut2d", cache=CACHE, chunk=16,
                          staggered=True, prefix_cache=True,
                          requests=_prefix_reqs()))
    for (kvh, heads), tag in REGIMES.items():
        cases.append(dict(name=f"shard-{tag}-rexp", kvh=kvh, heads=heads,
                          impl="rexp", cache=CACHE, chunk=5,
                          shard_params=True, requests=_reqs(3, ident)))
    return {c["name"]: c for c in cases}


CASES = _cases()


def _jax_arch(kvh, heads):
    return JARCHS["qwen3-32b"].scaled_down(d_model=64, n_heads=heads,
                                           n_kv_heads=kvh, vocab=R.VOCAB,
                                           n_periods=2)


def _jax_run(case):
    impl = case["impl"]
    pol = JPol(impl=impl, precision="uint8") if impl != "exact" else JPol()
    return JRun(dtype="float32", attention_backend="naive", scan_layers=True,
                softmax_policy=pol, kv_dtype=case.get("kv_dtype", "f32"))


def _jax_single(case, models):
    """The JAX single-device sync engine on the case (no prefix sharing:
    sharing is invisible in the tokens); tokens by request id."""
    jm, jp = models[case["kvh"], case["heads"]]
    n, ps, mp = case["cache"]
    eng = JEngine(jm, jp, _jax_run(case), JEngineConfig(
        n_slots=3, prefill_chunk=case["chunk"],
        cache=JCache(n_pages=n, page_size=ps, max_pages_per_seq=mp)))
    out = R.drive(eng, case)
    return {rid: r.tokens.tolist() for rid, r in out.items()}


_JAX_TP = r"""
import json, sys
import jax, numpy as np
from repro.configs import ARCHS, RunConfig
from repro.core.policies import SoftmaxPolicy
from repro.models import build_model
from repro.runtime import EngineConfig, PagedCacheConfig, ServingEngine
from repro.launch.mesh import make_serving_mesh
cases = json.loads(sys.stdin.read())
mesh = make_serving_mesh(4)
out = {}
for c in cases:
    arch = ARCHS['qwen3-32b'].scaled_down(d_model=64, n_heads=c['heads'],
                                          n_kv_heads=c['kvh'], vocab=128,
                                          n_periods=2)
    model = build_model(arch)
    params = model.init(jax.random.PRNGKey(0))
    run = RunConfig(dtype='float32', attention_backend='naive',
                    scan_layers=True,
                    softmax_policy=SoftmaxPolicy(impl=c['impl'],
                                                 precision='uint8'))
    n, ps, mp = c['cache']
    eng = ServingEngine(model, params, run, EngineConfig(
        n_slots=3, prefill_chunk=c['chunk'], mesh=mesh,
        cache=PagedCacheConfig(n_pages=n, page_size=ps,
                               max_pages_per_seq=mp)))
    res = eng.run([dict(r) for r in c['requests']])
    out[c['name']] = {str(k): v.tokens.tolist() for k, v in res.items()}
print('JAXTP' + json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through 4 port ranks, beside its references; returns
    ``(port results, JAX single-device tokens, JAX TP tokens, port tp=1
    results)``."""
    models, trees = {}, {}
    for kvh, heads in REGIMES:
        jm = jax_build(_jax_arch(kvh, heads))
        jp = jm.init(jax.random.PRNGKey(0))
        models[kvh, heads] = (jm, jp)
        trees[kvh, heads] = jax.tree_util.tree_map(np.asarray, jp)
    tp_cases = [CASES[f"ident-{tag}-rexp"] for tag in REGIMES.values()]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_tp = subprocess.Popen([sys.executable, "-c", _JAX_TP], env=env,
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
    ranks = start_ranks(R.engine_cases, TP, backend="gloo", device="cpu",
                        args=(list(CASES.values()), trees),
                        store_dir=str(tmp_path_factory.mktemp("tp")))
    try:
        out, err = jax_tp.communicate(json.dumps(tp_cases), timeout=600)
        assert jax_tp.returncode == 0, err
        single = {name: _jax_single(c, models) for name, c in CASES.items()}
        port1 = {}
        for name, c in CASES.items():
            if c.get("engine") == "pipelined" or c.get("shard_params"):
                one = dict(c, engine=None)
                eng = R.engine_of(one, params_from_jax(
                    trees[c["kvh"], c["heads"]], device="cpu"))
                firsts = R.first_logits_of(eng)
                res = R.drive(eng, one)
                port1[name] = dict(
                    tokens={k: v.tokens.tolist() for k, v in res.items()},
                    first_logits=firsts)
        port = ranks.join()
    finally:
        if jax_tp.poll() is None:
            jax_tp.kill()
    jax_tp_tokens = json.loads(out[out.index("JAXTP") + 5:])
    return port, single, jax_tp_tokens, port1


def _same(got, want, label, only=None):
    for rid in want if only is None else only:
        assert got[rid] == want[rid], f"{label}: request {rid}"


# ---------------------------------------------------------------------------
# Host-side mesh plumbing, in-process against the JAX functions
# ---------------------------------------------------------------------------


def _mesh(tp, rank=0):
    return PT.Mesh(tp=tp, rank=rank, device=torch.device("cpu"),
                   backend="gloo")


@pytest.mark.parametrize("tp", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("kvh", [1, 2, 3, 4, 8])
def test_regime_and_pool_spec_match_jax(tp, kvh):
    """The mesh rows of the dispatch matrix and the pool placement
    (pages and their int8 scales) equal the JAX package's."""
    jmesh = make_abstract_mesh((1, tp), ("data", "model"))
    assert paged_mesh_regime(_mesh(tp), kvh) == j_regime(jmesh, kvh)
    assert paged_mesh_regime(None, kvh) is j_regime(None, kvh) is None
    for scales in (False, True):
        assert PT.paged_pool_pspec(_mesh(tp), kvh, scales=scales) == \
            tuple(JPT.paged_pool_pspec(jmesh, kvh, scales=scales))
    assert PT.mesh_model_tp(_mesh(tp)) == JPT.mesh_model_tp(jmesh)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
@pytest.mark.parametrize("tp,kvh", [(4, 4), (4, 1), (3, 8), (2, 8)])
def test_pool_shapes_pad_and_split(tp, kvh, kv_dtype):
    """pool_shape pads the page axis to slabs as the JAX package's does;
    each rank's share is its KV heads, or its slab plus one sink page."""
    assert TPC.padded_n_pages(30, tp) == JPC.padded_n_pages(30, tp)
    specs = TPC.pool_leaf_specs(30, 8, kvh, 16, kv_dtype=kv_dtype, tp=tp)
    assert specs == {k: (tuple(s), d) for k, (s, d) in JPC.pool_leaf_specs(
        30, 8, kvh, 16, kv_dtype=kv_dtype, tp=tp).items()}
    padded = TPC.padded_n_pages(30, tp)
    for rank in range(tp):
        local = PT.local_pool_specs(specs, _mesh(tp, rank), kvh)
        for name, (shape, dt) in local.items():
            assert dt == specs[name][1]
            if kvh % tp == 0:
                assert shape == (padded, 8, kvh // tp) + shape[3:]
            else:
                assert shape == (padded // tp + 1, 8, kvh) + shape[3:]
    with pytest.raises(ValueError):
        TPC.padded_n_pages(8, 0)


def test_allocator_interleaves_across_slabs_like_jax():
    """With tp set the free list round-robins over the slabs, and a freed
    page returns to its own slab's FIFO — the same pages as the JAX
    package's allocator under the same churn."""
    def churn(mod):
        a = mod.PageAllocator(16, tp=4)
        first = a.alloc(4)
        held = first + a.alloc(11)
        a.free([p for p in held if p // 4 == 1] + [3, 9, 14])
        return first, a.alloc(4), mod.PageAllocator(8).alloc(7)

    first, again, plain = churn(TPC)
    assert (first, again, plain) == churn(JPC)
    assert sorted(p // 4 for p in first) == [0, 1, 2, 3]
    assert len({p // 4 for p in again}) == 4
    assert plain == list(range(1, 8))


RULE_LEAVES = ("embed/table", "head/w", "periods/0/mixer/wq",
               "periods/0/mixer/wk", "periods/0/mixer/wv",
               "periods/0/mixer/wo", "periods/0/ffn/w_gate",
               "periods/0/ffn/w_up", "periods/0/ffn/w_down")


@pytest.mark.parametrize("tp", [2, 3, 4, 8])
@pytest.mark.parametrize("arch_name", ["qwen3-32b", "mistral-large-123b"])
def test_param_pspec_matches_jax(arch_name, tp):
    """The weight rules of the decoder's nine leaves equal the JAX
    package's ``param_pspec(fsdp=False)`` at full width."""
    jm = jax_build(JARCHS[arch_name].with_layers(2))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    flat = {JPT.path_str(p): leaf.shape for p, leaf in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    jmesh = make_abstract_mesh((1, tp), ("data", "model"))
    for path in RULE_LEAVES:
        shape = tuple(flat[path])
        assert PT.param_pspec(path, shape, _mesh(tp)) == tuple(
            JPT.param_pspec(path, shape, jmesh, fsdp=False)), path


@pytest.mark.parametrize("kvh,heads", list(REGIMES))
def test_shard_params_cuts_and_reassembles(kvh, heads):
    """Each rank's cut concatenates back to the full leaf; the 'pages'
    regime keeps the attention weights whole; a cut tree passes again
    unchanged."""
    arch = R.arch_of(kvh, heads)
    tree = jax.tree_util.tree_map(
        np.asarray, jax_build(_jax_arch(kvh, heads)).init(
            jax.random.PRNGKey(0)))
    cuts = [PT.shard_params(tree, arch, _mesh(TP, r)) for r in range(TP)]
    pages = paged_mesh_regime(_mesh(TP), kvh) == "pages"
    full = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    for path, leaf in full.items():
        name = JPT.path_str(path)
        parts = [dict(jax.tree_util.tree_flatten_with_path(c)[0])[path]
                 for c in cuts]
        spec = PT.param_pspec(name, leaf.shape, _mesh(TP))
        whole = "model" not in spec or (
            pages and name.rsplit("/", 1)[-1] in PT.ATTENTION_LEAVES)
        if whole:
            assert all(p is leaf or np.array_equal(p, leaf) for p in parts)
            continue
        axis = spec.index("model")
        assert parts[0].shape[axis] * TP == leaf.shape[axis], name
        np.testing.assert_array_equal(np.concatenate(parts, axis), leaf)
        again = PT.shard_params(cuts[1], arch, _mesh(TP, 1))
        np.testing.assert_array_equal(
            dict(jax.tree_util.tree_flatten_with_path(again)[0])[path],
            parts[1])


def test_engine_and_mesh_argument_checks():
    """shard_params without a mesh and a backend that cannot run the
    ranks raise — never a quiet fallback to another backend."""
    arch = R.arch_of(4, 4)
    case = dict(kvh=4, heads=4, impl="rexp", cache=CACHE)
    params = build_model(arch).init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="requires a mesh"):
        R.ServingEngine(build_model(arch), params, R.RunConfig(
            dtype="float32"), EngineConfig(shard_params=True), device="cpu")
    with pytest.raises(ValueError, match="nccl"):
        check_backend(2, "nccl", "cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        check_backend(2, "mpi", "cpu")
    eng = R.engine_of(case, params)
    with pytest.raises(RuntimeError, match="only ranks other than 0"):
        eng.follow()
    eng.close()   # no mesh: nothing to release


# ---------------------------------------------------------------------------
# TP engines ≡ the JAX single-device engine (and the JAX TP engine)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("ident")])
def test_tp_engine_token_identical(runs, name):
    """Exact, REXP and 2D-LUT in the 'heads', 'heads'-GQA and 'pages'
    regimes: the 4-rank engine's greedy tokens equal the JAX
    single-device engine's (and, under REXP, the JAX TP engine's)."""
    port, single, jax_tp, _ = runs
    res = port[name]
    kvh, heads = CASES[name]["kvh"], CASES[name]["heads"]
    assert res["tp"] == TP
    assert res["regime"] == REGIMES[kvh, heads].split("-")[0]
    _same(res["tokens"], single[name], name)
    if name in jax_tp:
        _same(res["tokens"], {int(k): v for k, v in jax_tp[name].items()},
              f"{name} vs JAX TP")


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("int8-")
                                  and "cow" not in n])
def test_tp_engine_int8_token_identical(runs, name):
    """The int8 pool in both regimes: its scale leaves shard with their
    pages (by KV head, or by slab plus sink), token-identical to the JAX
    single-device int8 engine."""
    port, single, _, _ = runs
    res = port[name]
    assert [(k, d) for k, _, d in res["pool"]] == [
        ("k_pages", "torch.int8"), ("v_pages", "torch.int8"),
        ("k_scales", "torch.float32"), ("v_scales", "torch.float32")]
    shapes = {k: s for k, s, _ in res["pool"]}
    if CASES[name]["kvh"] == 4:
        assert shapes["k_pages"][3] == 1 and shapes["k_scales"][3] == 1
    else:
        assert shapes["k_pages"][1] == shapes["k_scales"][1] == 32 // TP + 1
    _same(res["tokens"], single[name], name)


def _cow_records(res):
    """Per rank, the records of the copy-on-write programs."""
    return [[r for op, recs in trace if op == "copy" for r in recs]
            for trace in res["traces"]]


@pytest.mark.parametrize("name", ["int8-cow-pages", "prefix-pages",
                                  "prefix-heads"])
def test_tp_prefix_cache_and_cow_token_identical(runs, name):
    """Prefix sharing with copy-on-write on the 4-rank pool, f32 and
    int8: token-identical to the JAX single-device engine without
    sharing.  In the 'pages' regime a copy whose pages lie on two slabs
    sends exactly one page of every layer per leaf (K, V, and for int8
    their scales) from the source's owner to the destination's; in the
    'heads' regime every copy is local."""
    port, single, _, _ = runs
    res = port[name]
    assert res["stats"]["cow_copies"] > 0, "no copy-on-write happened"
    assert res["stats"]["pages_shared"] > 0
    assert res["stats"]["prefix_hit_tokens"] > 0
    _same(res["tokens"], single[name], name)
    cow = _cow_records(res)
    if res["regime"] == "heads":
        assert not any(cow), cow
        return
    n_leaves = 4 if CASES[name].get("kv_dtype") == "int8" else 2
    sends = [r for per in cow for r in per if r[1] == "send"]
    recvs = [r for per in cow for r in per if r[1] == "recv"]
    assert sends and len(sends) == len(recvs)
    assert len(sends) % n_leaves == 0
    ps, n_layers = CASES[name]["cache"][1], 2
    for site, _, shape, _, _ in sends + recvs:
        assert site == "cow" and shape[:2] == (n_layers, ps), shape


@pytest.mark.parametrize("name", [n for n in CASES
                                  if n.startswith("pipelined")])
def test_tp_pipelined_engine_token_identical(runs, name):
    """The pipelined engine on 4 ranks, each sampling on its own from the
    same logits into its own last-token buffer: every request equals the
    port's single-device sync engine (greedy and sampled alike), and the
    greedy requests equal the JAX single-device engine."""
    port, single, _, port1 = runs
    res = port[name]
    _same(res["tokens"], port1[name]["tokens"], f"{name} vs port tp=1")
    greedy = [i for i, r in enumerate(CASES[name]["requests"])
              if r["temperature"] <= 0.0]
    _same(res["tokens"], single[name], f"{name} vs JAX", only=greedy)
    assert set(res["finish"].values()) == {"length"}


def test_tp_engine_evictions_and_staggered_arrivals(runs):
    """Staggered arrivals into a pool small enough to force evictions and
    replays, 'pages' regime: token-identical, and every page returns."""
    port, single, _, _ = runs
    res = port["evict-pages-rexp"]
    assert res["stats"]["preemptions"] > 0, "pool never pressured"
    assert res["n_free"] == res["usable"]
    _same(res["tokens"], single["evict-pages-rexp"], "evict")


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("shard")])
def test_tp_shard_params(runs, name):
    """Weights cut over 4 ranks (attention by heads in the 'heads'
    regimes, replicated in 'pages'; the MLP, embedding and head always):
    first-step logits within 1e-4 of the single-device engine's and the
    greedy tokens equal the JAX single-device engine's."""
    port, single, _, port1 = runs
    res = port[name]
    for rid, row in port1[name]["first_logits"].items():
        np.testing.assert_allclose(res["first_logits"][rid], row, rtol=0,
                                   atol=1e-4, err_msg=f"{name} {rid}")
    _same(res["tokens"], single[name], name)


# ---------------------------------------------------------------------------
# MoE decoders: the FFN replicated on every rank
# ---------------------------------------------------------------------------

#: tp-2 'heads' cases of the scaled-down MoE decoders (4 experts, top-2):
#: DeepSeek-MoE-16B's MHA (KVH = H = 4; 2 shared experts) and
#: Granite-MoE-3B at GQA 2 (KVH 2, H 4), sync and pipelined
MOE_TP_CASES = {c["name"]: c for c in [
    dict(name="moe-deepseek-heads-rexp", base="deepseek-moe-16b", kvh=4,
         heads=4, impl="rexp", router="rexp", cache=CACHE, chunk=5,
         requests=_reqs(3, [(9, 7), (21, 6), (4, 8), (14, 5)])),
    dict(name="moe-granite-heads-gqa-exact", base="granite-moe-3b-a800m",
         kvh=2, heads=4, impl="exact", cache=CACHE, chunk=5,
         requests=_reqs(6, [(12, 6), (3, 9), (25, 5)])),
    dict(name="moe-granite-heads-gqa-lut2d-int8-pipelined",
         base="granite-moe-3b-a800m", kvh=2, heads=4, impl="lut2d",
         router="rexp", kv_dtype="int8", engine="pipelined", cache=CACHE,
         chunk=5, requests=_reqs(7, [(10, 7), (18, 6), (5, 8)],
                                 temps=(0.0, 0.8, 0.0)))]}


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_tree(v) for v in tree)
    return tree.numpy()


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    """Every MoE case through 2 port ranks (seeded port weights, as
    numpy trees) beside the port's own single-device sync engine."""
    trees = {}
    for c in MOE_TP_CASES.values():
        arch = R.arch_of(c["kvh"], c["heads"], c["base"])
        params = build_model(arch).init(torch.Generator().manual_seed(0),
                                        device="cpu")
        trees[R.case_key(c)] = _numpy_tree(params)
    ranks = start_ranks(R.engine_cases, 2, backend="gloo", device="cpu",
                        args=(list(MOE_TP_CASES.values()), trees),
                        store_dir=str(tmp_path_factory.mktemp("tp_moe")))
    single = {}
    for name, c in MOE_TP_CASES.items():
        one = dict(c, engine=None)
        eng = R.engine_of(one, params_from_jax(trees[R.case_key(c)],
                                               device="cpu"))
        firsts = R.first_logits_of(eng)
        res = R.drive(eng, one)
        single[name] = dict(tokens={k: v.tokens.tolist()
                                    for k, v in res.items()},
                            first_logits=firsts)
    return ranks.join(), single


@pytest.mark.parametrize("name", list(MOE_TP_CASES))
def test_tp2_heads_moe_token_identical_to_tp1(moe_runs, name):
    """Two 'heads' ranks, each attending its half of the KV heads and
    running the whole MoE FFN on replicated weights (no collective beyond
    the attention's gather): every request's tokens equal the port's
    tp = 1 engine's, greedy and sampled, and the sync drives' first-token
    logits agree within 1e-5."""
    port, single = moe_runs
    res = port[name]
    assert res["tp"] == 2 and res["regime"] == "heads"
    _same(res["tokens"], single[name]["tokens"], f"{name} vs port tp=1")
    for rid, row in res["first_logits"].items():
        np.testing.assert_allclose(row, single[name]["first_logits"][rid],
                                   rtol=0, atol=1e-5, err_msg=f"{name} {rid}")
    sites = {rec[0] for tr in res["traces"] for _, recs in tr
             for rec in recs}
    assert sites == {"attn_out"}, sites


# ---------------------------------------------------------------------------
# The wire budget, from the collective log
# ---------------------------------------------------------------------------

B, D_MODEL, N_LAYERS = 3, 64, 2


def _allowed(regime, h, shard, c=1):
    """Every (site, kind, shape) a program of ``c`` query rows per slot
    may put on the wire."""
    b, D = (B if c == 1 else 1), D_MODEL // h
    ok = set()
    if regime == "pages":
        ok |= {("pages_max", "all_reduce_max", (b, h, c, 1)),
               ("pages_sum", "all_reduce_sum", (b, h, c, 1)),
               ("pages_pv", "all_reduce_sum", (b, h, c, D))}
    elif not shard:
        ok.add(("attn_out", "all_gather", (b, h, c, D)))
    if shard:
        ok |= {("wo", "all_reduce_sum", (b, c, D_MODEL)),
               ("w_down", "all_reduce_sum", (b, c, D_MODEL)),
               ("embed", "all_reduce_sum", (b, c, D_MODEL)),
               ("head", "all_gather", (b, 1, R.VOCAB))}
    return ok


@pytest.mark.parametrize("name", ["ident-heads-rexp", "ident-heads-gqa-rexp",
                                  "ident-pages-rexp", "int8-pages-rexp",
                                  "shard-heads-rexp", "shard-pages-rexp"])
def test_tp_decode_moves_only_partials(runs, name):
    """Every decode step on every rank moves only (B, H, 1) max and Σ and
    (B, H, 1, D) outputs ('pages'), or the (B, H, 1, D) output gather
    ('heads'), plus (B, d_model) activations and the gathered logits
    under shard_params; per layer within 2·B·H·(D+2)·4 bytes (plus the
    activations); no KV-sized tensor; 'pages' always all-reduces."""
    port, _, _, _ = runs
    res = port[name]
    case = CASES[name]
    h, shard = case["heads"], case.get("shard_params", False)
    d = D_MODEL // h
    for rank, trace in enumerate(res["traces"]):
        decodes = [recs for op, recs in trace if op == "decode"]
        assert decodes, "no decode step"
        for recs in decodes:
            seen = {(site, kind, shape) for site, kind, shape, _, _ in recs}
            assert seen <= _allowed(res["regime"], h, shard), (rank, seen)
            per_layer = sum(n for site, _, _, _, n in recs
                            if site not in ("embed", "head")) / N_LAYERS
            budget = 2 * B * h * (d + 2) * 4 + (2 * B * D_MODEL * 4
                                                if shard else 0)
            assert per_layer <= budget, (rank, per_layer, budget)
            if res["regime"] == "pages":
                assert any(k.startswith("all_reduce") for _, k, _, _, _
                           in recs)
        for op, recs in trace:
            if op == "chunk":
                c = case["chunk"]
                seen = {(s, k, sh) for s, k, sh, _, _ in recs}
                assert seen <= _allowed(res["regime"], h, shard, c), seen


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def _launch(*extra):
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "qwen3-32b", "--scale-down", "64,4,128", "--layers", "2",
           "--device", "cpu", "--batch", "3", "--prompt-len", "20",
           "--new-tokens", "8", *extra]
    out = subprocess.run(cmd, env=dict(os.environ, PYTHONPATH=os.path.join(
        REPO, "src")), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_launcher_tp_prints_tp1_tokens():
    """``--tp 2 --dist-backend gloo`` (the 'pages' regime at this width,
    with --shard-params too) prints the sample tokens of ``--tp 1``, once:
    only rank 0 prints."""
    one = _launch("--tp", "1")
    two = _launch("--tp", "2", "--dist-backend", "gloo", "--shard-params")
    line = [ln for ln in one.splitlines() if ln.startswith("sample token")]
    assert line and [ln for ln in two.splitlines()
                     if ln.startswith("sample token")] == line
    assert "tensor-parallel tp=2 over gloo: 'pages' regime" in two


def test_launcher_tp_flag_checks(capsys):
    """The JAX launcher's errors: --shard-params needs --tp > 1, and
    --tp > 1 needs the continuous engine."""
    base = ["--arch", "qwen3-32b", "--scale-down", "64,4,128", "--device",
            "cpu"]
    with pytest.raises(SystemExit):
        SERVE.main(base + ["--shard-params"])
    assert "--shard-params requires --tp > 1" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        SERVE.main(base + ["--tp", "2", "--engine", "lockstep"])
    assert ("--tp > 1 requires the continuous engine (attention-only "
            "decoder LM with --engine continuous)"
            in capsys.readouterr().err)
