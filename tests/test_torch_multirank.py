"""The port's parameter rules and expert-parallel serving against the JAX
package.

* Rules: for every leaf of the ten registered archs at full width (two
  periods; shapes only, the port's tree on the meta device), on meshes
  ``(1, 2)``, ``(1, 3)``, ``(1, 4)``, ``(4, 2)`` and ``(8, 1)``, the
  port's ``param_pspec`` equals the JAX package's, with ``fsdp`` True
  and False (the JAX side gets an abstract mesh: ``_resolve`` reads only
  its axis names and sizes); the ``"EPTP"`` fallback (6 experts on 4
  ranks) cuts each expert's ``d_expert``, and a layer on those cuts
  gives the whole layer's output.
* Expert-parallel serving: scaled-down DeepSeek-MoE (4 experts top-2
  and 2 shared experts, 4 KV heads: the ``'heads'`` regime at tp 2 and
  4, ``'pages'`` at 3) and Granite-MoE (1 KV head: ``'pages'``) through
  the sync and the pipelined engine at tp 2, 3 and 4 with
  ``shard_params`` (spawned gloo ranks, ``repro_torch.launch.mesh``; no
  network), f32, exact and REXP attention: the tokens equal the JAX
  single-device engine's; each rank holds ``1/tp`` of the experts' bytes
  where tp divides the expert count (whole at tp 3); a decode step's log
  holds one ``moe`` all-reduce a layer of ``T · D · 4`` bytes.
"""

import jax
import numpy as np
import pytest
import torch

from repro.compat import make_abstract_mesh
from repro.configs import ARCHS as JARCHS
from repro.configs import RunConfig as JRun
from repro.core.policies import SoftmaxPolicy as JPol
from repro.models import build_model as jax_build
from repro.models import moe as JMOE
from repro.runtime import EngineConfig as JEngineConfig
from repro.runtime import PagedCacheConfig as JCache
from repro.runtime import ServingEngine as JEngine
from repro.runtime import partitioning as JPT
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.launch.mesh import start_ranks
from repro_torch.models import build_model
from repro_torch.models.convert import tree_flatten
from repro_torch.runtime import partitioning as PT

import torch_multirank_ranks as M
import torch_tp_ranks as R

torch.set_num_threads(1)

MESHES = [(1, 2), (1, 3), (1, 4), (4, 2), (8, 1)]
TPS = (2, 3, 4)
CACHE = (30, 8, 8)
#: (base arch, KV heads) of the two scaled-down MoE decoders
BASES = {"deepseek-moe-16b": 4, "granite-moe-3b-a800m": 1}


class _Mesh:
    """A mesh shape for the rules (the port's rules read ``axis_names``
    and ``shape`` only, as the JAX package's do)."""

    def __init__(self, data, model):
        self.axis_names = ("data", "model")
        self.shape = {"data": data, "model": model}


_SHAPES: dict = {}


def _shapes(name):
    """(port paths and shapes on the meta device, JAX paths and shapes
    from ``eval_shape``) of the arch at full width, two periods."""
    if name not in _SHAPES:
        tarch, jarch = TARCHS[name], JARCHS[name]
        if not tarch.encoder_layers:
            tarch, jarch = tarch.with_layers(2), jarch.with_layers(2)
        tp = {p: tuple(x.shape) for p, x in tree_flatten(
            build_model(tarch).init(torch.Generator(), "meta"))}
        jm = jax_build(jarch)
        flat = jax.tree_util.tree_flatten_with_path(
            jax.eval_shape(jm.init, jax.random.PRNGKey(0)))[0]
        jp = {JPT.path_str(p): tuple(x.shape) for p, x in flat}
        _SHAPES[name] = (tp, jp)
    return _SHAPES[name]


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", sorted(TARCHS))
def test_param_pspec_matches_jax_every_leaf(name, mesh, fsdp):
    tshapes, jshapes = _shapes(name)
    assert tshapes == jshapes
    jmesh = make_abstract_mesh(mesh, ("data", "model"))
    for path, shape in tshapes.items():
        want = tuple(JPT.param_pspec(path, shape, jmesh, fsdp=fsdp))
        assert PT.param_pspec(path, shape, _Mesh(*mesh), fsdp) == want, path


def _eptp_layer():
    rng = np.random.default_rng(4)
    d, e, f = 16, 6, 32
    p = {"router": rng.normal(0, 0.3, (d, e)).astype(np.float32),
         "w_gate": rng.normal(0, 0.25, (e, d, f)).astype(np.float32),
         "w_up": rng.normal(0, 0.25, (e, d, f)).astype(np.float32),
         "w_down": rng.normal(0, 0.18, (e, f, d)).astype(np.float32)}
    x = rng.normal(0, 1, (2, 5, d)).astype(np.float32)
    return p, x, dict(d=d, n_experts=e, d_expert=f, top_k=2)


def test_eptp_fallback_rules():
    """6 experts do not split over 4 ranks: the 3-D rows cut each
    expert's 32 hidden units instead, as the JAX package's do."""
    mesh = _Mesh(1, 4)
    jmesh = make_abstract_mesh((1, 4), ("data", "model"))
    for leaf, shape in (("w_gate", (2, 6, 16, 32)), ("w_up", (2, 6, 16, 32)),
                        ("w_down", (2, 6, 32, 16))):
        path = f"periods/0/ffn/{leaf}"
        for fsdp in (True, False):
            got = PT.param_pspec(path, shape, mesh, fsdp)
            assert got == tuple(JPT.param_pspec(path, shape, jmesh,
                                                fsdp=fsdp))
        assert "model" in got and got[1] is None
    tmesh = PT.Mesh(tp=4, rank=2, device=torch.device("cpu"),
                    backend="gloo")
    assert PT.expert_split(tmesh, 6, 16, 32) == ("columns", 16, 24)
    assert PT.expert_split(tmesh, 8, 16, 32) == ("experts", 4, 6)
    assert PT.expert_split(tmesh, 6, 16, 30) is None


def _jax_arch(base):
    return JARCHS[base].scaled_down(d_model=64, n_heads=4,
                                    n_kv_heads=BASES[base], vocab=R.VOCAB,
                                    n_periods=2)


def _reqs(seed):
    rng = np.random.default_rng(seed)
    return [dict(prompt=rng.integers(0, R.VOCAB, size=int(n)).tolist(),
                 max_new_tokens=int(m), temperature=0.0, seed=i)
            for i, (n, m) in enumerate([(9, 7), (21, 6), (4, 8), (14, 5)])]


def _cases():
    cases = []
    for base, kvh in BASES.items():
        for impl in ("exact", "rexp"):
            for engine in ("sync", "pipelined"):
                cases.append(dict(name=f"{base}-{impl}-{engine}", base=base,
                                  kvh=kvh, heads=4, impl=impl, cache=CACHE,
                                  chunk=5, engine=engine, shard_params=True,
                                  requests=_reqs(3)))
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Every case through the port's ranks at tp 2, 3 and 4 (started
    together), the EPTP layer at tp 4, and the JAX single-device engine
    on the same weights and requests."""
    trees, jmodels = {}, {}
    for base, kvh in BASES.items():
        jm = jax_build(_jax_arch(base))
        jp = jm.init(jax.random.PRNGKey(0))
        jmodels[base] = (jm, jp)
        trees[kvh, 4, base] = jax.tree_util.tree_map(np.asarray, jp)
    ranks = {tp: start_ranks(M.ep_serving, tp, backend="gloo", device="cpu",
                             args=(CASES, trees),
                             store_dir=str(tmp_path_factory.mktemp(
                                 f"ep{tp}")))
             for tp in TPS}
    p, x, kw = _eptp_layer()
    eptp = start_ranks(M.eptp_moe, 4, backend="gloo", device="cpu",
                       args=(p, x, kw),
                       store_dir=str(tmp_path_factory.mktemp("eptp")))
    jax_tokens = {}
    for c in CASES:
        key = (c["base"], c["impl"])
        if key in jax_tokens:
            continue
        jm, jp = jmodels[c["base"]]
        pol = (JPol(impl=c["impl"], precision="uint8")
               if c["impl"] != "exact" else JPol())
        n, ps, mp = c["cache"]
        eng = JEngine(jm, jp, JRun(dtype="float32",
                                   attention_backend="naive",
                                   scan_layers=True, softmax_policy=pol),
                      JEngineConfig(n_slots=3, prefill_chunk=c["chunk"],
                                    cache=JCache(n_pages=n, page_size=ps,
                                                 max_pages_per_seq=mp)))
        out = eng.run([dict(r) for r in c["requests"]])
        jax_tokens[key] = {rid: r.tokens.tolist() for rid, r in out.items()}
    jout, _ = JMOE.apply_moe({k: np.asarray(v) for k, v in p.items()}, x,
                             n_experts=kw["n_experts"], top_k=kw["top_k"])
    return dict(port={tp: r.join() for tp, r in ranks.items()},
                jax=jax_tokens, eptp=eptp.join(), eptp_ref=np.asarray(jout),
                trees=trees)


#: (case, tp) → the requests whose greedy stream leaves the JAX
#: engine's, each named with its top-2 margin at the parting decision:
#: none at f32
PARTINGS: dict = {}


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_expert_parallel_engines_give_jax_tokens(served, name, tp):
    case = next(c for c in CASES if c["name"] == name)
    out, _ = served["port"][tp]
    got = out[name]["tokens"]
    want = served["jax"][case["base"], case["impl"]]
    parted = {rid for rid in want if got[rid] != want[rid]}
    assert parted == PARTINGS.get((name, tp), set())
    regime = "heads" if case["kvh"] % tp == 0 else "pages"
    assert out[name]["regime"] == regime


@pytest.mark.parametrize("tp", TPS)
def test_each_rank_holds_its_share_of_the_experts(served, tp):
    _, every = served["port"][tp]
    for base, kvh in BASES.items():
        whole = sum(v.nbytes for p, v in tree_flatten(
            served["trees"][kvh, 4, base])
            if p.split("/")[-2] == "ffn"
            and p.rsplit("/", 1)[-1] in ("w_gate", "w_up", "w_down"))
        share = whole if 4 % tp else whole // tp      # 4 experts
        assert [r[kvh, 4, base] for r in every] == [share] * tp, base


@pytest.mark.parametrize("tp", TPS)
def test_decode_log_holds_one_moe_all_reduce_a_layer(served, tp):
    """A decode step of the sync engine: one ``moe`` all-reduce a layer
    of ``T · D · 4`` bytes (3 slots × 64 × 4) where the experts or the
    shared MLP are cut — none at tp 3, where both stay whole."""
    out, _ = served["port"][tp]
    for base in BASES:
        traces = out[f"{base}-exact-sync"]["traces"]
        for rank_trace in traces:
            decodes = [recs for op, recs in rank_trace if op == "decode"]
            assert decodes
            for recs in decodes:
                moe = [r for r in recs if r[0] == "moe"]
                if 4 % tp:
                    assert moe == []
                    continue
                assert len(moe) == 2, base
                assert all(r[1] == "all_reduce_sum" and r[4] == 3 * 64 * 4
                           and r[3] == "float32" for r in moe)


def test_eptp_layer_matches_the_whole_layer(served):
    """At tp 4 each rank holds 8 of every expert's 32 hidden units, and
    the ranks' partial sums meet in one ``moe`` all-reduce of
    ``T · D · 4`` bytes: the output is the JAX layer's."""
    out, shape, log = served["eptp"]
    assert shape == (6, 16, 8)
    np.testing.assert_allclose(out, served["eptp_ref"], rtol=1e-5,
                               atol=1e-5)
    assert [(r[0], r[1], r[4]) for r in log] == [
        ("moe", "all_reduce_sum", 10 * 16 * 4)]
