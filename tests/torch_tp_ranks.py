"""Rank bodies of the port's tensor-parallel CPU tests.

``tests/test_torch_tp.py`` and ``tests/test_torch_sharded_attention.py``
start these with ``repro_torch.launch.mesh.start_ranks`` (4 spawned gloo
ranks over a ``file://`` store in the test's ``tmp_path``; no network).
This module imports torch and the port only, so a rank starts without
JAX; each body returns rank 0's view of the results, with every rank's
collective records gathered in.
"""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, RunConfig
from repro_torch.core.policies import SoftmaxPolicy
from repro_torch.kernels.lut_attention import ops, sharded_paged
from repro_torch.kernels.lut_attention.sharded_decode import (
    lut_decode_sharded)
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import partitioning as PT
from repro_torch.runtime.engine import (EngineConfig, PipelinedEngine,
                                        ServingEngine)
from repro_torch.runtime.paged_cache import PagedCacheConfig

VOCAB = 128


def arch_of(kvh: int, heads: int, base: str = "qwen3-32b"):
    """``base`` (Qwen3-32B unless named: the JAX suite's ``small_model``)
    scaled down: d_model 64, ``heads``/``kvh`` heads, vocab 128, two
    layers (an MoE base: 4 experts, top-2)."""
    return ARCHS[base].scaled_down(d_model=64, n_heads=heads,
                                   n_kv_heads=kvh, vocab=VOCAB, n_periods=2)


def case_key(case) -> tuple:
    """The key of a case's weights in ``trees``: its (kvh, heads), and its
    ``base`` arch where it names one."""
    key = (case["kvh"], case["heads"])
    return key + (case["base"],) if "base" in case else key


def policy_of(impl: str) -> SoftmaxPolicy:
    return (SoftmaxPolicy(impl=impl, precision="uint8") if impl != "exact"
            else SoftmaxPolicy())


def engine_of(case, params, mesh=None, device="cpu"):
    """The case's engine (sync or pipelined) over the port's model."""
    arch = arch_of(case["kvh"], case["heads"], case.get("base", "qwen3-32b"))
    run = RunConfig(dtype="float32", softmax_policy=policy_of(case["impl"]),
                    router_policy=policy_of(case.get("router", "exact")),
                    kv_dtype=case.get("kv_dtype", "f32"))
    n_pages, ps, mp = case["cache"]
    cfg = EngineConfig(
        n_slots=case.get("n_slots", 3), prefill_chunk=case.get("chunk", 5),
        prefix_cache=case.get("prefix_cache", False), mesh=mesh,
        shard_params=case.get("shard_params", False) and mesh is not None,
        cache=PagedCacheConfig(n_pages=n_pages, page_size=ps,
                               max_pages_per_seq=mp))
    cls = PipelinedEngine if case.get("engine") == "pipelined" \
        else ServingEngine
    return cls(build_model(arch), params, run, cfg, device=device)


def drive(eng, case) -> dict:
    """Serve the case's requests: all at once, or (``staggered``) one
    arrival per engine step; returns the results by request id."""
    reqs = [dict(r) for r in case["requests"]]
    if not case.get("staggered"):
        return eng.run(reqs)
    out = {}
    for r in reqs:
        eng.add_request(**r)
        out.update({res.request_id: res for res in eng.step()})
    while eng.has_work():
        out.update({res.request_id: res for res in eng.step()})
    return out


def first_logits_of(eng) -> dict:
    """Record each request's first-token logits (sync engine)."""
    seen = {}
    sample = eng._sample

    def recording(seq, row):
        if not seq.generated:
            seen.setdefault(seq.request.id, np.array(row, copy=True))
        return sample(seq, row)

    eng._sample = recording
    return seen


def watch_ops(eng, mesh, trace: list) -> None:
    """Append ``(op, records)`` for every device program the rank runs:
    the collectives of that program alone."""
    for op in ("copy", "chunk", "decode"):
        fn = getattr(eng, "_op_" + op)

        def wrapped(*a, _fn=fn, _op=op, **kw):
            mesh.log.records.clear()
            try:
                return _fn(*a, **kw)
            finally:
                trace.append((_op, [dataclasses.astuple(r)
                                    for r in mesh.log.records]))

        setattr(eng, "_op_" + op, wrapped)


def engine_cases(mesh, cases, trees):
    """Every case through a TP engine on this rank; rank 0 returns, per
    case, its tokens, finish reasons, stats, first-token logits and
    every rank's per-program collective records."""
    results = {}
    for case in cases:
        tree = trees[case_key(case)]
        arch = arch_of(case["kvh"], case["heads"],
                       case.get("base", "qwen3-32b"))
        shard = case.get("shard_params", False)
        params = params_from_jax(tree, device="cpu",
                                 mesh=mesh if shard else None, cfg=arch)
        eng = engine_of(case, params, mesh)
        trace: list = []
        watch_ops(eng, mesh, trace)
        res = None
        if mesh.rank == 0:
            firsts = (first_logits_of(eng) if case.get("engine") != "pipelined"
                      else {})
            out = drive(eng, case)
            eng.close()
            st = eng.stats
            res = dict(
                tokens={rid: r.tokens.tolist() for rid, r in out.items()},
                finish={rid: r.finish_reason for rid, r in out.items()},
                stats=dict(preemptions=st.preemptions,
                           cow_copies=st.cow_copies,
                           pages_shared=st.pages_shared,
                           prefix_hit_tokens=st.prefix_hit_tokens),
                n_free=eng.scheduler.allocator.n_free,
                usable=eng.cache.usable_pages,
                tp=eng.tp, regime=eng.regime,
                pool=[(k, tuple(v.shape), str(v.dtype))
                      for k, v in eng.pools[0].items()],
                first_logits=firsts)
        else:
            eng.follow()
        traces = [None] * mesh.tp
        dist.all_gather_object(traces, trace, group=mesh.group)
        if res is not None:
            res["traces"] = traces
            results[case["name"]] = res
    return results


# ---------------------------------------------------------------------------
# The sharded dispatch on its own
# ---------------------------------------------------------------------------


def local_share(mesh, kvh: int, pages, scales=None):
    """This rank's share of a global pool (n_pages divisible by tp): its
    KV heads, or its page slab plus a sink page."""
    pages = torch.as_tensor(pages)
    regime = ops.paged_mesh_regime(mesh, kvh)
    if regime == "heads":
        n = kvh // mesh.tp
        cut = (slice(None), slice(None), slice(mesh.rank * n,
                                               (mesh.rank + 1) * n))
        return (pages[cut].contiguous(),
                None if scales is None
                else torch.as_tensor(scales)[cut].contiguous())
    slab = pages.shape[0] // mesh.tp
    rows = slice(mesh.rank * slab, (mesh.rank + 1) * slab)

    def with_sink(x):
        x = torch.as_tensor(x)
        return torch.cat([x[rows], torch.zeros_like(x[:1])]).contiguous()

    return with_sink(pages), None if scales is None else with_sink(scales)


def attention_problems(mesh, problems):
    """Each problem (a dict of numpy arrays: q, k_pages, v_pages, bt,
    kv_lens, optional q_start, k_scales, v_scales; impl, kvh) through the
    mesh rows of the paged dispatch; rank 0 returns the outputs, the
    σ of the 'pages' regime summed over the ranks (each key is owned by
    one rank, every other rank's σ there is an exact 0), and the
    collective records of each call."""
    outs = []
    for p in problems:
        pol = policy_of(p["impl"])
        kp, ks = local_share(mesh, p["kvh"], p["k_pages"], p.get("k_scales"))
        vp, vs = local_share(mesh, p["kvh"], p["v_pages"], p.get("v_scales"))
        q = torch.as_tensor(p["q"])
        bt = torch.as_tensor(p["bt"])
        kl = torch.as_tensor(p["kv_lens"])
        kw = dict(mesh=mesh, n_kv_heads=p["kvh"], k_scales=ks, v_scales=vs)
        mesh.log.records.clear()
        if "q_start" in p:
            out = ops.lut_attention_paged_prefill(
                q, kp, vp, bt, torch.as_tensor(p["q_start"]), kl, pol, **kw)
        else:
            out = ops.lut_attention_paged_decode(q, kp, vp, bt, kl, pol,
                                                 **kw)
        records = [dataclasses.astuple(r) for r in mesh.log.records]
        sigma = None
        if ops.paged_mesh_regime(mesh, p["kvh"]) == "pages":
            valid, k_view, _ = sharded_paged.slab_views(kp, vp, bt, kl, mesh,
                                                         ks, vs)
            qs = p.get("q_start")
            sigma = sharded_paged.slab_sigma(
                q, k_view, valid, pol, mesh, scale=q.shape[-1] ** -0.5,
                q_start=None if qs is None else torch.as_tensor(qs))
            sigma = PT.all_reduce(sigma, mesh, "sum").numpy()
        outs.append(dict(out=out.numpy(), sigma=sigma, records=records))
    return outs if mesh.rank == 0 else None


def decode_problems(mesh, problems):
    """Length-sharded lockstep decode: each problem (q, k, v (B, KVH, L,
    D), kv_len, impl) through ``lut_decode_sharded`` on this rank's
    length shard, and once more through ``layers.apply_attention`` on an
    ``AttnCache`` that holds this rank's length shard (``seq_axes``
    ``('model',)``, as ``partitioning.cache_specs`` cuts a cache whose KV
    heads do not divide the mesh) under the mesh — rank 0 returns both
    outputs and the hook's collective sites."""
    outs = []
    for p in problems:
        pol = policy_of(p["impl"])
        q, k, v = (torch.as_tensor(p[n]) for n in ("q", "k", "v"))
        n = k.shape[2] // mesh.tp
        shard = slice(mesh.rank * n, (mesh.rank + 1) * n)
        out = lut_decode_sharded(q, k[:, :, shard], v[:, :, shard], pol,
                                 kv_len=int(p["kv_len"]), mesh=mesh)
        # the hook: identity projections, so apply_attention's layer
        # output is the attention output, (B, 1, H·D)
        b, h, _, d = q.shape
        kvh = k.shape[1]
        eye = torch.eye(h * d)
        prm = {"wq": eye, "wk": eye[:, :kvh * d], "wv": eye[:, :kvh * d],
               "wo": eye}
        cache = L.AttnCache(k=k[:, :, shard].clone(),
                            v=v[:, :, shard].clone(),
                            length=int(p["kv_len"]) - 1,
                            seq_axes=("model",))
        x = q.transpose(1, 2).reshape(b, 1, h * d)
        mesh.log.records.clear()
        with PT.mesh_scope(mesh):
            y = L.apply_attention(prm, x, n_heads=h, n_kv_heads=kvh,
                                  head_dim=d, rope_theta=None, policy=pol,
                                  cache=cache, backend="naive")
        sites = sorted({r.site for r in mesh.log.records})
        direct = lut_decode_sharded(q, cache.k, cache.v, pol,
                                    kv_len=int(p["kv_len"]), mesh=mesh)
        outs.append(dict(out=out.numpy(), hook=y.numpy(),
                         direct=direct.transpose(1, 2).reshape(b, 1, -1)
                         .numpy(), sites=sites))
    return outs if mesh.rank == 0 else None


def sharded_problems(mesh, paged, decode):
    """:func:`attention_problems` and :func:`decode_problems` in one
    spawn."""
    out = (attention_problems(mesh, paged), decode_problems(mesh, decode))
    return out if mesh.rank == 0 else None
