"""Rank bodies of the port's multi-rank CPU tests.

``tests/test_torch_multirank.py``, ``tests/test_torch_sharded_train.py``
and ``tests/test_torch_pipeline.py`` start these with
``repro_torch.launch.mesh.start_ranks`` (spawned gloo ranks over a
``file://`` store in the test's ``tmp_path``; no network).  This module
imports torch and the port only, so a rank starts without JAX; each
body returns rank 0's view of the results, with what every rank holds
gathered in.
"""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, RunConfig
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax, tree_flatten
from repro_torch.models.moe import apply_moe
from repro_torch.runtime import partitioning as PT
from repro_torch.runtime.pipeline import gpipe_forward
from repro_torch.runtime.train_loop import (gather_train_state,
                                            make_grad_fn, make_train_step,
                                            shard_train_state, train_state)

import torch_tp_ranks as R


def _gather_objects(obj):
    """Every rank's ``obj``, in world-rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


# ---------------------------------------------------------------------------
# Expert-parallel serving
# ---------------------------------------------------------------------------


def _expert_bytes(params) -> int:
    """Bytes of the routed experts' stacked weights."""
    return sum(x.nbytes for path, x in tree_flatten(params)
               if path.split("/")[-2] == "ffn"
               and path.rsplit("/", 1)[-1] in ("w_gate", "w_up", "w_down"))


def ep_serving(mesh, cases, trees):
    """The cases through the engines with ``shard_params``
    (``torch_tp_ranks.engine_cases``), plus every rank's expert bytes by
    weights key."""
    out = R.engine_cases(mesh, cases, trees)
    mine = {}
    for case in cases:
        key = R.case_key(case)
        arch = R.arch_of(case["kvh"], case["heads"], case["base"])
        cut = params_from_jax(trees[key], device="cpu", mesh=mesh, cfg=arch)
        mine[key] = _expert_bytes(cut)
    every = _gather_objects(mine)
    return out, every


def eptp_moe(mesh, p_np, x_np, kw):
    """One MoE layer whose expert count the ranks do not divide: every
    rank holds a ``d_expert / tp`` slice of every expert ("EPTP");
    rank 0 returns the output, its leaves' shapes and the log."""
    p = {k: torch.from_numpy(v) for k, v in p_np.items()}
    split = PT.expert_split(mesh, kw["n_experts"], kw["d"], kw["d_expert"])
    assert split[0] == "columns", split
    lo, hi = split[1:]
    local = {"router": p["router"],
             "w_gate": p["w_gate"][:, :, lo:hi].contiguous(),
             "w_up": p["w_up"][:, :, lo:hi].contiguous(),
             "w_down": p["w_down"][:, lo:hi].contiguous()}
    mesh.log.clear()
    # weights cut (an MoE layer reads no leaf's compute spec)
    with torch.no_grad(), PT.mesh_scope(mesh, compute={}):
        out = apply_moe(local, torch.from_numpy(x_np),
                        n_experts=kw["n_experts"], top_k=kw["top_k"],
                        d_expert=kw["d_expert"])
    return (out.numpy(), tuple(local["w_gate"].shape),
            [dataclasses.astuple(r) for r in mesh.log.records])


# ---------------------------------------------------------------------------
# The sharded train step
# ---------------------------------------------------------------------------


def _arch(spec):
    arch = ARCHS[spec["base"]].scaled_down(**spec["scale"])
    if "capacity_factor" in spec:
        arch = dataclasses.replace(arch, moe=dataclasses.replace(
            arch.moe, capacity_factor=spec["capacity_factor"]))
    return arch


def _run(spec) -> RunConfig:
    return RunConfig(dtype="float32", attention_backend="naive",
                     remat=spec.get("remat", True),
                     microbatch=spec.get("microbatch", 1),
                     grad_compression=spec.get("grad_compression", False),
                     learning_rate=spec.get("lr", 3e-4))


def _whole_numpy(tree):
    return {p: x.detach().numpy().copy() for p, x in tree_flatten(tree)}


def _resident(state) -> dict:
    def nbytes(tree):
        return sum(x.nbytes for _, x in tree_flatten(tree))
    return {"params": nbytes(state.params), "m": nbytes(state.opt.m),
            "v": nbytes(state.opt.v)}


def roundtrip(mesh, arch_names, ckpt_dir):
    """For each arch (scaled down, the port's seeded init): the
    training layout's cut of the whole tree, gathered back and through a
    checkpoint save (``save(mesh=)``) and restore, then cut again; a
    Mamba ``in_proj`` cut is the rank's ``x`` and ``z`` columns.  Each
    rank reports, by arch, whether the gather equals the whole tree
    bitwise, the second cut the first, every cut leaf the rule's shape,
    and its ``in_proj`` columns; rank 0 returns every rank's report."""
    report = {}
    for name in arch_names:
        arch = ARCHS[name].scaled_down(d_model=64, n_heads=4, vocab=128,
                                       n_periods=1)
        whole = build_model(arch).init(torch.Generator().manual_seed(3),
                                       "cpu")
        layout = PT.Layout(arch, mesh)
        cut = layout.cut(whole)
        flat_whole, flat_cut = tree_flatten(whole), tree_flatten(cut)
        shapes = all(tuple(x.shape) == PT.local_shape(
            tuple(w.shape), layout.specs[p], mesh)
            for (p, w), (_, x) in zip(flat_whole, flat_cut))
        back = layout.gather(cut)
        gathered = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            flat_whole, tree_flatten(back)))
        mgr = CheckpointManager(f"{ckpt_dir}/{name}")
        mgr.save(back, step=1, mesh=mesh)
        restored, _ = mgr.restore_latest(whole)
        again = layout.cut(restored)
        recut = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            flat_cut, tree_flatten(again)))
        in_proj = True
        for path, x in flat_cut:
            if path.endswith("mixer/in_proj"):
                w = dict(flat_whole)[path]
                di, tp = w.shape[-1] // 2, mesh.tp
                c, m = di // tp, mesh.rank
                rows = PT.cut_leaf(w, (None, layout.specs[path][1]), mesh)
                want = torch.cat([rows[..., m * c:(m + 1) * c],
                                  rows[..., di + m * c:di + (m + 1) * c]],
                                 dim=-1)
                in_proj = in_proj and torch.equal(x, want)
        report[name] = dict(shapes=shapes, gathered=gathered, recut=recut,
                            in_proj=in_proj)
    every = _gather_objects(report)
    return every if mesh.world_rank == 0 else None


def train_cases(mesh, cases, tree_of, batches_of, roundtrip_args=None):
    """Each case: this rank's cut of the seeded init (``tree_of[case]``,
    numpy), the first step's gradients (gathered whole), then ``steps``
    train steps on ``batches_of[case]``; rank 0 returns per case the
    losses, norms, whole gradients, whole final params, every rank's
    resident bytes and the step's collective bytes by site — and, given
    ``roundtrip_args``, :func:`roundtrip`'s reports under
    ``"roundtrip"``."""
    results = {}
    if roundtrip_args is not None:
        results["roundtrip"] = roundtrip(mesh, *roundtrip_args)
    for spec in cases:
        name = spec["name"]
        arch = _arch(spec)
        model, run = build_model(arch), _run(spec)
        params = params_from_jax(tree_of[name], device="cpu")
        step = make_train_step(model, run, mesh=mesh)
        layout = step.layout
        state = shard_train_state(train_state(params, run), layout)
        batches = [{"tokens": torch.from_numpy(b)} for b in batches_of[name]]
        loss0, grads = make_grad_fn(model, run, mesh)(state.params,
                                                      batches[0])
        whole_grads = _whole_numpy(layout.gather(grads))
        losses, norms = [], []
        mesh.log.clear()
        for i, batch in enumerate(batches):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            if i == 0:
                step_bytes = mesh.log.by_site()
        resident = _gather_objects(_resident(state))
        final = gather_train_state(state, layout)
        if mesh.world_rank == 0:
            results[name] = dict(
                loss0=float(loss0), losses=losses, norms=norms,
                grads=whole_grads, params=_whole_numpy(final.params),
                resident=resident, step_bytes=step_bytes,
                specs={p: layout.specs[p] for p in layout.specs})
    return results


def elastic_segment(mesh, spec, tree, batches, ckpt_dir, first, last):
    """Train steps ``first … last − 1`` on this mesh: from the seeded
    init (``first == 0``) or the checkpoint in ``ckpt_dir``, then save
    whole leaves there; rank 0 returns the whole final params."""
    arch = _arch(spec)
    model, run = build_model(arch), _run(spec)
    whole = train_state(params_from_jax(tree, device="cpu"), run)
    mgr = CheckpointManager(ckpt_dir)
    if first:
        whole, at = mgr.restore_latest(whole)
        assert at == first, at
    step = make_train_step(model, run, mesh=mesh)
    state = shard_train_state(whole, step.layout)
    for i in range(first, last):
        state, _ = step(state, {"tokens": torch.from_numpy(batches[i])})
    final = gather_train_state(state, step.layout)
    mgr.save(final, step=last, mesh=mesh)
    return _whole_numpy(final.params)


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------


def gpipe(mesh, ws, x):
    """Stage ``pipe_rank`` of ``tanh(x @ w)`` stages: rank 0 returns the
    pipeline's output and every stage's weight gradient of
    ``Σ out²``."""
    w = torch.from_numpy(ws[mesh.pipe_rank]).requires_grad_(True)
    out = gpipe_forward(lambda p, h: torch.tanh(h @ p["w"]), {"w": w},
                        torch.from_numpy(x), mesh, axis="pipe")
    (out ** 2).sum().backward()
    grads = _gather_objects(w.grad.numpy())
    return out.detach().numpy(), np.stack(grads)
