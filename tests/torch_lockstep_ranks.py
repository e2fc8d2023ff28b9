"""Rank bodies of ``tests/test_torch_lockstep_mesh.py``: lockstep serving
and the encoder-decoder's train step on a mesh of spawned gloo ranks.

This module imports torch and the port only, so a rank starts without
JAX; each body returns rank 0's view, with every rank's rows gathered
in.
"""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, RunConfig
from repro_torch.core.policies import SoftmaxPolicy
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax, tree_flatten
from repro_torch.runtime import partitioning as PT
from repro_torch.runtime.serve_loop import (make_decode_step,
                                            make_prefill_step,
                                            serving_layout)
from repro_torch.runtime.train_loop import (make_grad_fn, shard_train_state,
                                            train_state)


def policy_of(impl: str) -> SoftmaxPolicy:
    return (SoftmaxPolicy(impl=impl, precision="uint8") if impl != "exact"
            else SoftmaxPolicy())


def arch_of(spec):
    arch = ARCHS[spec["base"]].scaled_down(**spec["scale"])
    return dataclasses.replace(arch, **spec.get("replace", {}))


def _rows_of(mesh, x: torch.Tensor) -> list:
    """Every rank's rows, in world-rank order (gathered objects)."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, x.numpy())
    return out


def _global(mesh, b: int, x: torch.Tensor) -> np.ndarray:
    """The global (B, …) array from each rank's rows of it."""
    every = _rows_of(mesh, x)
    axes = PT.row_axes(mesh, b)
    if not axes:
        return every[0]
    # world ranks whose 'model' index is 0 hold distinct row blocks, in
    # the row-major order of the row axes; replicas repeat them
    blocks = {}
    for r, rows in enumerate(every):
        p, rest = divmod(r, mesh.data * mesh.tp)
        d, m = divmod(rest, mesh.tp)
        idx = {"pod": p, "data": d, "model": m}
        i = 0
        for a in axes:
            i = i * mesh.size(a) + idx[a]
        blocks.setdefault(i, rows)
    return np.concatenate([blocks[i] for i in range(len(blocks))], axis=0)


def serve_cases(mesh, cases, trees, prompts, frames):
    """Each case: the JAX package's seeded init ``trees[name]`` cut by
    the serving layout, the prompt's last logits and ``steps`` greedy
    decode steps on this rank's rows; rank 0 returns per case the
    global logits of each step, the tokens and the collective sites."""
    results = {}
    for case in cases:
        name = case["name"]
        arch = arch_of(case)
        model = build_model(arch)
        run = RunConfig(dtype="float32", softmax_policy=policy_of(
            case["impl"]), attention_backend="naive",
            shard_kv_seq=case.get("shard_kv_seq", False))
        whole = params_from_jax(trees[case["tree"]], device="cpu")
        params = serving_layout(model, mesh).cut(whole)
        b = prompts[case["tree"]].shape[0]
        lo, hi = PT.row_range(mesh, b)
        tokens = torch.from_numpy(prompts[case["tree"]][lo:hi])
        enc = (torch.from_numpy(frames[case["tree"]][lo:hi])
               if model.is_encdec else None)
        prefill = make_prefill_step(model, run, case["max_len"], mesh=mesh,
                                    batch=b)
        decode = make_decode_step(model, run, mesh=mesh, batch=b)
        mesh.log.clear()
        logits, state = prefill(params, tokens, encoder_input=enc)
        steps = [_global(mesh, b, logits[:, -1])]
        toks = [_global(mesh, b, logits[:, -1].argmax(-1))]
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        for _ in range(case["steps"]):
            logits, state = decode(params, tok, state)
            steps.append(_global(mesh, b, logits[:, -1]))
            toks.append(_global(mesh, b, logits[:, -1].argmax(-1)))
            tok = logits[:, -1:].argmax(-1).to(torch.int32)
        shapes = sorted({tuple(x.shape) for _, x in tree_flatten(
            state if not model.is_encdec else state[0])
            if isinstance(x, torch.Tensor)})
        if mesh.world_rank == 0:
            results[name] = dict(logits=steps, tokens=toks,
                                 sites=sorted(mesh.log.by_site()),
                                 cache_shapes=shapes)
    return results


def _whole_numpy(tree):
    return {p: x.detach().numpy().copy() for p, x in tree_flatten(tree)}


def encdec_grads(mesh, spec, tree, batch):
    """The encoder-decoder's loss and whole gradients of one sharded
    grad step on the mesh (every rank given the global batch)."""
    arch = arch_of(spec)
    model = build_model(arch)
    run = RunConfig(dtype="float32", attention_backend="naive", remat=True)
    grad_fn = make_grad_fn(model, run, mesh)
    state = shard_train_state(
        train_state(params_from_jax(tree, device="cpu"), run),
        grad_fn.layout)
    loss, grads = grad_fn(state.params, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    whole = _whole_numpy(grad_fn.layout.gather(grads))
    return (dict(loss=float(loss), grads=whole)
            if mesh.world_rank == 0 else None)
