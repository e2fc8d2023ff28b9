"""Parameter trees: conversion from the JAX package, casting, mapping.

The port keeps the JAX package's parameter tree (nested dicts and lists)
and its ``(in, out)`` weight layout, so conversion is a tree map over
numpy arrays: no transposes, the period blocks of a decoder stay stacked
on their leading axis, and an encoder-decoder's ``encoder`` /
``decoder`` lists of blocks stay lists.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.device import resolve_device


def tree_map(fn, tree, name: str = ""):
    """``fn(leaf, name)`` over a tree of dicts, lists and tuples; ``name``
    is the dict key the leaf sits under (norm scales are ``"scale"``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, name) for v in tree)
    return fn(tree, name)


#: the leaves that stay f32 in any serving dtype, because the JAX package
#: reads them in f32 from its f32 masters: a norm's scale and its
#: LayerNorm bias (``init_norm``); an MoE FFN's ``router``, whose logits
#: are computed in f32 (a bf16 router would move expert choices); Mamba's
#: step projection and bias, A and skip (``dt_proj``, ``dt_bias``,
#: ``a_log``, ``d_skip``: the decay and drive are f32); the xLSTM gates'
#: projections and biases (``w_igate``, ``w_fgate``, ``fgate_bias``) and
#: sLSTM's recurrent weights (``r_*``, contracted with the f32 state).
#: Matching is by leaf name: ``bias`` is a LayerNorm's only.
F32_LEAVES = ("scale", "bias", "router", "dt_proj", "dt_bias", "a_log",
              "d_skip", "w_igate", "w_fgate", "fgate_bias", "r_z", "r_i",
              "r_f", "r_o")


def cast_params(params, dtype: torch.dtype):
    """Cast weights and projection biases to ``dtype`` (the serving dtype
    on the card); the :data:`F32_LEAVES` stay f32, as the JAX package
    keeps every master in f32 and reads those in f32."""
    return tree_map(
        lambda t, name: t if name in F32_LEAVES else t.to(dtype), params)


def params_from_jax(tree, device="cuda",
                    dtype: torch.dtype | None = None, *, mesh=None,
                    cfg=None):
    """JAX parameter tree (leaves numpy-convertible arrays) → the same
    tree of tensors on ``device`` (the card unless ``device="cpu"``),
    cast like :func:`cast_params` when ``dtype`` is given.

    With a tensor-parallel ``mesh`` (and the decoder's ``cfg``) the tree
    is rank ``mesh.rank``'s shard under ``shard_params``
    (``partitioning.shard_params``): only the rank's slice of each cut
    leaf is copied to the device."""
    device = resolve_device(device)
    if mesh is not None:
        from repro_torch.runtime.partitioning import shard_params
        tree = shard_params(tree_map(lambda x, _: np.asarray(x), tree), cfg,
                            mesh)
    params = tree_map(
        lambda x, _: torch.from_numpy(np.array(x, copy=True)).to(device),
        tree)
    return params if dtype is None else cast_params(params, dtype)


def pool_from_jax(pool, device="cuda") -> dict[str, torch.Tensor]:
    """One layer's (or a periods-stacked) JAX paged pool → the same leaves
    as tensors on ``device`` (the card unless ``device="cpu"``), dtypes
    kept: an int8 pool keeps its int8 pages and f32 ``k_scales`` /
    ``v_scales``, so the port's kernels read the very bytes the JAX
    package's kernels read."""
    device = resolve_device(device)
    out = {name: torch.from_numpy(np.array(x, copy=True)).to(device)
           for name, x in pool.items()}
    if out["k_pages"].dtype == torch.int8:
        for name in ("k_scales", "v_scales"):
            if name not in out or out[name].dtype != torch.float32:
                raise ValueError(f"an int8 pool needs float32 {name}")
    return out


def _children(tree):
    """``(path part, child)`` of a tree node in the JAX package's
    flattening order and path spelling: a dict's keys sorted, a list's
    or tuple's indices, a dataclass's fields as ``.name``; None for a
    leaf.  A None child is a node with no leaves, as in JAX."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f".{f.name}", getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return None


def tree_flatten(tree, prefix: str = ""):
    """``[(path, leaf)]`` of a tree of dicts, lists, tuples and
    dataclasses, in ``jax.tree_util.tree_flatten_with_path``'s order,
    with the JAX checkpoint's path strings (``.params/embed/table``,
    ``.opt/.m/periods/0/ffn/w_down``)."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for part, child in kids:
        out += tree_flatten(child, f"{prefix}/{part}" if prefix else part)
    return out


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` whose leaves are taken in
    :func:`tree_flatten` order from the iterable ``leaves``."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{
                f.name: build(getattr(node, f.name))
                for f in dataclasses.fields(node)})
        return next(it)

    return build(like)
