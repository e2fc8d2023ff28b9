"""Parameter trees: conversion from the JAX package, casting, mapping.

The port keeps the JAX package's parameter tree (nested dicts and lists)
and its ``(in, out)`` weight layout, so conversion is a tree map over
numpy arrays: no transposes, the period blocks stay stacked on their
leading axis.
"""

from __future__ import annotations

import numpy as np
import torch


def tree_map(fn, tree, name: str = ""):
    """``fn(leaf, name)`` over a tree of dicts, lists and tuples; ``name``
    is the dict key the leaf sits under (norm scales are ``"scale"``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, name) for v in tree)
    return fn(tree, name)


def cast_params(params, dtype: torch.dtype):
    """Cast weights and biases to ``dtype`` (the serving dtype on the
    card); norm scales stay f32, as the JAX package keeps every master in
    f32 and casts at use."""
    return tree_map(lambda t, name: t if name == "scale" else t.to(dtype),
                    params)


def params_from_jax(tree, device="cpu", dtype: torch.dtype | None = None):
    """JAX parameter tree (leaves numpy-convertible arrays) → the same
    tree of tensors on ``device``, cast like :func:`cast_params` when
    ``dtype`` is given."""
    params = tree_map(
        lambda x, _: torch.from_numpy(np.array(x, copy=True)).to(device),
        tree)
    return params if dtype is None else cast_params(params, dtype)
