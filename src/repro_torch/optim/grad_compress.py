"""Gradient compression with error feedback.

The JAX package's ``optim/grad_compress.py`` in torch: each gradient
tensor is quantized to int8 with one symmetric per-tensor scale after
the previous step's residual is added back, and the new residual is
kept for the next step (EF-SGD), so the compression stays unbiased over
steps.  Rounding is half to even (``torch.round``, as ``jnp.round``).
The numerics are modelled on one device; on a rank's cuts of a sharded
tree the caller's ``reduce`` makes each scale the whole leaf's.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.convert import tree_flatten, tree_unflatten

Tree = Any
Q_MAX = 127.0


def init_error_feedback(params: Tree) -> Tree:
    """Zero f32 residuals shaped like ``params``."""
    return tree_unflatten(params, [
        torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for _, p in tree_flatten(params)])


def compress_grads(grads: Tree, ef: Tree,
                   reduce=None) -> tuple[Tree, Tree, dict]:
    """Returns (dequantized int8 grads, new error feedback, stats):
    ``stats["compress_residual"]`` is the mean over tensors of each new
    residual's mean magnitude.  On a rank's cuts of the leaves,
    ``reduce`` (``partitioning.Layout.reduce_leaves``) makes each scale
    the whole leaf's amax (a max over the axes it is cut on) and each
    mean the whole leaf's."""
    flat_g, flat_e = tree_flatten(grads), tree_flatten(ef)
    paths = [p for p, _ in flat_g]
    gs = [g.float() + e for (_, g), (_, e) in zip(flat_g, flat_e)]
    amax = torch.stack([g.abs().max() for g in gs])
    if reduce is not None:
        amax = reduce(paths, amax, "max")
        sizes = reduce(paths, torch.tensor([float(g.numel()) for g in gs],
                                           device=amax.device), "sum")
    deq, resid, err = [], [], []
    for g, a in zip(gs, amax):                 # g: grad + residual
        scale = torch.clamp(a / Q_MAX, min=1e-12)
        q = torch.clamp(torch.round(g / scale), -Q_MAX, Q_MAX)
        d = q * scale
        deq.append(d)
        resid.append(g - d)                    # residual → next step
        err.append(resid[-1].abs().mean() if reduce is None
                   else resid[-1].abs().sum())
    err = torch.stack(err)
    if reduce is not None:
        err = reduce(paths, err, "sum") / sizes
    return (tree_unflatten(grads, deq), tree_unflatten(ef, resid),
            {"compress_residual": err.mean()})
