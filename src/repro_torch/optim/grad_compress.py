"""Gradient compression with error feedback.

The JAX package's ``optim/grad_compress.py`` in torch: each gradient
tensor is quantized to int8 with one symmetric per-tensor scale after
the previous step's residual is added back, and the new residual is
kept for the next step (EF-SGD), so the compression stays unbiased over
steps.  Rounding is half to even (``torch.round``, as ``jnp.round``).
The numerics are modelled on one device; no collective runs here.
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


def compress_grads(grads: Tree, ef: Tree) -> tuple[Tree, Tree, dict]:
    """Returns (dequantized int8 grads, new error feedback, stats):
    ``stats["compress_residual"]`` is the mean over tensors of each new
    residual's mean magnitude."""
    deq, resid, err = [], [], []
    for (_, g), (_, e) in zip(tree_flatten(grads), tree_flatten(ef)):
        g = g.float() + e                      # re-inject the residual
        scale = torch.clamp(g.abs().max() / Q_MAX, min=1e-12)
        q = torch.clamp(torch.round(g / scale), -Q_MAX, Q_MAX)
        d = q * scale
        deq.append(d)
        resid.append(g - d)                    # residual → next step
        err.append(resid[-1].abs().mean())
    return (tree_unflatten(grads, deq), tree_unflatten(ef, resid),
            {"compress_residual": torch.stack(err).mean()})
