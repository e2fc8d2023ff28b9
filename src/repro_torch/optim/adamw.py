"""AdamW over trees of f32 master tensors, with decoupled weight decay.

The JAX package's ``optim/adamw.py`` in torch, in its order of
operations: clip the gradients by their global norm
(``scale = min(1, max_norm / max(norm, 1e-9))``), advance the step, read
the learning rate at the new step, correct the moments' bias with
``1 - b**step`` in f32, and move each parameter by
``lr · ((m / b1c) / (sqrt(v / b2c) + eps) + wd · p)``, the decay only on
the leaves :func:`decay_mask` names.  ``torch.optim.AdamW`` differs from
this in its clip epsilon, in where its decay applies and in the step
its schedule reads, so the port does not use it.

The state is a tree, :class:`AdamWState` ``(step, m, v)``, whose moments
mirror the parameters' tree, so a checkpoint of it carries the JAX
package's paths (``.opt/.step``, ``.opt/.m/…``, ``.opt/.v/…``).  Unlike
the JAX package's functional update, :func:`adamw_update` writes the
parameters, the moments and the clipped gradients in place, one leaf at
a time: at 2.5B parameters a second copy of the f32 masters or moments
does not fit beside the first.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models.convert import tree_flatten, tree_unflatten

Tensor = torch.Tensor
Tree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float | Callable[[Tensor], Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


@dataclasses.dataclass
class AdamWState:
    step: Tensor   # int32 scalar
    m: Tree        # first moment (f32, param-shaped)
    v: Tree        # second moment


def init_adamw(params: Tree) -> AdamWState:
    """Step 0 and zero f32 moments on the parameters' devices."""
    leaves = [p for _, p in tree_flatten(params)]

    def zeros():
        return tree_unflatten(params, [
            torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in leaves])
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=leaves[0].device),
                      m=zeros(), v=zeros())


def global_norm(tree: Tree, reduce=None) -> Tensor:
    """The f32 L2 norm of every leaf of ``tree`` together.  ``reduce``
    (``partitioning.Layout.reduce_leaves``) makes it the norm of whole
    leaves of which ``tree`` holds this rank's cuts: each leaf's squared
    sum is summed over the axes that leaf is cut on, and only those, so
    a replicated leaf counts once."""
    flat = tree_flatten(tree)
    norms = torch.stack(torch._foreach_norm([g.float() for _, g in flat]))
    if reduce is None:
        return torch.linalg.vector_norm(norms)
    sq = reduce([p for p, _ in flat], norms * norms, "sum")
    return torch.sqrt(sq.sum())


def clip_by_global_norm(grads: Tree, max_norm: float,
                        reduce=None) -> tuple[Tree, Tensor]:
    """Scale the f32 ``grads`` in place by
    ``min(1, max_norm / max(norm, 1e-9))``; returns them and the norm."""
    norm = global_norm(grads, reduce)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    torch._foreach_mul_([g for _, g in tree_flatten(grads)], scale)
    return grads, norm


def decay_mask(path: str) -> bool:
    """Decay matmul weights only: no norms, biases or 1-D tensors, by the
    JAX package's substring rule on the leaf's path."""
    keys = path.lower()
    return not any(t in keys for t in ("norm", "bias", "scale", "a_log",
                                       "d_skip", "dt_bias", "fgate_bias"))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Tree, grads: Tree,
                 state: AdamWState, reduce=None
                 ) -> tuple[Tree, AdamWState, dict]:
    """One AdamW step; returns ``(params, state, stats)`` with ``stats``
    the pre-clip ``grad_norm`` and the step's ``lr`` (f32 tensors).
    ``params``, ``state.m``, ``state.v`` and ``grads`` (f32) are
    updated in place; the returned state holds the new step.  On a
    rank's shards of a sharded state, ``reduce`` makes the clip norm the
    whole tree's (:func:`global_norm`); the update itself is
    element-wise, so it runs on the shards as they are."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, reduce)
    step = state.step + 1
    lr = (cfg.learning_rate(step) if callable(cfg.learning_rate)
          else cfg.learning_rate)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    for (path, p), (_, g), (_, m), (_, v) in zip(
            tree_flatten(params), tree_flatten(grads),
            tree_flatten(state.m), tree_flatten(state.v)):
        g = g.float()
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        update = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        if cfg.weight_decay and decay_mask(path):
            update.add_(p, alpha=cfg.weight_decay)
        p.sub_(update.mul_(lr))
    lr = torch.as_tensor(lr, dtype=torch.float32, device=step.device)
    return params, AdamWState(step=step, m=state.m, v=state.v), {
        "grad_norm": gnorm, "lr": lr}
