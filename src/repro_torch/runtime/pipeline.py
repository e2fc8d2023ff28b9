"""Pipeline parallelism: the GPipe microbatch schedule over a mesh axis.

The counterpart of the JAX package's ``runtime/pipeline.py``.  Stage i
is rank i of a ``('pipe',)`` mesh (``launch.mesh.make_pipe_mesh``) and
holds its own slice of the layer stack.  The schedule is the classic
GPipe fill-drain, the JAX package's tick for tick: ``T = n_micro +
n_stages − 1`` ticks; at tick t stage 0 feeds microbatch
``clip(t, 0, n_micro − 1)`` (the bubbles compute on a real microbatch
and are never written out), every other stage the activation the stage
before it sent at tick t − 1; the last stage writes microbatch
``t − (S − 1)`` when it is in range; then each stage sends its output
downstream.  The outputs reach every rank, as the JAX package's masked
``psum`` delivers them.

Backward: the whole schedule is one ``torch.autograd.Function`` per
rank.  Its forward keeps each tick's stage graph; its backward walks the
ticks in reverse, receives the gradient of the activation it sent
downstream, backpropagates through its stage, and sends the gradient of
the activation it received upstream — the JAX package's transposed
``ppermute`` — so the stage parameters' gradients are those of the
sequential stack.  Only the last stage's loss gradient enters (every
rank holds the same outputs, as the JAX package's one output does).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.models.convert import tree_flatten, tree_map, tree_unflatten
from repro_torch.runtime import partitioning as PT

Tensor = torch.Tensor


def _peer(mesh, axis: str, index: int) -> int:
    """The global rank of index ``index`` along ``axis``."""
    return dist.get_global_rank(mesh.group_of(axis), index)


def _send(x: Tensor, mesh, axis: str, to: int, site: str):
    buf = PT._staged(x, mesh)
    mesh.log.add(site, "send", buf)
    return dist.isend(buf, dst=_peer(mesh, axis, to),
                      group=mesh.group_of(axis)), buf


def _recv(like: Tensor, mesh, axis: str, frm: int, site: str) -> Tensor:
    host = mesh.backend == "gloo" and like.is_cuda
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if host else like.device)
    dist.recv(buf, src=_peer(mesh, axis, frm), group=mesh.group_of(axis))
    mesh.log.add(site, "recv", buf)
    return buf.to(like.device)


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, like, mesh, axis, mbs, *leaves):
        s, idx = mesh.size(axis), mesh.index(axis)
        n_micro = mbs.shape[0]
        total = n_micro + s - 1
        params = [p.detach().requires_grad_(p.requires_grad)
                  for p in leaves]
        tree = tree_unflatten(like, params)
        ticks = []              # (x, y) of every tick, with y's graph
        outs = torch.zeros_like(mbs)
        buf = torch.zeros_like(mbs[0])
        for t in range(total):
            feed = mbs[min(max(t, 0), n_micro - 1)]
            x = (feed if idx == 0 else buf).detach().requires_grad_(True)
            with torch.enable_grad():
                y = stage_fn(tree, x)
            ticks.append((x, y))
            mb = t - (s - 1)
            if idx == s - 1 and 0 <= mb < n_micro:
                outs[mb] = y.detach()
            pending = None
            if idx < s - 1:
                pending = _send(y.detach(), mesh, axis, idx + 1, "pipe")
            if idx > 0:
                buf = _recv(y, mesh, axis, idx - 1, "pipe")
            if pending is not None:
                pending[0].wait()
        # the last stage's outputs to every rank (the masked psum)
        outs = PT.all_reduce(outs if idx == s - 1 else torch.zeros_like(
            outs), mesh, "sum", site="pipe.out", axis=axis)
        ctx.state = (mesh, axis, ticks, params, n_micro)
        return outs

    @staticmethod
    def backward(ctx, g_outs):
        mesh, axis, ticks, params, n_micro = ctx.state
        s, idx = mesh.size(axis), mesh.index(axis)
        grads = [torch.zeros_like(p) for p in params]
        g_mbs = torch.zeros_like(g_outs)
        for t in reversed(range(len(ticks))):
            x, y = ticks[t]
            g_y = torch.zeros_like(y)
            mb = t - (s - 1)
            if idx == s - 1 and 0 <= mb < n_micro:
                g_y = g_y + g_outs[mb]
            if idx < s - 1 and t + 1 < len(ticks):
                # the stage after used our tick-t output at tick t + 1
                g_y = g_y + _recv(y, mesh, axis, idx + 1, "pipe.bwd")
            need = [x] + [p for p in params if p.requires_grad]
            got = torch.autograd.grad(y, need, g_y, allow_unused=True)
            g_x, g_p = got[0], iter(got[1:])
            for i, p in enumerate(params):
                if p.requires_grad:
                    gp = next(g_p)
                    if gp is not None:
                        grads[i] += gp
            if g_x is None:
                g_x = torch.zeros_like(x)
            if idx > 0 and t > 0:
                req, _ = _send(g_x, mesh, axis, idx - 1, "pipe.bwd")
                req.wait()
            elif idx == 0 and t < n_micro:
                g_mbs[t] += g_x
        ticks.clear()
        return (None, None, None, None, g_mbs, *grads)


def gpipe_forward(stage_fn: Callable, stage_params, microbatches: Tensor,
                  mesh, axis: str = "pipe") -> Tensor:
    """Run the pipeline; returns the ``(n_micro, mb, ...)`` outputs of
    the last stage on every rank.

    ``stage_fn(params, x) → y`` (y shaped like x) is one stage;
    ``stage_params`` is this rank's stage's tree of tensors (the JAX
    package's ``stage_params[i]`` on stage i); ``microbatches`` the
    replicated ``(n_micro, mb, ...)`` input.  Differentiable in the
    stage parameters and the microbatches."""
    flat = [x for _, x in tree_flatten(stage_params)]
    return _GPipe.apply(stage_fn, stage_params, mesh, axis, microbatches,
                        *flat)


def make_stage_fn(apply_period, n_periods_per_stage: int):
    """A stage fn over a period-stacked slice of the layer stack:
    ``apply_period(period_params, h) → h`` for each of its
    ``n_periods_per_stage`` periods in order (the JAX package's scan)."""
    def stage_fn(stage_periods, x):
        for i in range(n_periods_per_stage):
            x = apply_period(tree_map(lambda a, _: a[i], stage_periods), x)
        return x
    return stage_fn
