"""Training step: loss, microbatch accumulation, AdamW, grad compression.

The JAX package's ``runtime/train_loop.py`` in torch.
``make_train_step`` returns ``(state, batch) → (state, metrics)``: the
loss's backward accumulates f32 gradients on the masters (``.grad``,
one backward per microbatch, divided by their count afterwards), the
optional int8 compression with error feedback runs on them, and
``optim.adamw_update`` moves the masters and the moments in place.  The
metrics stay tensors on the device; reading them (``float``) is the
step's only sync.  ``make_eval_step`` scores a batch through the serving
``prefill`` under the run's softmax policy: exact against LUT
evaluation, the paper's accuracy comparison, on the dense LUT-attention
kernel on the card.

The masters are f32 and the activations follow ``run.dtype``: every
layer casts its weights to the activation dtype (``.to(x.dtype)``), so
the gradients reach the masters in f32 through those casts.  The train
forward runs the exact softmax (``Model.train_logits``); no kernel of
the port has a backward, and the dense kernel's wrapper refuses
tensors that require grad.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models.convert import tree_flatten, tree_unflatten
from repro_torch.models.model_zoo import Model
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_update,
                                     init_adamw)
from repro_torch.optim.grad_compress import (compress_grads,
                                             init_error_feedback)
from repro_torch.runtime import partitioning as PT

Tensor = torch.Tensor
Tree = Any


@dataclasses.dataclass
class TrainState:
    params: Tree        # f32 master weights (leaves that require grad)
    opt: AdamWState
    ef: Tree | None     # error-feedback buffers (grad compression) or None


def train_state(params: Tree, run: RunConfig) -> TrainState:
    """A fresh state over f32 ``params`` (which this marks as requiring
    grad): step 0, zero moments, zero residuals under grad
    compression."""
    for _, p in tree_flatten(params):
        if p.dtype != torch.float32:
            raise TypeError(f"master weights are float32, got {p.dtype}")
        p.requires_grad_(True)
    return TrainState(
        params=params, opt=init_adamw(params),
        ef=init_error_feedback(params) if run.grad_compression else None)


def init_train_state(model: Model, generator: torch.Generator,
                     run: RunConfig, device="cuda") -> TrainState:
    """:func:`train_state` over ``model.init``'s f32 parameters, drawn
    from ``generator`` on ``device`` (the card unless ``"cpu"``)."""
    return train_state(model.init(generator, device), run)


def cross_entropy(logits: Tensor, labels: Tensor,
                  label_smoothing: float = 0.0) -> Tensor:
    """Mean next-token cross entropy of (B, S, V) logits in f32: the
    logsumexp less the gold logit (a gather, which gives the JAX
    package's one-hot contraction exactly), mixed with the uniform
    target's ``lse - mean(logits)`` under label smoothing."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if label_smoothing:
        smooth = lse - logits.mean(-1)
        nll = (1 - label_smoothing) * nll + label_smoothing * smooth
    return nll.mean()


def make_loss_fn(model: Model, run: RunConfig):
    """``loss_fn(params, batch) → (loss, {"ce_loss": loss})``: next-token
    cross entropy of ``batch["tokens"]`` (B, S + 1) plus
    ``run.moe_aux_weight`` times the MoE load-balance loss."""
    def loss_fn(params, batch):
        tokens = batch["tokens"]
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        logits, aux = model.train_logits(
            params, inputs, run, encoder_input=batch.get("encoder_input"))
        loss = cross_entropy(logits, labels, run.label_smoothing)
        lb = aux.get("load_balance_loss")
        if lb is not None and run.moe_aux_weight:
            loss = loss + run.moe_aux_weight * lb
        return loss, {"ce_loss": loss}
    return loss_fn


def _sharded(mesh) -> bool:
    return mesh is not None and mesh.world > 1


def make_grad_fn(model: Model, run: RunConfig, mesh=None):
    """``grad_fn(params, batch) → (loss, grads)``: the loss of the
    global ``batch`` and the f32 gradients of ``params`` (a tree shaped
    like them; ``.grad`` is left empty).  ``run.microbatch`` = a > 1
    splits the batch into a equal row blocks and averages their
    gradients and losses.

    With a ``('data', 'model')`` or ``('pod', 'data', 'model')``
    ``mesh`` of more than one rank, ``params`` are this rank's cut
    (:func:`shard_train_state`) and every rank is given the whole batch:
    each microbatch's rows are cut over the batch axes as
    ``batch_pspec`` cuts them (both, ``'data'`` alone, or none).  The
    layers gather each leaf's ``'data'`` cut just before use and compute
    on its ``'model'`` cut (``partitioning.Layout``); every gradient is
    summed over the batch axes — over ``'data'`` by the gathers'
    backward for the leaves cut there, by all-reduces otherwise — and
    divided by their degree, which is right whether the rows were cut or
    replicated.  The loss is the mean over the ranks the rows were cut
    over.  An encoder-decoder's encoder takes the same treatment as its
    decoder.  ``grad_fn.layout`` is the layout (None without a mesh)."""
    loss_fn = make_loss_fn(model, run)
    layout = PT.Layout(model.cfg, mesh) if _sharded(mesh) else None

    def grad_fn(params, batch) -> tuple[Tensor, Tree]:
        a = run.microbatch
        flat = tree_flatten(params)
        for _, p in flat:
            p.grad = None
        rows = batch["tokens"].shape[0]
        if rows % a:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{a} microbatches")
        n = rows // a
        batch_axes = PT.batch_axes(mesh) if layout is not None else ()
        dp = mesh.size(batch_axes) if layout is not None else 1
        cut_rows = PT.row_axes(mesh, n) if layout is not None else ()
        loss = None
        for i in range(a):
            lo, hi = i * n, (i + 1) * n
            if cut_rows:
                r0, r1 = PT.row_range(mesh, n)
                lo, hi = lo + r0, lo + r1
            mb = {k: v[lo:hi] for k, v in batch.items() if v is not None}
            scope = (PT.mesh_scope(mesh, tokens=cut_rows, layout=layout)
                     if layout is not None else contextlib.nullcontext())
            with scope:            # a remat's recomputation runs in it
                mb_loss, _ = loss_fn(params, mb)
                mb_loss.backward()
            mb_loss = mb_loss.detach()
            loss = mb_loss if loss is None else loss + mb_loss
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for _, p in flat]
        for _, p in flat:
            p.grad = None
        if dp > 1:
            # a leaf cut over 'data' had its gradient summed there by its
            # gather's backward; every other sum over the batch axes runs
            # here
            grads = [PT.all_reduce(g, mesh, "sum", site="grads", axis=tuple(
                ax for ax in batch_axes
                if not (ax == "data" and "data" in layout.axes(path))))
                for (path, _), g in zip(flat, grads)]
            loss = PT.all_reduce(loss, mesh, "sum", site="loss",
                                 axis=cut_rows) / mesh.size(cut_rows)
            torch._foreach_div_(grads, float(dp))
        if a > 1:
            torch._foreach_div_(grads, float(a))
            loss = loss / a
        return loss, tree_unflatten(params, grads)

    grad_fn.layout = layout
    return grad_fn


def make_train_step(model: Model, run: RunConfig,
                    opt_cfg: AdamWConfig | None = None, *, mesh=None):
    """``train_step(state, batch) → (state, metrics)``; the state's
    tensors are updated in place.  ``run.microbatch`` = a > 1 splits the
    batch into a equal row blocks and averages their gradients (f32)
    and losses.

    With a ``mesh`` (``launch.mesh.make_host_mesh``) the state is this
    rank's shard (:func:`shard_train_state`) and the batch the global
    one (:func:`make_grad_fn`); the clip norm and the compression's
    scales are the whole leaves' (``partitioning.Layout.reduce_leaves``)
    and AdamW moves the shards in place."""
    opt_cfg = opt_cfg or AdamWConfig(learning_rate=run.learning_rate,
                                     weight_decay=run.weight_decay,
                                     grad_clip=run.grad_clip)
    grad_fn = make_grad_fn(model, run, mesh)
    reduce = grad_fn.layout.reduce_leaves if grad_fn.layout else None

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState,
                                                            dict]:
        loss, grads = grad_fn(state.params, batch)
        metrics = {"loss": loss}
        ef = state.ef
        if run.grad_compression:
            grads, ef, cstats = compress_grads(grads, state.ef, reduce)
            metrics.update(cstats)
        params, opt, ostats = adamw_update(opt_cfg, state.params, grads,
                                           state.opt, reduce)
        metrics.update(ostats)
        return TrainState(params=params, opt=opt, ef=ef), metrics

    train_step.layout = grad_fn.layout
    return train_step


def _map_state(state: TrainState, fn) -> TrainState:
    """``fn`` over the parameter-shaped trees of a state (params, the
    moments, the error feedback); the step is kept."""
    return TrainState(
        params=fn(state.params),
        opt=AdamWState(step=state.opt.step, m=fn(state.opt.m),
                       v=fn(state.opt.v)),
        ef=None if state.ef is None else fn(state.ef))


def shard_train_state(state: TrainState, layout) -> TrainState:
    """This rank's cut of a whole state (``partitioning.Layout.cut``:
    the FSDP rows over ``'data'``, tensor and expert parallelism over
    ``'model'``); the cut masters require grad."""
    with torch.no_grad():
        out = _map_state(state, layout.cut)
    for _, p in tree_flatten(out.params):
        p.requires_grad_(True)
    return out


def gather_train_state(state: TrainState, layout) -> TrainState:
    """The whole state, on every rank, from each rank's cut (collective:
    every rank calls it)."""
    out = _map_state(state, layout.gather)
    return TrainState(
        params=tree_unflatten(out.params, [
            p.detach() for _, p in tree_flatten(out.params)]),
        opt=out.opt, ef=out.ef)


def make_eval_step(model: Model, run: RunConfig):
    """``eval_step(params, batch) → {"eval_loss", "next_token_acc"}``:
    the batch's cross entropy and greedy next-token accuracy through
    ``model.prefill`` (the serving path, ``max_len`` = the inputs'
    length) under ``run.softmax_policy``, with no autograd."""
    @torch.no_grad()
    def eval_step(params, batch) -> dict:
        tokens = batch["tokens"]
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        logits, _ = model.prefill(params, inputs, run,
                                  max_len=inputs.shape[1],
                                  encoder_input=batch.get("encoder_input"))
        return {"eval_loss": cross_entropy(logits, labels),
                "next_token_acc": (logits.argmax(-1) == labels.long())
                .float().mean()}
    return eval_step
