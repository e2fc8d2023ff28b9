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


def make_train_step(model: Model, run: RunConfig,
                    opt_cfg: AdamWConfig | None = None):
    """``train_step(state, batch) → (state, metrics)``; the state's
    tensors are updated in place.  ``run.microbatch`` = a > 1 splits the
    batch into a equal row blocks and averages their gradients (f32)
    and losses."""
    opt_cfg = opt_cfg or AdamWConfig(learning_rate=run.learning_rate,
                                     weight_decay=run.weight_decay,
                                     grad_clip=run.grad_clip)
    loss_fn = make_loss_fn(model, run)

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState,
                                                            dict]:
        a = run.microbatch
        leaves = [p for _, p in tree_flatten(state.params)]
        for p in leaves:
            p.grad = None
        rows = batch["tokens"].shape[0]
        if rows % a:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{a} microbatches")
        n = rows // a
        loss = None
        for i in range(a):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()
                  if v is not None}
            mb_loss, _ = loss_fn(state.params, mb)
            mb_loss.backward()
            mb_loss = mb_loss.detach()
            loss = mb_loss if loss is None else loss + mb_loss
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in leaves]
        for p in leaves:
            p.grad = None
        if a > 1:
            torch._foreach_div_(grads, float(a))
            loss = loss / a
        grads = tree_unflatten(state.params, grads)

        metrics = {"loss": loss}
        ef = state.ef
        if run.grad_compression:
            grads, ef, cstats = compress_grads(grads, state.ef)
            metrics.update(cstats)
        params, opt, ostats = adamw_update(opt_cfg, state.params, grads,
                                           state.opt)
        metrics.update(ostats)
        return TrainState(params=params, opt=opt, ef=ef), metrics

    return train_step


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
