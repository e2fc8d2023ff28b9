"""Mixture-of-Experts FFN: top-k routing with per-group expert capacity.

The counterpart of the JAX package's ``models/moe.py`` for serving (the
load-balance loss, a training term, is not computed).  It serves the
MoE decoders of ``configs``: DeepSeek-MoE-16B (64 routed experts of
width 1408, top-6, plus 2 shared experts) and Granite-MoE-3B (40
experts of width 512, top-8).

Routing is a softmax over the experts of f32 router logits, through
``router_policy`` — exact by default, or the paper's LUT softmax.  The
semantics are the JAX package's GShard-style dispatch, exactly:

* the top ``top_k`` probabilities of a token, renormalised by
  ``max(Σ, 1e-9)``; among equal probabilities the lower expert index
  ranks first (``jax.lax.top_k``'s order: a LUT router quantises its
  probabilities, so ties are common);
* tokens in groups of ``group_size``, the tail group padded with rows
  that never route;
* a group's capacity ``max(int(cf · k · g / E), min(g, 256))`` slots an
  expert; an assignment's slot is its rank among the group's earlier
  assignments to the same expert in flat ``(token, k)`` order, and
  assignments at or past capacity are dropped (their token keeps only
  its other experts and the shared MLP);
* dispatch exact in ``x.dtype``, ``silu(gate)`` in f32 cast back, gate
  weights cast to ``x.dtype`` before they multiply the expert outputs.

Where the JAX package contracts one-hot ``(G, g, E, C)`` tensors, this
module computes the slots by a cumulative sum over the one-hot
``(T·K, E)`` assignments, scatters the kept rows into an ``(E, G·C, D)``
buffer, runs the three expert products as batched matmuls over the
stacked expert weights (plain matmuls, as the JAX package leaves them to
XLA), and gathers each assignment's row back.  Every shape follows from
``(T, E, K, C)``: no host sync, no data-dependent shape, so a dispatch
of the pipelined engine never waits on the device.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.lut_softmax import make_softmax_fn
from repro_torch.core.policies import EXACT, SoftmaxPolicy
from repro_torch.models.layers import apply_mlp, dense_init, init_mlp

Tensor = torch.Tensor
Params = dict[str, Any]


def init_moe(d_model: int, d_expert: int, n_experts: int, n_shared: int,
             generator: torch.Generator, device) -> Params:
    """Random f32 leaves in the JAX package's layout: ``router`` (D, E),
    ``w_gate`` / ``w_up`` (E, D, F), ``w_down`` (E, F, D) and, with
    ``n_shared`` experts, a ``shared`` gated MLP of width
    ``d_expert · n_shared``."""
    p = {
        "router": dense_init((d_model, n_experts), generator, device),
        "w_gate": dense_init((n_experts, d_model, d_expert), generator,
                             device, in_axis_size=d_model),
        "w_up": dense_init((n_experts, d_model, d_expert), generator,
                           device, in_axis_size=d_model),
        "w_down": dense_init((n_experts, d_expert, d_model), generator,
                             device, in_axis_size=d_expert),
    }
    if n_shared > 0:
        p["shared"] = init_mlp(d_model, d_expert * n_shared, generator,
                               device)
    return p


def top_k_experts(probs: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """The ``k`` largest probabilities of each row and their expert
    indices, the lower index first among equal values (a stable
    descending sort: ``torch.topk`` leaves the order of ties open)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(group: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Slots an expert has in a group of ``group`` tokens: the GShard
    formula, never below full coverage of groups up to 256 tokens (so
    decode steps and short prefills drop nothing)."""
    return max(int(capacity_factor * top_k * group / n_experts),
               min(group, 256))


def assign_slots(experts: Tensor, n_experts: int, group: int,
                 cap: int) -> tuple[Tensor, Tensor]:
    """Each (token, k) assignment's slot in its expert's buffer of its
    group of ``group`` tokens — its rank among the group's earlier
    assignments to that expert in flat ``(token, k)`` order — and whether
    it is kept (slot < ``cap``); both (T, K).  The tail group's padding
    rows come after every real token in flat order, so they take no slot
    from one: the real rows' slots are those of the padded group."""
    t, top_k = experts.shape
    n_groups = -(-t // group)
    grouped = F.pad(experts, (0, 0, 0, n_groups * group - t)).reshape(
        n_groups, group * top_k)
    onehot = F.one_hot(grouped, n_experts)                   # (G, gK, E)
    before = torch.cumsum(onehot, dim=1) - onehot
    slots = torch.gather(before, 2, grouped[..., None])[..., 0]
    slots = slots.reshape(n_groups * group, top_k)[:t]
    return slots, slots < cap


def route(p: Params, xt: Tensor, *, n_experts: int, top_k: int,
          capacity_factor: float, router_policy: SoftmaxPolicy,
          group_size: int):
    """Routing of the (T, D) tokens ``xt``: returns ``(gates, experts,
    slots, kept, cap, g)`` — each (T, K): the renormalised f32 gate
    weights, the expert indices, each assignment's slot in its expert's
    buffer of its group, and whether it fits the capacity ``cap`` —
    and the group size ``g``."""
    logits = xt.float() @ p["router"].float()               # (T, E)
    probs = make_softmax_fn(router_policy)(logits, axis=-1)
    gates, experts = top_k_experts(probs, top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    g = min(group_size, xt.shape[0])
    cap = capacity(g, n_experts, top_k, capacity_factor)
    slots, kept = assign_slots(experts, n_experts, g, cap)
    return gates, experts, slots, kept, cap, g


def apply_moe(p: Params, x: Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25,
              router_policy: SoftmaxPolicy = EXACT,
              group_size: int = 4096) -> Tensor:
    """x (B, S, D) → (B, S, D) in ``x.dtype``: the routed experts' gated
    sum plus the shared MLP (module docstring)."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    gates, experts, slots, kept, cap, g = route(
        p, xt, n_experts=n_experts, top_k=top_k,
        capacity_factor=capacity_factor, router_policy=router_policy,
        group_size=group_size)
    n_groups = -(-t // g)
    group = (torch.arange(t, device=x.device) // g)[:, None]   # (T, 1)
    # buffer row of each assignment: (expert, group, slot) with a slot
    # past the capacity for the dropped ones (a spare row, never read)
    row = (experts * n_groups + group) * (cap + 1) + torch.where(
        kept, slots, torch.full_like(slots, cap))
    buf = x.new_zeros((n_experts * n_groups * (cap + 1), d))
    buf.index_copy_(0, row.reshape(-1), xt.repeat_interleave(top_k, dim=0))
    expert_in = buf.view(n_experts, n_groups, cap + 1, d)[:, :, :cap]
    expert_in = expert_in.reshape(n_experts, n_groups * cap, d)
    gate = torch.bmm(expert_in, p["w_gate"].to(x.dtype))
    up = torch.bmm(expert_in, p["w_up"].to(x.dtype))
    h = F.silu(gate.float()).to(x.dtype) * up
    expert_out = torch.bmm(h, p["w_down"].to(x.dtype))       # (E, G·C, D)
    # each assignment's output row; a dropped one weighs 0
    out_row = (experts * n_groups + group) * cap + torch.clamp(slots,
                                                               max=cap - 1)
    y = expert_out.reshape(-1, d)[out_row.reshape(-1)].reshape(t, top_k, d)
    w = torch.where(kept, gates, torch.zeros_like(gates)).to(x.dtype)
    out = (w.float()[..., None] * y.float()).sum(1).to(x.dtype)
    if "shared" in p:
        out = out + apply_mlp(p["shared"], xt)
    return out.reshape(b, s, d)
