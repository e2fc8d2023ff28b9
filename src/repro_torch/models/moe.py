"""Mixture-of-Experts FFN: top-k routing with per-group expert capacity.

The counterpart of the JAX package's ``models/moe.py``.  It serves and
trains the MoE decoders of ``configs``: DeepSeek-MoE-16B (64 routed experts of
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

With ``return_aux`` :func:`apply_moe` also returns the training terms
of the JAX package: the Switch load-balance loss ``E · Σ_e f_e · P_e``
and the router entropy.  Under autograd the gradient reaches the router
through the gate weights and those terms only, as through the JAX
package's combine tensor: the expert choices, slots and drops are
integers, and the dispatch copies rows.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.lut_softmax import make_softmax_fn
from repro_torch.core.policies import EXACT, SoftmaxPolicy
from repro_torch.models.layers import apply_mlp, dense_init, init_mlp
from repro_torch.runtime import partitioning as PT

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


def assign_slots(experts: Tensor, n_experts: int, group: int, cap: int,
                 mesh=None) -> tuple[Tensor, Tensor]:
    """Each (token, k) assignment's slot in its expert's buffer of its
    group of ``group`` tokens — its rank among the group's earlier
    assignments to that expert in flat ``(token, k)`` order — and whether
    it is kept (slot < ``cap``); both (T, K).  The tail group's padding
    rows come after every real token in flat order, so they take no slot
    from one.

    With a ``mesh`` — ``(mesh, axes)``, the axes the batch's rows are
    cut over — the tokens are a rank's share of the batch: the groups
    are those of the global token axis, in which this rank's ``T``
    tokens start at ``i · T``, ``i`` its row-major index over the axes
    (the rank-major order of the JAX package's flattened batch), and a
    slot counts the assignments that earlier ranks gave the same
    (group, expert) too, from one all-gather of the ``(groups, E)``
    counts."""
    t, top_k = experts.shape
    mesh, axes = mesh if mesh is not None else (None, ())
    first, dp = ((mesh.index(axes) * t, mesh.size(axes)) if mesh is not None
                 else (0, 1))
    n_groups = -(-(t * dp) // group)         # the same on every data rank
    flat = experts.reshape(-1)
    gid = ((first + torch.arange(t, device=experts.device)) // group
           ).repeat_interleave(top_k)
    onehot = F.one_hot(flat, n_experts)                      # (TK, E)
    before = (torch.cumsum(onehot, 0) - onehot).gather(
        1, flat[:, None])[:, 0]
    counts = torch.zeros(n_groups * n_experts, dtype=torch.int64,
                         device=experts.device)
    counts.index_add_(0, gid * n_experts + flat, torch.ones_like(flat))
    counts = counts.view(n_groups, n_experts)
    # this rank's assignments in its earlier groups are not the group's
    slots = before - (torch.cumsum(counts, 0) - counts)[gid, flat]
    if mesh is not None:
        every = PT.all_gather(counts[None], mesh, 0, site="moe.slots",
                              axis=axes)
        slots = slots + every[:mesh.index(axes)].sum(0)[gid, flat]
    slots = slots.view(t, top_k)
    return slots, slots < cap


def router_probs(p: Params, xt: Tensor,
                 router_policy: SoftmaxPolicy) -> Tensor:
    """(T, E) f32 router probabilities of the (T, D) tokens: the policy's
    softmax over f32 logits."""
    logits = xt.float() @ p["router"].float()
    return make_softmax_fn(router_policy)(logits, axis=-1)


def aux_losses(probs: Tensor, experts: Tensor, n_experts: int,
               group: int, mesh=None) -> dict[str, Tensor]:
    """The JAX package's training terms: ``load_balance_loss`` =
    E · Σ_e f_e · P_e, f_e the share of top-k assignments to expert e and
    P_e its mean router probability, and ``router_entropy``.  As there,
    f_e counts the tail group's padding rows, which the JAX package pads
    with expert 0 for all k.

    With a ``mesh`` — ``(mesh, axes)`` as for :func:`assign_slots` — the
    tokens are a rank's share of the batch: f_e counts every rank's
    assignments (a sum over the axes), and P_e is this rank's mean, so
    the ranks' mean of the loss — what their summed and averaged
    gradients differentiate — is the whole batch's loss."""
    t, top_k = experts.shape
    counts = F.one_hot(experts, n_experts).sum(dim=(0, 1)).float()
    t_all = t
    if mesh is not None:
        mesh, axes = mesh
        counts = PT.all_reduce(counts, mesh, "sum", site="moe.aux",
                               axis=axes)
        t_all = t * mesh.size(axes)
    t_pad = -(-t_all // group) * group
    counts[0] += (t_pad - t_all) * top_k
    ce = counts / t_pad
    me = probs.mean(0)
    return {"load_balance_loss": n_experts * torch.sum(me * ce),
            "router_entropy": -torch.mean(
                torch.sum(probs * torch.log(probs + 1e-9), dim=-1))}


def route(p: Params, xt: Tensor, *, n_experts: int, top_k: int,
          capacity_factor: float, router_policy: SoftmaxPolicy,
          group_size: int):
    """Routing of the (T, D) tokens ``xt``: returns ``(gates, experts,
    slots, kept, cap, g)`` — each (T, K): the renormalised f32 gate
    weights, the expert indices, each assignment's slot in its expert's
    buffer of its group, and whether it fits the capacity ``cap`` —
    and the group size ``g``.  Under a scope whose batch rows are cut
    over the batch axes the groups are those of the global token axis
    (:func:`assign_slots`)."""
    probs = router_probs(p, xt, router_policy)
    gates, experts = top_k_experts(probs, top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    mesh = _data_mesh()
    t_all = xt.shape[0] * (mesh[0].size(mesh[1]) if mesh is not None else 1)
    g = min(group_size, t_all)
    cap = capacity(g, n_experts, top_k, capacity_factor)
    slots, kept = assign_slots(experts, n_experts, g, cap, mesh)
    return gates, experts, slots, kept, cap, g


def _data_mesh():
    """``(mesh, axes)`` when the active scope cuts the batch's rows over
    ``axes`` (the batch axes of more than one rank), else None."""
    scope = PT.active_scope()
    if scope.tokens and scope.mesh is not None:
        return scope.mesh, scope.tokens
    return None


def _experts_ffn(p: Params, xt: Tensor, gates: Tensor, experts: Tensor,
                 slots: Tensor, kept: Tensor, cap: int, g: int,
                 n_experts: int, split) -> Tensor:
    """The routed experts' gated sum, (T, D) f32, over the experts this
    rank holds: all of them (``split`` None), ``("experts", lo, hi)`` —
    the others' assignments weigh 0 — or ``("columns", lo, hi)`` — a
    slice of every expert's hidden units, a partial sum."""
    t, d = xt.shape
    top_k = experts.shape[1]
    data = _data_mesh()
    first = data[0].index(data[1]) * t if data is not None else 0
    gid = (first + torch.arange(t, device=xt.device)) // g
    group = (gid - gid[0])[:, None]                              # (T, 1)
    n_groups = int(-(-(first + t) // g) - first // g)
    n_local = n_experts
    if split is not None and split[0] == "experts":
        lo, hi = split[1:]
        n_local = hi - lo
        mine = (experts >= lo) & (experts < hi)
        kept = kept & mine
        experts = torch.where(mine, experts - lo, torch.zeros_like(experts))
    # buffer row of each assignment: (expert, group, slot) with a slot
    # past the capacity for the dropped ones (a spare row, never read)
    row = (experts * n_groups + group) * (cap + 1) + torch.where(
        kept, slots, torch.full_like(slots, cap))
    buf = xt.new_zeros((n_local * n_groups * (cap + 1), d))
    buf.index_copy_(0, row.reshape(-1), xt.repeat_interleave(top_k, dim=0))
    expert_in = buf.view(n_local, n_groups, cap + 1, d)[:, :, :cap]
    expert_in = expert_in.reshape(n_local, n_groups * cap, d)
    gate = torch.bmm(expert_in, p["w_gate"].to(xt.dtype))
    up = torch.bmm(expert_in, p["w_up"].to(xt.dtype))
    h = F.silu(gate.float()).to(xt.dtype) * up
    expert_out = torch.bmm(h, p["w_down"].to(xt.dtype))     # (E, G·C, D)
    # each assignment's output row; a dropped one weighs 0
    out_row = (experts * n_groups + group) * cap + torch.clamp(
        slots, 0, cap - 1)
    y = expert_out.reshape(-1, d)[out_row.reshape(-1)].reshape(t, top_k, d)
    w = torch.where(kept, gates, torch.zeros_like(gates)).to(xt.dtype)
    return (w.float()[..., None] * y.float()).sum(1)


def apply_moe(p: Params, x: Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25,
              router_policy: SoftmaxPolicy = EXACT,
              group_size: int = 4096, return_aux: bool = False,
              d_expert: int | None = None, n_shared: int = 0,
              path: str = ""):
    """x (B, S, D) → (B, S, D) in ``x.dtype``: the routed experts' gated
    sum plus the shared MLP (module docstring); with ``return_aux``,
    ``(out, aux)`` with :func:`aux_losses`' terms.

    Under a scope whose weights are cut (``partitioning.shard_params``)
    the experts follow their 3-D rows (``partitioning.expert_split``,
    from the mesh, ``d_expert`` and the rule) and the shared MLP of
    ``n_shared`` experts its 2-D rows where the scope computes on their
    cut (``Scope.model_mesh`` of ``{path}/shared/w_up``, ``path`` the
    FFN's place in the parameter tree); the cut parts' f32 partial sums
    meet in one all-reduce over ``'model'`` (site ``moe``) before the
    cast to ``x.dtype``.  Routing is computed whole on every rank; the
    gate weights and the tokens enter the cut experts through
    ``copy_to``, so the backward sums their partial gradients over the
    ranks and counts the load-balance term once."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    gates, experts, slots, kept, cap, g = route(
        p, xt, n_experts=n_experts, top_k=top_k,
        capacity_factor=capacity_factor, router_policy=router_policy,
        group_size=group_size)
    scope = PT.active_scope()
    mesh = scope.mesh if scope.cut and PT.mesh_model_tp(scope.mesh) > 1 \
        else None
    if mesh is None:
        out = _experts_ffn(p, xt, gates, experts, slots, kept, cap, g,
                           n_experts, None).to(x.dtype)
        if "shared" in p:
            out = out + apply_mlp(p["shared"], xt)
    else:
        if d_expert is None:
            raise ValueError("apply_moe on cut weights needs d_expert")
        split = PT.expert_split(mesh, n_experts, d, d_expert)
        shared_cut = ("shared" in p and scope.model_mesh(
            f"{path}/shared/w_up") is not None)
        xin = PT.copy_to(xt, mesh, site="moe.in") \
            if split is not None or shared_cut else xt
        partial, whole = [], []
        routed = _experts_ffn(
            p, xin if split is not None else xt,
            PT.copy_to(gates, mesh, site="moe.gates")
            if split is not None else gates,
            experts, slots, kept, cap, g, n_experts, split)
        (partial if split is not None else whole).append(routed)
        if "shared" in p:
            shared = apply_mlp(p["shared"], xin if shared_cut else xt)
            (partial if shared_cut else whole).append(shared.float())
        out = PT.reduce_from(sum(partial), mesh, site="moe") if partial \
            else 0
        for part in whole:
            out = out + part
        out = out.to(x.dtype)
    out = out.reshape(b, s, d)
    if not return_aux:
        return out
    return out, aux_losses(router_probs(p, xt, router_policy), experts,
                           n_experts, g, _data_mesh())
