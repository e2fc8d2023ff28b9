"""Tensor-parallel paged attention over a ``torch.distributed`` mesh.

The counterpart of the JAX package's ``kernels/lut_attention/
sharded_paged.py``.  The engine's page pools are split over the ranks of
a :class:`~repro_torch.runtime.partitioning.Mesh`, and both serving
phases (decode steps and prompt chunks) attend through
:func:`paged_attention_sharded` in one of two regimes, picked by
``ops.paged_mesh_regime`` from the arch's KV-head count:

* ``'heads'`` (KVH % tp == 0) — each rank holds every page for its
  KVH/tp KV heads.  It attends its contiguous H/tp query heads (query
  heads are KVH-major, so the slice lines up with its KV heads) through
  the single-device paged op — the CUDA paged-decode or paged-prefill
  kernel on CUDA tensors, the plain version on CPU tensors — and one
  all-gather of the ``(B, H, Lq, D)`` output is the only collective.
  The kernel plans its split of the keys for the model's KV heads, not
  the rank's (``plan_kv_heads``), so each head sums in the single-device
  launch's order and a rank with replicated weights gives the
  single-device logits bit for bit.
  Under ``shard_params`` (``gather=False``) the rank keeps its heads and
  the row-split ``wo`` reduces instead.

* ``'pages'`` (KVH does not divide tp) — each rank holds a slab of
  ``n_pages/tp`` physical pages with every KV head, and computes the
  paper's LUT softmax over the keys in its slab only.  Three all-reduces
  carry the row state:

      round 1:  m = max over ranks of the local row max     (B, H, Lq, 1)
      round 2:  S = Σ over ranks of the local integer Σ      (B, H, Lq, 1)
      epilogue: σ_i from (e_i, S) locally, with the faithful per-element
                requant of ``ops._policy_softmax``
      round 3:  out = Σ over ranks of the local σ·V           (B, H, Lq, D)

  For REXP and 2D-LUT the bins, ``e_int``, Σ and ``σ_int`` depend only
  on the global max and the integer-exact Σ, so every σ_i is bitwise
  the single-device one and only the final f32 σ·V contraction
  reassociates across ranks; for ``exact`` the Σ itself reassociates.
  The local compute is plain torch on every device, as the JAX package's
  is plain JAX: no CUDA kernel returns these partials yet.

Keys masked to −inf (past ``kv_lens``, on another rank's pages, in null
pages) give σ = 0 exactly in every policy, so each key counts on the one
rank that owns its page.

Writes: in the ``'pages'`` regime a token's K/V (and an int8 pool's
scales, through the same ids) go to its page's owner only
(:func:`scatter_chunk_sharded`): on every other rank the page id maps to
the sink page past the slab (``partitioning.scatter_page_ids``), where
the JAX package drops the write.  In the ``'heads'`` regime the plain
scatter is already local.
"""

from __future__ import annotations

import torch

from repro_torch.core.lut_softmax import inv_scale
from repro_torch.core.policies import SoftmaxPolicy
from repro_torch.kernels.common import (kernel_tables, lut2d_sigma_int,
                                        policy_e_terms, rexp_sigma)
from repro_torch.kernels.lut_attention import ops
from repro_torch.runtime import partitioning as PT

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Faithful per-element σ from (global max, global Σ)
# ---------------------------------------------------------------------------


def _tables(policy: SoftmaxPolicy, device):
    """``(lut_main, lut_aux)`` of the policy on ``device``: the same
    read-only tensors the kernels' wrappers take."""
    main, aux, _, _ = kernel_tables(policy.impl, ops._tables_for(policy),
                                    policy.index_mode, torch.device(device))
    return main, aux


def e_terms(s: Tensor, m: Tensor, policy: SoftmaxPolicy) -> Tensor:
    """Numerators of the policy softmax given the global row max.

    ``s`` (..., Lk) −inf-masked f32 logits; ``m`` (..., 1) the max over
    every rank.  A reshape over ``common.policy_e_terms`` — the helpers
    the paged kernels' passes reproduce — so it matches ``rexp_exp_int``
    / ``lut2d_exp_int`` / ``softmax_exact`` bit for bit."""
    lut_main, _ = _tables(policy, s.device)
    tables = ops._tables_for(policy)
    step = tables.exp_step if policy.impl == "lut2d" else 1.0
    lk = s.shape[-1]
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = policy_e_terms(s.reshape(-1, lk), m_safe.reshape(-1), lut_main,
                       policy.impl, step, policy.index_mode)
    return e.reshape(s.shape)


def sigma_from_terms(e: Tensor, s_sum: Tensor,
                     policy: SoftmaxPolicy) -> Tensor:
    """Per-element σ from the numerators and the global Σ (..., 1): the
    epilogue of ``softmax_exact`` / ``softmax_rexp`` / ``softmax_lut2d``
    with the row reductions already done."""
    if policy.impl == "exact":
        return e / torch.clamp(s_sum, min=torch.finfo(torch.float32).tiny)
    tables = ops._tables_for(policy)
    qmax = tables.precision.qmax
    _, lut_aux = _tables(policy, e.device)
    lk = e.shape[-1]
    e2, s_row = e.reshape(-1, lk), s_sum.reshape(-1)
    if policy.impl == "rexp":
        sigma_int = rexp_sigma(e2, s_row, lut_aux[0], qmax,
                               policy.index_mode)
    else:
        sigma_int = lut2d_sigma_int(e2, s_row, lut_aux, qmax,
                                    tables.scale_ex, tables.scale_sum,
                                    policy.index_mode).float()
    return sigma_int.reshape(e.shape) * inv_scale(qmax)


# ---------------------------------------------------------------------------
# The 'pages' regime: local partials and three all-reduces
# ---------------------------------------------------------------------------


def slab_views(k_pages: Tensor, v_pages: Tensor, block_tables: Tensor,
               kv_lens: Tensor, mesh: PT.Mesh, k_scales=None, v_scales=None):
    """This rank's block-table view of its slab: ``(valid, k, v)`` with
    ``valid`` (B, Lk) the keys it owns below ``kv_lens`` and ``k``, ``v``
    (B, KVH, Lk, D) f32, zero at every other key."""
    lo, slab = PT.slab_of(mesh, k_pages.shape[0])
    local, lbt = PT.gather_page_ids(block_tables.long(), lo, slab)
    ps = k_pages.shape[1]
    pos = torch.arange(lbt.shape[1] * ps, device=k_pages.device)
    valid = (local.repeat_interleave(ps, dim=1)
             & (pos[None, :] < kv_lens.to(k_pages.device).long()[:, None]))
    k, v = ops.gather_kv(k_pages, v_pages, lbt, kv_lens, k_scales, v_scales)
    keep = valid[:, None, :, None]
    zero = torch.zeros((), device=k.device)
    return (valid, torch.where(keep, k.float(), zero),
            torch.where(keep, v.float(), zero))


def slab_sigma(q: Tensor, k_view: Tensor, valid: Tensor,
               policy: SoftmaxPolicy, mesh: PT.Mesh, *, scale: float,
               q_start: Tensor | None = None) -> Tensor:
    """σ (B, H, Lq, Lk) of this rank's keys after the max and Σ rounds —
    bitwise the single-device σ at those keys for REXP and 2D-LUT."""
    s = ops._logits(q, k_view, scale)                  # (B, H, Lq, Lk)
    mask = valid[:, None, None, :]
    if q_start is not None:
        lq, lk = q.shape[2], k_view.shape[2]
        pos = torch.arange(lk, device=q.device)
        qi = (q_start.to(q.device).long()[:, None]
              + torch.arange(lq, device=q.device)[None, :])
        mask = mask & (pos[None, None, None, :] <= qi[:, None, :, None])
    s = s.masked_fill(~mask, float("-inf"))
    m = PT.all_reduce(torch.amax(s, dim=-1, keepdim=True), mesh, "max",
                      site="pages_max")
    e = e_terms(s, m, policy)
    s_sum = PT.all_reduce(torch.sum(e.float(), dim=-1, keepdim=True), mesh,
                          "sum", site="pages_sum")
    return sigma_from_terms(e, s_sum, policy)


def _pages(q, k_pages, v_pages, block_tables, kv_lens, policy, mesh, *,
           scale, q_start, k_scales, v_scales):
    valid, k_view, v_view = slab_views(k_pages, v_pages, block_tables,
                                       kv_lens, mesh, k_scales, v_scales)
    sigma = slab_sigma(q, k_view, valid, policy, mesh, scale=scale,
                       q_start=q_start)
    return PT.all_reduce(ops._grouped_pv(sigma, v_view), mesh, "sum",
                         site="pages_pv")


# ---------------------------------------------------------------------------
# The dispatcher
# ---------------------------------------------------------------------------


def paged_attention_sharded(
    q: Tensor,              # (B, H, Lq, D); Lq == 1 for decode
    k_pages: Tensor,        # this rank's share of the pool
    v_pages: Tensor,
    block_tables: Tensor,   # (B, mp) int — global page ids
    kv_lens: Tensor,        # (B,) int
    policy: SoftmaxPolicy,
    *,
    mesh: PT.Mesh,
    regime: str,            # 'heads' | 'pages' (ops.paged_mesh_regime)
    q_start: Tensor | None = None,  # (B,) int — prefill chunks only
    scale: float | None = None,
    backend: str = "auto",  # the single-device knob of the 'heads' regime
    k_scales: Tensor | None = None,  # this rank's scales (int8 pool)
    v_scales: Tensor | None = None,
    max_kv_len: int | None = None,
    gather: bool = True,
) -> Tensor:
    """Tensor-parallel paged attention for both serving phases; f32.

    ``q_start=None`` is the decode shape (one query at ``kv_lens − 1``);
    a ``q_start`` selects the causal chunked-prefill semantics.  The
    output holds every head, the same on every rank — except in the
    ``'heads'`` regime with ``gather=False``, where ``q`` and the output
    hold this rank's H/tp heads.  ``backend`` and ``max_kv_len`` steer
    the ``'heads'`` regime's single-device call, which plans its split of
    the keys for the model's ``tp · KVH/tp`` KV heads: each of the rank's
    heads then runs the single-device launch's arithmetic."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    ops.check_scales(k_scales, v_scales)
    if regime == "heads":
        tp = mesh.tp
        if gather:
            if q.shape[1] % tp:
                raise ValueError(f"'heads' regime needs H ({q.shape[1]}) "
                                 f"divisible by tp={tp}")
            hl = q.shape[1] // tp
            q = q[:, mesh.rank * hl:(mesh.rank + 1) * hl]
        kw = dict(scale=scale, backend=backend, k_scales=k_scales,
                  v_scales=v_scales, max_kv_len=max_kv_len,
                  plan_kv_heads=tp * k_pages.shape[2])
        if q_start is None:
            out = ops.lut_attention_paged_decode(
                q.contiguous(), k_pages, v_pages, block_tables, kv_lens,
                policy, **kw)
        else:
            out = ops.lut_attention_paged_prefill(
                q.contiguous(), k_pages, v_pages, block_tables, q_start,
                kv_lens, policy, **kw)
        return PT.all_gather(out, mesh, dim=1, site="attn_out") if gather \
            else out
    if regime != "pages":
        raise ValueError(f"unknown sharded paged regime {regime!r}")
    return _pages(q, k_pages, v_pages, block_tables, kv_lens, policy, mesh,
                  scale=scale, q_start=q_start, k_scales=k_scales,
                  v_scales=v_scales)


def scatter_chunk_sharded(k_pages: Tensor, v_pages: Tensor, phys: Tensor,
                          offs: Tensor, k_tok: Tensor, v_tok: Tensor,
                          k_scales: Tensor | None = None,
                          v_scales: Tensor | None = None,
                          k_sc: Tensor | None = None,
                          v_sc: Tensor | None = None, *,
                          mesh: PT.Mesh) -> None:
    """Write entering tokens into a page-slab pool, in place.

    ``phys`` / ``offs`` (...) global page ids and offsets; ``k_tok``,
    ``v_tok`` (..., KVH, D) in the pool's dtype (int8 codes for an int8
    pool, whose ``k_sc`` / ``v_sc`` (..., KVH) scales go through the
    same ids, so a page and its scales never part).  Only the writes to
    this rank's slab land in it; the rest go to the sink page."""
    lo, slab = PT.slab_of(mesh, k_pages.shape[0])
    lph = PT.scatter_page_ids(phys.long(), lo, slab)
    offs = offs.long()
    k_pages[lph, offs] = k_tok
    v_pages[lph, offs] = v_tok
    if k_scales is not None:
        k_scales[lph, offs] = k_sc
        v_scales[lph, offs] = v_sc
