"""Length-sharded lockstep decode over a contiguous KV cache.

The counterpart of the JAX package's ``kernels/lut_attention/
sharded_decode.py``.  When a mesh is active and the GQA KV-head count
does not divide ``tp``, a lockstep decode step splits its cache's length
over the ranks: each rank holds the positions ``[rank·L/tp,
(rank+1)·L/tp)`` of every KV head, computes the paper's REXP semantics
over them, and only ``(B, H, 1)``-shaped partials cross:

    round 1:  m = max over ranks of the local row max
    round 2:  S = Σ over ranks of the local integer Σ,
              U = Σ over ranks of the local Σ e_int · v
    epilogue: out = U · α(S) / qmax²          (fused-requant REXP)

The exact policy runs the same rounds with ``exp`` numerators and
divides U by S.  ``models/layers.apply_attention`` takes this path for a
single-token step against an :class:`~repro_torch.models.layers.AttnCache`
under such a mesh, as the JAX package's does; like the JAX package's it
serves ``exact`` and ``rexp`` only.
"""

from __future__ import annotations

import torch

from repro_torch.core import lut_builder
from repro_torch.core.lut_softmax import _bin_index, inv_scale
from repro_torch.core.policies import SoftmaxPolicy
from repro_torch.runtime import partitioning as PT

Tensor = torch.Tensor


def lut_decode_sharded(q: Tensor, k: Tensor, v: Tensor,
                       policy: SoftmaxPolicy, *, kv_len, mesh: PT.Mesh,
                       scale: float | None = None, start: int | None = None,
                       axes: tuple[str, ...] = ("model",)) -> Tensor:
    """q (B, H, 1, D) — every rank's the same; k, v (B, KVH, L/tp, D) —
    this rank's length shard, its first position ``start`` (default
    ``rank · L/tp``); ``kv_len`` the valid key count (int or 0-d
    tensor).  The partials are reduced over ``axes`` (the mesh axes the
    length is cut over: ``'model'``, and ``'data'`` too for a
    ``shard_kv_seq`` cache).  Returns (B, H, 1, D) f32, the same on
    every rank of those axes."""
    if policy.impl not in ("exact", "rexp"):
        raise ValueError(f"length-sharded decode serves exact and rexp, not "
                         f"{policy.impl!r}")
    b, h, lq, d = q.shape
    kvh, l_shard = k.shape[1], k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    dev = q.device
    if start is None:
        start = mesh.rank * l_shard
    ki = start + torch.arange(l_shard, device=dev)
    valid = ki < torch.as_tensor(kv_len, device=dev)
    qg = q.reshape(b, kvh, g, lq, d).float()
    s = torch.einsum("bngqd,bnkd->bngqk", qg, k.float()) * scale
    s = torch.where(valid, s, torch.full_like(s, float("-inf")))
    m = PT.all_reduce(torch.amax(s, dim=-1), mesh, "max", site="decode_max",
                      axis=axes)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    finite = torch.isfinite(s)
    if policy.impl == "exact":
        p = torch.where(finite, torch.exp(s - m_safe[..., None]),
                        torch.zeros_like(s))
        lsum = PT.all_reduce(torch.sum(p, dim=-1), mesh, "sum",
                             site="decode_sum", axis=axes)
        u = PT.all_reduce(torch.einsum("bngqk,bnkd->bngqd", p, v.float()),
                          mesh, "sum", site="decode_u", axis=axes)
        out = u / torch.clamp(lsum, min=1e-30)[..., None]
        return out.reshape(b, h, lq, d)
    tables = lut_builder.build_rexp_tables(policy.precision,
                                           policy.alpha_len)
    lut_re = torch.as_tensor(tables.lut_recip_exp, dtype=torch.int32,
                             device=dev)
    lut_a = torch.as_tensor(tables.lut_alpha, dtype=torch.int32, device=dev)
    n = lut_re.shape[0]
    dd = torch.where(finite, m_safe[..., None] - s,
                     torch.full_like(s, float(n - 1)))
    bins = _bin_index(dd, policy.index_mode, 0, n - 1)
    e = torch.where(finite, lut_re[bins],
                    torch.zeros((), dtype=torch.int32, device=dev)).float()
    ssum = PT.all_reduce(torch.sum(e, dim=-1), mesh, "sum",
                         site="decode_sum", axis=axes)
    u = PT.all_reduce(torch.einsum("bngqk,bnkd->bngqd", e, v.float()), mesh,
                      "sum", site="decode_u", axis=axes)
    inv = inv_scale(tables.precision.qmax)
    ja = _bin_index(ssum * inv, policy.index_mode, 0, lut_a.shape[0] - 1)
    alpha = lut_a[ja].float()
    return (u * (alpha * inv * inv)[..., None]).reshape(b, h, lq, d)
