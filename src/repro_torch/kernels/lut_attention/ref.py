"""Naive-attention oracle with the LUT softmax in the middle.

The counterpart of the JAX package's ``kernels/lut_attention/ref.py``:

    logits = (q @ kᵀ) · scale  (+ causal mask, queries right-aligned)
    σ      = softmax_<method>(logits)        # core.lut_softmax semantics
    out    = σ @ v

It is the ``naive`` backend of :func:`ops.lut_attention` when no
``kv_len`` is given (a full-sequence forward with no cache).
"""

from __future__ import annotations

import torch

from repro_torch.core import lut_softmax as _core
from repro_torch.core.lut_builder import Lut2DTables, RexpTables

Tensor = torch.Tensor


def _logits(q: Tensor, k: Tensor, scale: float, causal: bool) -> Tensor:
    """(B, H, Lq, D) × (B, KVH, Lk, D) → (B, H, Lq, Lk) f32, GQA head map;
    causal queries sit at the last Lq of the Lk positions."""
    g = q.shape[1] // k.shape[1]
    kx = k.float().repeat_interleave(g, dim=1)
    s = torch.matmul(q.float(), kx.transpose(-1, -2)) * scale
    if causal:
        lq, lk = q.shape[2], k.shape[2]
        qi = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        ki = torch.arange(lk, device=q.device)[None, :]
        s = s.masked_fill(~(ki <= qi), float("-inf"))
    return s


def lut_attention_ref(q: Tensor, k: Tensor, v: Tensor, *, method: str,
                      tables: RexpTables | Lut2DTables | None = None,
                      scale: float | None = None, causal: bool = False,
                      index_mode: str = "round",
                      fused_requant: bool = False) -> Tensor:
    """Naive-attention oracle; (B, H, Lq, D) f32.  ``fused_requant``
    applies REXP's α to the Σe·v accumulator instead of re-quantizing
    σ per element (the 2-pass fused variant of the dense kernel)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = _logits(q, k, scale, causal)
    vx = v.float().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    if method == "exact":
        return torch.matmul(_core.softmax_exact(s, axis=-1), vx)
    if method == "rexp":
        assert isinstance(tables, RexpTables)
        if not fused_requant:
            return torch.matmul(_core.softmax_rexp(
                s, tables, axis=-1, index_mode=index_mode), vx)
        inv = _core.inv_scale(tables.precision.qmax)
        e_int = _core.rexp_exp_int(s, tables, axis=-1, index_mode=index_mode)
        ssum = torch.sum(e_int.float(), dim=-1, keepdim=True)
        ja = _core.rexp_alpha_index(ssum, tables, index_mode)
        alpha = torch.as_tensor(tables.lut_alpha, dtype=torch.int32,
                                device=q.device)[ja]
        u = torch.matmul(e_int.float(), vx)
        return u * (alpha.float() * inv * inv)
    if method == "lut2d":
        assert isinstance(tables, Lut2DTables)
        return torch.matmul(_core.softmax_lut2d(
            s, tables, axis=-1, index_mode=index_mode), vx)
    raise ValueError(f"unknown method {method!r}")
