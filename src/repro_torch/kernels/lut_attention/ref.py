"""Naive-attention oracle with the LUT softmax in the middle.

The counterpart of the JAX package's ``kernels/lut_attention/ref.py``:

    logits = (q @ kᵀ) · scale  (+ causal mask, queries right-aligned)
    σ      = softmax_<method>(logits)        # core.lut_softmax semantics
    out    = σ @ v

and the plain version of the dense CUDA kernel (``csrc/lut_attention.cu``)
in each of its modes: REXP's fused α form, REXP's and 2D-LUT's faithful
per-element σ, with or without a ``kv_len`` (the valid length of a
pre-allocated cache, the JAX package's ``ops._naive_with_bias`` form).
It is the ``naive`` backend of :func:`ops.lut_attention`.
"""

from __future__ import annotations

import torch

from repro_torch.core import lut_softmax as _core
from repro_torch.core.lut_builder import Lut2DTables, RexpTables

Tensor = torch.Tensor


def _logits(q: Tensor, k: Tensor, scale: float, causal: bool,
            kv_len: Tensor | int | None = None) -> Tensor:
    """(B, H, Lq, D) × (B, KVH, Lk, D) → (B, H, Lq, Lk) f32, GQA head map.

    Keys at or past ``kv_len`` (default: Lk, none) are masked to −inf;
    causal queries sit at the last Lq of the ``kv_len`` valid positions.
    """
    g = q.shape[1] // k.shape[1]
    kx = k.float().repeat_interleave(g, dim=1)
    s = torch.matmul(q.float(), kx.transpose(-1, -2)) * scale
    lq, lk = q.shape[2], k.shape[2]
    ki = torch.arange(lk, device=q.device)[None, :]
    valid = lk
    if kv_len is not None:
        valid = torch.as_tensor(kv_len, device=q.device)
        s = s.masked_fill(~(ki < valid), float("-inf"))
    if causal:
        qi = torch.arange(lq, device=q.device)[:, None] + (valid - lq)
        s = s.masked_fill(~(ki <= qi), float("-inf"))
    return s


def lut_attention_ref(q: Tensor, k: Tensor, v: Tensor, *, method: str,
                      tables: RexpTables | Lut2DTables | None = None,
                      scale: float | None = None, causal: bool = False,
                      index_mode: str = "round",
                      fused_requant: bool = False,
                      kv_len: Tensor | int | None = None) -> Tensor:
    """Naive-attention oracle; (B, H, Lq, D) f32.  ``fused_requant``
    applies REXP's α to the Σe·v accumulator instead of re-quantizing
    σ per element (the fused variant of the dense kernel); ``kv_len``
    masks a cache's tail and right-aligns causal queries to it."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = _logits(q, k, scale, causal, kv_len)
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
