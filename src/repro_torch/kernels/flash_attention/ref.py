"""Naive oracle for the exact flash-attention kernel.

The counterpart of the JAX package's ``kernels/flash_attention/ref.py``:
materialized f32 logits with the GQA head map (query head h reads KV head
h // (H / KVH)) and right-aligned causal masking (key j is visible to
query row i iff j ≤ i + (Lk − Lq)).  A ``kv_len`` (the valid length of
a pre-allocated cache: an int, or a tensor of one or of B lengths) masks
keys j ≥ kv_len and right-aligns the causal queries to it instead, as
the JAX package's ``naive`` backend does.
:func:`flash_attention_stats` also returns the kernel's log-sum-exp
pieces: the row max m over the visible logits (−inf for a row that sees
no key) and l = Σ exp(s − m).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def flash_attention_stats(q: Tensor, k: Tensor, v: Tensor, *,
                          causal: bool = False,
                          scale: float | None = None,
                          kv_len: Tensor | int | None = None):
    """(out (B, H, Lq, D), m (B, H, Lq), l (B, H, Lq)), all f32; a row
    with no visible key gives out 0, m = −inf, l = 0."""
    b, h, lq, d = q.shape
    kvh, lk = k.shape[1], k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    qg = q.float().reshape(b, kvh, g, lq, d)
    s = torch.matmul(qg, k.float().unsqueeze(2).transpose(-1, -2)) * scale
    ki = torch.arange(lk, device=q.device)
    valid = lk
    if kv_len is not None:
        valid = torch.as_tensor(kv_len, device=q.device).clamp(min=0)
        if valid.dim():                     # one length per sequence
            valid = valid.reshape(b, 1, 1, 1, 1)
        s = s.masked_fill(~(ki < valid), float("-inf"))
    if causal:
        qi = torch.arange(lq, device=q.device)[:, None] + (valid - lq)
        s = s.masked_fill(~(ki <= qi), float("-inf"))
    m = torch.amax(s, dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]),
                    torch.zeros_like(s))
    l = torch.sum(p, dim=-1)
    out = (torch.matmul(p, v.float().unsqueeze(2))
           / torch.clamp(l, min=1e-30)[..., None])
    return (out.reshape(b, h, lq, d), m.reshape(b, h, lq),
            l.reshape(b, h, lq))


def flash_attention_ref(q: Tensor, k: Tensor, v: Tensor, *,
                        causal: bool = False,
                        scale: float | None = None,
                        kv_len: Tensor | int | None = None) -> Tensor:
    """Naive exact attention, (B, H, Lq, D) f32."""
    return flash_attention_stats(q, k, v, causal=causal, scale=scale,
                                 kv_len=kv_len)[0]
