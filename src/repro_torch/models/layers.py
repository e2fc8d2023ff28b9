"""Core transformer layers over plain dicts of tensors.

The counterpart of the JAX package's ``models/layers.py`` for the paged
serving path: norms, RoPE, the q/k/v projections (with qk-norm and
optional biases), the paged attention caches with their scatter-then-
attend steps, the MLP, the embedding and the LM head.

Conventions (those of the JAX package, so weights convert one to one):
  * params are dicts of tensors; weights are ``(in, out)`` and a
    projection is ``x @ w``;
  * each matmul casts its weight to the activation dtype, as the JAX
    package does, so f32 masters and weights stored in the run dtype
    give the same operands;
  * attention logical shapes: q (B, H, L, Dh); pools
    (n_pages, page_size, KVH, Dh).

Unlike the JAX package's functional updates, the paged steps write the
new K/V into the pool tensors **in place** (``index_put_``): the pool is
the largest serving buffer, and a copy per step would double it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.policies import SoftmaxPolicy
from repro_torch.kernels.lut_attention.ops import (lut_attention_paged_decode,
                                                   lut_attention_paged_prefill)

Tensor = torch.Tensor
Params = dict[str, Any]


# ---------------------------------------------------------------------------
# Initializers / numerics helpers
# ---------------------------------------------------------------------------


def dense_init(shape, generator: torch.Generator, device,
               in_axis_size: int | None = None) -> Tensor:
    """Truncated-normal fan-in init (LeCun-style), f32, in ±2σ."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(1.0 / math.sqrt(max(fan_in, 1)))


def rms_norm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def init_norm(d: int, device) -> Params:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def apply_norm(p: Params, x: Tensor, eps: float) -> Tensor:
    return rms_norm(x, p["scale"], eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device) -> Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x (..., L, Dh); positions (..., L) int → rotated x (same dtype)."""
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs        # (..., L, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (the paper's integration point)
# ---------------------------------------------------------------------------


def init_attention(d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, generator: torch.Generator, device,
                   qk_norm: bool = False, with_bias: bool = False) -> Params:
    p = {
        "wq": dense_init((d_model, n_heads * head_dim), generator, device),
        "wk": dense_init((d_model, n_kv_heads * head_dim), generator, device),
        "wv": dense_init((d_model, n_kv_heads * head_dim), generator, device),
        "wo": dense_init((n_heads * head_dim, d_model), generator, device,
                         in_axis_size=n_heads * head_dim),
    }
    if qk_norm:
        p["q_norm"] = init_norm(head_dim, device)
        p["k_norm"] = init_norm(head_dim, device)
    if with_bias:
        for name, n in (("bq", n_heads * head_dim),
                        ("bk", n_kv_heads * head_dim),
                        ("bv", n_kv_heads * head_dim), ("bo", d_model)):
            p[name] = torch.zeros((n,), dtype=torch.float32, device=device)
    return p


@dataclasses.dataclass
class PagedAttnCache:
    """Paged KV storage for continuous-batching decode.

    One pool of fixed-size pages is shared by every slot of the decode
    batch; a per-slot block table maps logical page index → physical page
    id, and ``lengths`` carries each slot's own write cursor.  Physical
    page 0 is the reserved **null page**: inactive slots map every
    logical page to it, so their garbage writes never touch live pages.
    """

    k_pages: Tensor       # (n_pages, page_size, KVH, Dh)
    v_pages: Tensor
    block_tables: Tensor  # (B, max_pages_per_seq) int32 physical page ids
    lengths: Tensor       # (B,) int32 — tokens already cached per slot

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[1]


@dataclasses.dataclass
class PagedPrefillCache:
    """Chunked-prefill view of the paged pool.

    Same storage contract as :class:`PagedAttnCache`; the entering unit
    is a fixed-size chunk of prompt tokens: ``lengths`` is the per-slot
    count of tokens already cached (the chunk's first absolute position)
    and ``chunk_lens`` how many chunk rows are real prompt tokens — the
    padding past it writes to the null page and its rows are discarded.
    """

    k_pages: Tensor       # (n_pages, page_size, KVH, Dh)
    v_pages: Tensor
    block_tables: Tensor  # (B, max_pages_per_seq) int32
    lengths: Tensor       # (B,) int32 — tokens cached before this chunk
    chunk_lens: Tensor    # (B,) int32 — valid tokens entering this chunk

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[1]


def _project_qkv(p: Params, x: Tensor, n_heads: int, n_kv_heads: int,
                 head_dim: int, qk_norm: bool, norm_eps: float,
                 rope_theta: float | None, positions: Tensor):
    b, l, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(b, l, n_heads, head_dim).transpose(1, 2)
    k = k.reshape(b, l, n_kv_heads, head_dim).transpose(1, 2)
    v = v.reshape(b, l, n_kv_heads, head_dim).transpose(1, 2)
    if qk_norm:
        q = rms_norm(q, p["q_norm"]["scale"], norm_eps)
        k = rms_norm(k, p["k_norm"]["scale"], norm_eps)
    if rope_theta is not None:
        q = apply_rope(q, positions[:, None, :], rope_theta)
        k = apply_rope(k, positions[:, None, :], rope_theta)
    return q, k, v


def _paged_prefill_chunk(p: Params, x: Tensor, cache: PagedPrefillCache, *,
                         n_heads: int, n_kv_heads: int, head_dim: int,
                         qk_norm: bool, norm_eps: float,
                         rope_theta: float | None, policy: SoftmaxPolicy,
                         paged_backend: str) -> Tensor:
    """One prompt chunk against the paged pool — scatter, then attend.

    The chunk's K/V go into the pool pages at positions
    ``[lengths, lengths + chunk_lens)`` through the block table (in
    place), then its queries attend to every prior key through the same
    block tables via :func:`lut_attention_paged_prefill`.  Padding rows
    write to the null page.  With prefix caching the engine guarantees
    every page this chunk writes is privately owned by the sequence.
    """
    b, c, _ = x.shape
    positions = cache.lengths[:, None] + torch.arange(
        c, dtype=cache.lengths.dtype, device=x.device)
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, qk_norm,
                           norm_eps, rope_theta, positions)
    ps = cache.page_size
    mp = cache.block_tables.shape[1]
    pos = positions.long()
    valid = (torch.arange(c, device=x.device)[None, :]
             < cache.chunk_lens[:, None]) & (pos // ps < mp)
    page_idx = torch.clamp(pos // ps, 0, mp - 1)
    phys = torch.gather(cache.block_tables.long(), 1, page_idx)
    # padding rows (and anything past the block table) land on the null
    # page, which is garbage by definition — the write needs no branch
    phys = torch.where(valid, phys, torch.zeros_like(phys))
    offs = pos % ps
    cache.k_pages[phys, offs] = k.transpose(1, 2).to(cache.k_pages.dtype)
    cache.v_pages[phys, offs] = v.transpose(1, 2).to(cache.v_pages.dtype)
    return lut_attention_paged_prefill(
        q, cache.k_pages, cache.v_pages, cache.block_tables,
        q_start=cache.lengths, kv_lens=cache.lengths + cache.chunk_lens,
        policy=policy, backend=paged_backend)


def _paged_decode(p: Params, x: Tensor, cache: PagedAttnCache, *,
                  n_heads: int, n_kv_heads: int, head_dim: int,
                  qk_norm: bool, norm_eps: float, rope_theta: float | None,
                  policy: SoftmaxPolicy, paged_backend: str) -> Tensor:
    """Single-token decode against the paged pool — no contiguous gather.

    Writes the token's K/V at ``lengths`` (per slot, in place), then
    attends straight off the pool through the per-slot block tables via
    :func:`lut_attention_paged_decode`.  Inactive slots all target the
    null page; their duplicate writes there are harmless.
    """
    positions = cache.lengths[:, None]                  # (B, 1)
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, qk_norm,
                           norm_eps, rope_theta, positions)
    ps = cache.page_size
    lengths = cache.lengths.long()
    phys = torch.gather(cache.block_tables.long(), 1,
                        (lengths // ps)[:, None])[:, 0]  # (B,)
    offs = lengths % ps
    cache.k_pages[phys, offs] = k[:, :, 0].to(cache.k_pages.dtype)
    cache.v_pages[phys, offs] = v[:, :, 0].to(cache.v_pages.dtype)
    return lut_attention_paged_decode(q, cache.k_pages, cache.v_pages,
                                      cache.block_tables,
                                      kv_lens=cache.lengths + 1,
                                      policy=policy, backend=paged_backend)


def apply_paged_attention(p: Params, x: Tensor,
                          cache: PagedAttnCache | PagedPrefillCache, *,
                          n_heads: int, n_kv_heads: int, head_dim: int,
                          qk_norm: bool = False, norm_eps: float = 1e-5,
                          rope_theta: float | None = 10000.0,
                          policy: SoftmaxPolicy,
                          paged_backend: str = "auto") -> Tensor:
    """Self-attention of ``x`` (B, L, D) against a paged cache: a prompt
    chunk (:class:`PagedPrefillCache`) or one decode token
    (:class:`PagedAttnCache`).  Returns (B, L, D); the pool is updated
    in place."""
    b, l, _ = x.shape
    kw = dict(n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim,
              qk_norm=qk_norm, norm_eps=norm_eps, rope_theta=rope_theta,
              policy=policy, paged_backend=paged_backend)
    if isinstance(cache, PagedPrefillCache):
        out = _paged_prefill_chunk(p, x, cache, **kw)
    elif isinstance(cache, PagedAttnCache):
        if l != 1:
            raise ValueError("paged KV cache decodes one token at a time; "
                             "prompts go through chunked paged prefill "
                             "(PagedPrefillCache)")
        out = _paged_decode(p, x, cache, **kw)
    else:
        raise TypeError(f"unsupported cache {type(cache).__name__}")
    return _out_projection(p, x, out, b, l)


def _out_projection(p: Params, x: Tensor, out: Tensor, b: int,
                    l: int) -> Tensor:
    """(B, H, L, Dh) attention output → (B, L, D) through wo (+bo)."""
    out = out.to(x.dtype).transpose(1, 2).reshape(b, l, -1)
    out = out @ p["wo"].to(x.dtype)
    if "bo" in p:
        out = out + p["bo"].to(x.dtype)
    return out


# ---------------------------------------------------------------------------
# Feed-forward (SwiGLU / GELU)
# ---------------------------------------------------------------------------


def init_mlp(d_model: int, d_ff: int, generator: torch.Generator, device,
             gated: bool = True) -> Params:
    p = {"w_up": dense_init((d_model, d_ff), generator, device),
         "w_down": dense_init((d_ff, d_model), generator, device,
                              in_axis_size=d_ff)}
    if gated:
        p["w_gate"] = dense_init((d_model, d_ff), generator, device)
    return p


def apply_mlp(p: Params, x: Tensor) -> Tensor:
    up = x @ p["w_up"].to(x.dtype)
    if "w_gate" in p:
        gate = x @ p["w_gate"].to(x.dtype)
        h = F.silu(gate.float()).to(x.dtype) * up
    else:
        h = F.gelu(up.float(), approximate="tanh").to(x.dtype)
    return h @ p["w_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def init_embedding(vocab: int, d_model: int, generator: torch.Generator,
                   device) -> Params:
    t = torch.empty((vocab, d_model), dtype=torch.float32, device=device)
    return {"table": t.normal_(0.0, 1.0, generator=generator).mul_(0.02)}


def apply_embedding(p: Params, tokens: Tensor, dtype) -> Tensor:
    return p["table"][tokens.long()].to(dtype)


def init_lm_head(d_model: int, vocab: int, generator: torch.Generator,
                 device) -> Params:
    return {"w": dense_init((d_model, vocab), generator, device)}


def apply_lm_head(p: Params, x: Tensor) -> Tensor:
    """f32 logits.  f32 weights multiply in f32, as in the JAX package;
    weights stored in bf16 multiply bf16 operands with f32 accumulation,
    which spares an f32 copy of the (d_model, vocab) head per step."""
    w = p["w"]
    if w.dtype == torch.float32:
        return x.float() @ w
    return (x.to(w.dtype) @ w).float()
