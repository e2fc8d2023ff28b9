"""Core transformer layers over plain dicts of tensors.

The counterpart of the JAX package's ``models/layers.py`` for the
serving paths: norms (RMS, and LayerNorm with a bias), RoPE, the q/k/v
projections (with qk-norm and optional biases), self- and
cross-attention (:func:`apply_attention`, :func:`cross_attention_kv`),
the contiguous lockstep cache (:class:`AttnCache`) and the paged caches
with their scatter-then-attend steps, the MLP, the embedding and the LM
head.

Conventions (those of the JAX package, so weights convert one to one):
  * params are dicts of tensors; weights are ``(in, out)`` and a
    projection is ``x @ w``;
  * each matmul casts its weight to the activation dtype, as the JAX
    package does, so f32 masters and weights stored in the run dtype
    give the same operands;
  * attention logical shapes: q (B, H, L, Dh); pools
    (n_pages, page_size, KVH, Dh).

Unlike the JAX package's functional updates, the attention steps write
the new K/V into the cache or pool tensors **in place** (``index_put_``,
slice assignment) and advance a contiguous cache's ``length`` in place:
the KV storage is the largest serving buffer, and a copy per step would
double it.

Under an active tensor-parallel mesh (``partitioning.mesh_scope``, which
the serving engine enters around its steps) the paged steps attend
through the mesh rows of the paged dispatch (``ops.paged_mesh_regime``):
in the ``'heads'`` regime each rank scatters and attends its own KV
heads; in the ``'pages'`` regime each rank writes only the pages of its
slab (``sharded_paged.scatter_chunk_sharded``).  Weights cut by
``partitioning.shard_params`` are recognised by their shapes: q/k/v
projections cut by output column give the rank's heads and ``wo`` cut
by input row ends in an all-reduce of ``(B, L, d_model)``; in the
``'pages'`` regime the attention weights are never cut — its heads do
not split on KV-head boundaries — and only the MLP, the embedding and
the LM head shard (a memory layout; the function is the same).

Lockstep serving on a mesh (``serve_loop.make_prefill_step`` /
``make_decode_step`` with a ``mesh``) holds a rank's cut of each cache,
as ``partitioning.cache_specs`` places it: its rows, and its KV heads
when the weights are cut by heads; else its shard of the length
(:attr:`AttnCache.seq_axes`).  A prefill into a length shard computes
K/V for every position, attends to them and writes only its own
positions; a decode step writes the token's K/V on the rank that owns
its position and attends through ``lut_decode_sharded`` on each rank's
shard, the partials reduced over the length's axes.

An int8 page pool (``kv_dtype="int8"``) quantizes K/V at scatter time
with ``core.quantization.quantize_rows``, one f32 scale per token × KV
head; the lockstep path's contiguous cache instead fake-quantizes the
same rows with ``fake_quant_rows`` (the same rounding), so both read the
same values.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.policies import EXACT, SoftmaxPolicy
from repro_torch.core.quantization import fake_quant_rows, quantize_rows
from repro_torch.kernels.lut_attention.ops import (lut_attention,
                                                   lut_attention_paged_decode,
                                                   lut_attention_paged_prefill,
                                                   paged_mesh_regime)
from repro_torch.kernels.lut_attention.ref import _logits as attention_logits
from repro_torch.runtime import partitioning as PT

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


def layer_norm(x: Tensor, scale: Tensor, bias: Tensor, eps: float) -> Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def init_norm(d: int, device, with_bias: bool = False) -> Params:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if with_bias:
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(p: Params, x: Tensor, eps: float) -> Tensor:
    """LayerNorm when the norm has a bias (Whisper), else RMSNorm."""
    if "bias" in p:
        return layer_norm(x, p["scale"], p["bias"], eps)
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
class AttnCache:
    """Pre-allocated contiguous KV cache of the lockstep path; ``length``
    is the write cursor shared by the whole batch (advanced in place).

    ``seq_axes`` names the mesh axes the length is cut over (``()``:
    the cache holds every position): the cache then holds the positions
    ``[i · n, (i + 1) · n)`` of the ``max_len`` — ``n`` its own length,
    ``i`` the rank's row-major index over those axes."""

    k: Tensor    # (B, KVH, max_len, Dh), or its length shard
    v: Tensor
    length: int = 0
    seq_axes: tuple[str, ...] = ()

    @staticmethod
    def zeros(b: int, kvh: int, max_len: int, dh: int, dtype,
              device) -> "AttnCache":
        return AttnCache(
            k=torch.zeros((b, kvh, max_len, dh), dtype=dtype, device=device),
            v=torch.zeros((b, kvh, max_len, dh), dtype=dtype, device=device))


@dataclasses.dataclass
class PagedAttnCache:
    """Paged KV storage for continuous-batching decode.

    One pool of fixed-size pages is shared by every slot of the decode
    batch; a per-slot block table maps logical page index → physical page
    id, and ``lengths`` carries each slot's own write cursor.  Physical
    page 0 is the reserved **null page**: inactive slots map every
    logical page to it, so their garbage writes never touch live pages.

    With ``kv_dtype='int8'`` the pages store int8 and ``k_scales`` /
    ``v_scales`` (n_pages, page_size, KVH) f32 hold each row's scale.
    ``max_kv_len``, where the host knows it, bounds the keys any slot
    attends to in this step (``lengths + 1``); the kernel splits its keys
    by it.
    """

    k_pages: Tensor       # (n_pages, page_size, KVH, Dh)
    v_pages: Tensor
    block_tables: Tensor  # (B, max_pages_per_seq) int32 physical page ids
    lengths: Tensor       # (B,) int32 — tokens already cached per slot
    k_scales: Tensor | None = None   # int8 pools only
    v_scales: Tensor | None = None
    max_kv_len: int | None = None    # host-known bound on lengths + 1

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
    ``max_kv_len`` as for :class:`PagedAttnCache` (a bound on
    ``lengths + chunk_lens``).
    """

    k_pages: Tensor       # (n_pages, page_size, KVH, Dh)
    v_pages: Tensor
    block_tables: Tensor  # (B, max_pages_per_seq) int32
    lengths: Tensor       # (B,) int32 — tokens cached before this chunk
    chunk_lens: Tensor    # (B,) int32 — valid tokens entering this chunk
    k_scales: Tensor | None = None   # int8 pools only
    v_scales: Tensor | None = None
    max_kv_len: int | None = None    # host-known bound on the kv_lens

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


def _scatter(cache, phys: Tensor, offs: Tensor, k: Tensor, v: Tensor,
             slab_mesh=None) -> None:
    """Write token rows k, v (..., KVH, Dh) into the pool at (page, offset)
    pairs ``phys``, ``offs`` (...), in place.  An int8 pool quantizes each
    (token, KV head) row with its own scale — appending a token never
    requants its neighbours, so chunking and placement stay invisible.
    ``slab_mesh`` (the ``'pages'`` regime) keeps the writes to this
    rank's page slab."""
    if cache.k_scales is None:
        toks = (k.to(cache.k_pages.dtype), v.to(cache.v_pages.dtype))
        scales = (None, None)
    else:
        (kc, ks), (vc, vs) = quantize_rows(k), quantize_rows(v)
        toks, scales = (kc, vc), (ks, vs)
    if slab_mesh is not None:
        from repro_torch.kernels.lut_attention.sharded_paged import (
            scatter_chunk_sharded)
        scatter_chunk_sharded(cache.k_pages, cache.v_pages, phys, offs,
                              *toks, cache.k_scales, cache.v_scales,
                              *scales, mesh=slab_mesh)
        return
    cache.k_pages[phys, offs] = toks[0]
    cache.v_pages[phys, offs] = toks[1]
    if cache.k_scales is not None:
        cache.k_scales[phys, offs] = scales[0]
        cache.v_scales[phys, offs] = scales[1]


def _local_qkv(p: Params, x: Tensor, positions: Tensor, *, n_heads: int,
               n_kv_heads: int, head_dim: int, qk_norm: bool,
               norm_eps: float, rope_theta: float | None):
    """q, k, v of a paged step and how the rank's attention output is
    laid out: ``(q, k, v, mesh, regime, split)``.  k and v hold the KV
    heads this rank's pool stores; ``split`` (the ``'heads'`` regime
    under cut weights) means q holds this rank's heads only and ``wo``
    is cut by rows, else q holds every head."""
    mesh = PT.active_mesh()
    regime = paged_mesh_regime(mesh, n_kv_heads)
    if regime is None:
        mesh = None
    split = (regime == "heads"
             and p["wq"].shape[-1] != n_heads * head_dim)
    tp = PT.mesh_model_tp(mesh)
    h, kvh = ((n_heads // tp, n_kv_heads // tp) if split
              else (n_heads, n_kv_heads))
    q, k, v = _project_qkv(p, x, h, kvh, head_dim, qk_norm, norm_eps,
                           rope_theta, positions)
    if regime == "heads" and not split:
        n = n_kv_heads // tp
        k, v = (t[:, mesh.rank * n:(mesh.rank + 1) * n] for t in (k, v))
    return q, k, v, mesh, regime, split


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
    q, k, v, mesh, regime, split = _local_qkv(
        p, x, positions, n_heads=n_heads, n_kv_heads=n_kv_heads,
        head_dim=head_dim, qk_norm=qk_norm, norm_eps=norm_eps,
        rope_theta=rope_theta)
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
    _scatter(cache, phys, pos % ps, k.transpose(1, 2), v.transpose(1, 2),
             slab_mesh=mesh if regime == "pages" else None)
    out = lut_attention_paged_prefill(
        q, cache.k_pages, cache.v_pages, cache.block_tables,
        q_start=cache.lengths, kv_lens=cache.lengths + cache.chunk_lens,
        policy=policy, backend=paged_backend, k_scales=cache.k_scales,
        v_scales=cache.v_scales, max_kv_len=cache.max_kv_len, mesh=mesh,
        n_kv_heads=n_kv_heads, gather=not split)
    return out, (mesh if split else None)


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
    q, k, v, mesh, regime, split = _local_qkv(
        p, x, positions, n_heads=n_heads, n_kv_heads=n_kv_heads,
        head_dim=head_dim, qk_norm=qk_norm, norm_eps=norm_eps,
        rope_theta=rope_theta)
    ps = cache.page_size
    lengths = cache.lengths.long()
    phys = torch.gather(cache.block_tables.long(), 1,
                        (lengths // ps)[:, None])[:, 0]  # (B,)
    _scatter(cache, phys, lengths % ps, k[:, :, 0], v[:, :, 0],
             slab_mesh=mesh if regime == "pages" else None)
    out = lut_attention_paged_decode(q, cache.k_pages, cache.v_pages,
                                     cache.block_tables,
                                     kv_lens=cache.lengths + 1,
                                     policy=policy, backend=paged_backend,
                                     k_scales=cache.k_scales,
                                     v_scales=cache.v_scales,
                                     max_kv_len=cache.max_kv_len, mesh=mesh,
                                     n_kv_heads=n_kv_heads,
                                     gather=not split)
    return out, (mesh if split else None)


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
        out, row_mesh = _paged_prefill_chunk(p, x, cache, **kw)
    elif isinstance(cache, PagedAttnCache):
        if l != 1:
            raise ValueError("paged KV cache decodes one token at a time; "
                             "prompts go through chunked paged prefill "
                             "(PagedPrefillCache)")
        out, row_mesh = _paged_decode(p, x, cache, **kw)
    else:
        raise TypeError(f"unsupported cache {type(cache).__name__}")
    return _out_projection(p, x, out, b, l, row_mesh)


def apply_attention(p: Params, x: Tensor, *, n_heads: int, n_kv_heads: int,
                    head_dim: int, causal: bool = True,
                    qk_norm: bool = False, norm_eps: float = 1e-5,
                    rope_theta: float | None = 10000.0,
                    policy: SoftmaxPolicy = EXACT, backend: str = "auto",
                    cache=None, paged_backend: str = "auto",
                    kv_dtype: str = "f32", kv_x: Tensor | None = None,
                    precomputed_kv: tuple[Tensor, Tensor] | None = None,
                    collector=None) -> Tensor:
    """Self- or cross-attention of ``x`` (B, L, D) with the policy's
    softmax; returns (B, L, D).

    Modes (as in the JAX package):
      * no cache          — full sequence (the encoder; causal as asked);
      * :class:`AttnCache` — lockstep prefill (L tokens at ``length``)
        or decode (L = 1): writes K/V at [length, length + L) in place,
        advances ``length``, attends to the valid prefix;
      * ``kv_x`` / ``precomputed_kv`` — cross-attention (never causal)
        to a source sequence, whose K/V are projected here or were
        projected once by :func:`cross_attention_kv`;
      * a paged cache     — :func:`apply_paged_attention`.

    ``backend`` is the ``lut_attention`` knob of the non-paged modes
    (``auto`` | ``cuda`` | ``naive``).  ``kv_dtype="int8"``
    fake-quantizes the K/V entering a contiguous cache with the int8
    pool's rounding (``fake_quant_rows``), the lockstep view of the
    engine's int8 pool; paged caches carry real scales instead and
    ignore it.

    ``collector`` (``core.calibration.SumCollector``) is the Σe^x
    calibration tap: it is offered the f32 pre-softmax logits of the
    first query head of the first sequence against its KV head — after
    the cache write, so against the cache's keys — at scale
    ``head_dim ** -0.5``, causal as asked: the slice the JAX package
    takes.  Without one nothing is computed.
    """
    is_cross = kv_x is not None or precomputed_kv is not None
    if isinstance(cache, (PagedAttnCache, PagedPrefillCache)):
        if is_cross:
            raise ValueError("paged KV cache supports self-attention only")
        return apply_paged_attention(
            p, x, cache, n_heads=n_heads, n_kv_heads=n_kv_heads,
            head_dim=head_dim, qk_norm=qk_norm, norm_eps=norm_eps,
            rope_theta=rope_theta, policy=policy,
            paged_backend=paged_backend)
    if cache is not None and not isinstance(cache, AttnCache):
        raise TypeError(f"unsupported cache {type(cache).__name__}")
    b, l, _ = x.shape
    base = cache.length if cache is not None else 0
    positions = (base + torch.arange(l, dtype=torch.int32, device=x.device)
                 )[None, :].expand(b, l)
    mesh = PT.active_mesh()
    tp = PT.mesh_model_tp(mesh)
    # weights cut by heads (training or serving under a mesh): this
    # rank's heads, the input's gradient summed over the ranks, wo's rows
    # reduced
    row_mesh = mesh if (tp > 1 and
                        p["wq"].shape[-1] != n_heads * head_dim) else None
    xin, h, kvh = x, n_heads, n_kv_heads
    if row_mesh is not None:
        xin = PT.copy_to(x, mesh, site="attn.in")
        h, kvh = n_heads // tp, n_kv_heads // tp
    q, k, v = _project_qkv(p, xin, h, kvh, head_dim, qk_norm,
                           norm_eps, rope_theta, positions)
    if precomputed_kv is not None:
        k, v = precomputed_kv
    elif kv_x is not None:
        src = PT.copy_to(kv_x, mesh, site="attn.src") if row_mesh else kv_x
        k, v = cross_attention_kv(p, src, n_kv_heads=kvh, head_dim=head_dim)
    kv_len = None
    if cache is not None and cache.seq_axes:
        if kv_dtype == "int8":
            k = fake_quant_rows(k).to(k.dtype)
            v = fake_quant_rows(v).to(v.dtype)
        out = _length_shard_attention(q, k, v, cache, mesh, policy, causal,
                                      backend)
        return _out_projection(p, x, out, b, l, row_mesh)
    if cache is not None:
        if kv_dtype == "int8":
            k = fake_quant_rows(k).to(k.dtype)
            v = fake_quant_rows(v).to(v.dtype)
        end = cache.length + l
        if end > cache.k.shape[2]:
            raise ValueError(f"cache of {cache.k.shape[2]} positions cannot "
                             f"take {l} more after {cache.length}")
        cache.k[:, :, cache.length:end] = k.to(cache.k.dtype)
        cache.v[:, :, cache.length:end] = v.to(cache.v.dtype)
        cache.length = end
        k, v, kv_len = cache.k, cache.v, end
    if collector is not None:
        collector.offer(attention_logits(q[:1, :1].float(),
                                         k[:1, :1].float(),
                                         head_dim ** -0.5, causal))
    out = lut_attention(q, k, v, policy, causal=causal and not is_cross,
                        kv_len=kv_len, backend=backend)
    return _out_projection(p, x, out, b, l, row_mesh)


def _length_shard_attention(q: Tensor, k: Tensor, v: Tensor,
                            cache: AttnCache, mesh, policy: SoftmaxPolicy,
                            causal: bool, backend: str) -> Tensor:
    """Attention of L new tokens' q, k, v against a cache that holds this
    rank's shard of the length (``cache.seq_axes``): the new K/V go into
    the positions the shard owns, then

    * a fresh prefill (the cache was empty) attends to the new K/V
      themselves — every position, on every rank, as without a mesh;
    * a decode step under the exact or REXP policy whose length is cut
      over ``'model'`` (the KV heads do not divide it) attends through
      ``sharded_decode.lut_decode_sharded`` on the rank's shard, the
      partials reduced over ``seq_axes`` (the JAX package's route, taken
      under the same condition);
    * anything else (2D-LUT decode, a length cut over ``'data'`` alone,
      a prompt after cached tokens) gathers the shards over ``seq_axes``
      and attends to the whole cache, as the JAX package's SPMD program
      does."""
    axes = cache.seq_axes
    n = cache.k.shape[2]
    lo = mesh.index(axes) * n
    base, l = cache.length, q.shape[2]
    end = base + l
    if end > n * mesh.size(axes):
        raise ValueError(f"cache of {n * mesh.size(axes)} positions cannot "
                         f"take {l} more after {base}")
    a, z = max(base, lo), min(end, lo + n)
    if a < z:
        cache.k[:, :, a - lo:z - lo] = k[:, :, a - base:z - base].to(
            cache.k.dtype)
        cache.v[:, :, a - lo:z - lo] = v[:, :, a - base:z - base].to(
            cache.v.dtype)
    cache.length = end
    if base == 0:
        return lut_attention(q, k.to(cache.k.dtype), v.to(cache.v.dtype),
                             policy, causal=causal, kv_len=end,
                             backend=backend)
    if l == 1 and policy.impl in ("exact", "rexp") and "model" in axes:
        from repro_torch.kernels.lut_attention.sharded_decode import (
            lut_decode_sharded)
        return lut_decode_sharded(q, cache.k, cache.v, policy, kv_len=end,
                                  mesh=mesh, start=lo, axes=axes)
    kw = PT.all_gather(cache.k, mesh, 2, site="kv_gather", axis=axes)
    vw = PT.all_gather(cache.v, mesh, 2, site="kv_gather", axis=axes)
    return lut_attention(q, kw, vw, policy, causal=causal, kv_len=end,
                         backend=backend)


def cross_attention_kv(p: Params, src: Tensor, *, n_kv_heads: int,
                       head_dim: int) -> tuple[Tensor, Tensor]:
    """Project source states (B, L, D) into cross-attention K/V
    (B, KVH, L, Dh), contiguous, once (a decoder caches them)."""
    b, l, _ = src.shape

    def proj(w, bias):
        y = src @ p[w].to(src.dtype)
        if bias in p:
            y = y + p[bias].to(src.dtype)
        return y.reshape(b, l, n_kv_heads, head_dim).transpose(1, 2) \
            .contiguous()

    return proj("wk", "bk"), proj("wv", "bv")


def _out_projection(p: Params, x: Tensor, out: Tensor, b: int, l: int,
                    row_mesh=None) -> Tensor:
    """(B, H, L, Dh) attention output → (B, L, D) through wo (+bo).
    ``row_mesh``: ``out`` holds this rank's heads and ``wo`` its rows, so
    the partial products are summed over the ranks before the bias."""
    out = out.to(x.dtype).transpose(1, 2).reshape(b, l, -1)
    out = out @ p["wo"].to(x.dtype)
    if row_mesh is not None:
        out = PT.reduce_from(out, row_mesh, site="wo")
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


def mlp_row_mesh(p: Params, d_ff: int):
    """The active mesh when the MLP ``p``'s hidden units are this rank's
    cut (``w_down`` holds fewer than ``d_ff`` rows), else None."""
    mesh = PT.active_mesh()
    return mesh if mesh is not None and p["w_down"].shape[0] != d_ff \
        else None


def apply_mlp(p: Params, x: Tensor, row_mesh=None) -> Tensor:
    """The MLP; ``row_mesh``: the weights are this rank's cut of the
    hidden axis (gate and up by column, down by row), and the partial
    outputs are summed over the ranks (``partitioning.copy_to`` /
    ``reduce_from``: differentiable)."""
    if row_mesh is not None:
        x = PT.copy_to(x, row_mesh, site="mlp.in")
    up = x @ p["w_up"].to(x.dtype)
    if "w_gate" in p:
        gate = x @ p["w_gate"].to(x.dtype)
        h = F.silu(gate.float()).to(x.dtype) * up
    else:
        h = F.gelu(up.float(), approximate="tanh").to(x.dtype)
    out = h @ p["w_down"].to(x.dtype)
    if row_mesh is not None:
        out = PT.reduce_from(out, row_mesh, site="w_down")
    return out


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def init_embedding(vocab: int, d_model: int, generator: torch.Generator,
                   device) -> Params:
    t = torch.empty((vocab, d_model), dtype=torch.float32, device=device)
    return {"table": t.normal_(0.0, 1.0, generator=generator).mul_(0.02)}


def apply_embedding(p: Params, tokens: Tensor, dtype,
                    vocab: int | None = None) -> Tensor:
    """Rows of the table for ``tokens``.  Under an active mesh a table
    cut to ``vocab / tp`` rows (``shard_params``) looks up the tokens in
    this rank's range, zeros the rest, and sums over the ranks — exactly
    one rank contributes each row."""
    table = p["table"]
    mesh = PT.active_mesh()
    if vocab is None or mesh is None or table.shape[0] == vocab:
        return table[tokens.long()].to(dtype)
    n = table.shape[0]
    t = tokens.long() - mesh.rank * n
    mine = (t >= 0) & (t < n)
    rows = table[t.clamp(0, n - 1)].to(dtype)
    rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=dtype,
                                                          device=rows.device))
    return PT.reduce_from(rows, mesh, site="embed")


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
