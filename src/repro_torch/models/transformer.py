"""Decoder-only LM assembled from an ArchConfig's layer periods.

The counterpart of the JAX package's ``models/transformer.py`` for the
serving paths, restricted to attention+MLP blocks (the dense archs in
``configs``):

  * ``prefill`` / ``decode_step`` — the lockstep path over contiguous
    per-layer caches (:class:`layers.AttnCache`), ``run.softmax_policy``
    in every attention;
  * ``prefill_chunk_paged`` / ``decode_step_paged`` — the
    continuous-batching engine's steps against the paged pools.

Parameters keep the JAX package's tree: the period blocks are stacked on
a leading ``n_periods`` axis, so ``params_from_jax`` converts a JAX tree
leaf by leaf.  The JAX package scans over the periods; here a Python
loop walks them.  Caches and pools are updated in place.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core.policies import SoftmaxPolicy
from repro_torch.models import layers as L
from repro_torch.models.convert import tree_map
from repro_torch.models.device import resolve_device
from repro_torch.runtime.paged_cache import pool_leaf_specs

Tensor = torch.Tensor
Params = dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int8": torch.int8}


def run_dtype(run: RunConfig) -> torch.dtype:
    return _DTYPES[run.dtype]


def check_paged_supported(cfg: ArchConfig) -> None:
    """This module serves attention+MLP decoders (the dense serving
    archs); an encoder-decoder goes through ``models/encdec.py``."""
    bad = [(s.mixer, s.ffn) for s in cfg.period
           if s.mixer != "attn" or s.ffn != "mlp"]
    if bad or cfg.encoder_layers:
        raise NotImplementedError(
            f"{cfg.name}: the port serves attention+MLP decoders only, got "
            f"{bad or 'an encoder-decoder'}")


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def init_block(cfg: ArchConfig, generator: torch.Generator,
               device) -> Params:
    return {
        "norm1": L.init_norm(cfg.d_model, device),
        "mixer": L.init_attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.resolved_head_dim, generator, device,
                                  qk_norm=cfg.qk_norm,
                                  with_bias=cfg.attn_bias),
        "norm2": L.init_norm(cfg.d_model, device),
        "ffn": L.init_mlp(cfg.d_model, cfg.d_ff, generator, device,
                          gated=cfg.mlp_gated),
    }


def block_cache(cfg: ArchConfig, b: int, max_len: int, dtype,
                device) -> L.AttnCache:
    return L.AttnCache.zeros(b, cfg.n_kv_heads, max_len,
                             cfg.resolved_head_dim, dtype, device)


def apply_block(p: Params, x: Tensor, cfg: ArchConfig, run: RunConfig, *,
                policy: SoftmaxPolicy, cache) -> Tensor:
    h = L.apply_norm(p["norm1"], x, cfg.norm_eps)
    x = x + L.apply_attention(
        p["mixer"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, causal=True, qk_norm=cfg.qk_norm,
        norm_eps=cfg.norm_eps,
        rope_theta=cfg.rope_theta if cfg.rope else None, policy=policy,
        backend=run.attention_backend, cache=cache,
        paged_backend=run.paged_backend, kv_dtype=run.kv_dtype)
    h2 = L.apply_norm(p["norm2"], x, cfg.norm_eps)
    return x + L.apply_mlp(p["ffn"], h2)


def _tree_stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees, dim=0)


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """Random f32 parameters in the JAX package's tree layout, drawn from
    ``generator`` (torch's own stream: not the JAX package's numbers), on
    the card unless ``device="cpu"``."""
    check_paged_supported(cfg)
    device = resolve_device(device)
    periods = [
        _tree_stack([init_block(cfg, generator, device)
                     for _ in range(cfg.n_periods)])
        for _ in cfg.period]
    p = {
        "embed": L.init_embedding(cfg.vocab_size, cfg.d_model, generator,
                                  device),
        "periods": periods,
        "final_norm": L.init_norm(cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        p["head"] = L.init_lm_head(cfg.d_model, cfg.vocab_size, generator,
                                   device)
    return p


def init_caches(cfg: ArchConfig, b: int, max_len: int, dtype, device):
    """Lockstep caches: ``caches[period][spec]``, one zeroed
    :class:`layers.AttnCache` per layer."""
    check_paged_supported(cfg)
    return [[block_cache(cfg, b, max_len, dtype, device) for _ in cfg.period]
            for _ in range(cfg.n_periods)]


def init_paged_pools(cfg: ArchConfig, n_pages: int, page_size: int,
                     dtype: torch.dtype, device, kv_dtype: str = "f32"):
    """Per-layer paged KV pools, periods-stacked: one dict per period
    spec, each leaf ``(n_periods,) + spec shape``.  Every leaf takes its
    own dtype from ``pool_leaf_specs``: ``dtype`` pages for an ``f32``
    pool; int8 pages plus zeroed f32 ``k_scales`` / ``v_scales`` for
    ``int8``.  Page 0 of every pool is the reserved null page."""
    check_paged_supported(cfg)
    page_dtype = {v: k for k, v in _DTYPES.items()}[dtype]
    specs = pool_leaf_specs(n_pages, page_size, cfg.n_kv_heads,
                            cfg.resolved_head_dim, kv_dtype=kv_dtype,
                            page_dtype=page_dtype)
    return tuple(
        {name: torch.zeros((cfg.n_periods,) + shape, dtype=_DTYPES[dt],
                           device=device)
         for name, (shape, dt) in specs.items()}
        for _ in cfg.period)


def _apply_stack(params: Params, x: Tensor, cfg: ArchConfig, run: RunConfig,
                 make_cache) -> Tensor:
    """Run every layer, periods outermost as the JAX package's scan does;
    ``make_cache(spec_index, period_index)`` gives a layer's cache (a
    lockstep cache, or a paged cache over views of its pools), written
    in place."""
    for pi in range(cfg.n_periods):
        for si in range(len(cfg.period)):
            pp = tree_map(lambda a, _, pi=pi: a[pi],
                          params["periods"][si])
            x = apply_block(pp, x, cfg, run, policy=run.softmax_policy,
                            cache=make_cache(si, pi))
    return x


def _head(params: Params, cfg: ArchConfig, x: Tensor) -> Tensor:
    x = L.apply_norm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return x.float() @ params["embed"]["table"].float().T
    return L.apply_lm_head(params["head"], x)


def prefill(params: Params, tokens: Tensor, cfg: ArchConfig, run: RunConfig,
            max_len: int, logits: str = "all"):
    """Fill fresh lockstep caches for the (B, S) prompt; returns
    ``(logits, caches)``.  ``logits='last'`` applies the LM head to the
    final position only."""
    caches = init_caches(cfg, tokens.shape[0], max_len, run_dtype(run),
                         tokens.device)
    x = L.apply_embedding(params["embed"], tokens, run_dtype(run))
    x = _apply_stack(params, x, cfg, run, lambda si, pi: caches[pi][si])
    if logits == "last":
        x = x[:, -1:]
    return _head(params, cfg, x), caches


def decode_step(params: Params, token: Tensor, caches, cfg: ArchConfig,
                run: RunConfig):
    """One lockstep decode step: token (B, 1) against the caches (updated
    in place); returns ``(logits (B, 1, V), caches)``."""
    x = L.apply_embedding(params["embed"], token, run_dtype(run))
    x = _apply_stack(params, x, cfg, run, lambda si, pi: caches[pi][si])
    return _head(params, cfg, x), caches


def _pool_scales(pool, pi):
    """The int8 pool's scale views of layer ``pi`` (None for f32)."""
    if "k_scales" not in pool:
        return {}
    return dict(k_scales=pool["k_scales"][pi], v_scales=pool["v_scales"][pi])


def decode_step_paged(params: Params, token: Tensor, pools, block_tables,
                      lengths, cfg: ArchConfig, run: RunConfig,
                      max_kv_len: int | None = None) -> Tensor:
    """One continuous-batching decode step against the paged pools.

    token (B, 1) int; block_tables (B, mp) int32; lengths (B,) int32 —
    tokens already cached per slot (shared by every layer; the pools are
    per layer and updated in place); ``max_kv_len`` the host's bound on
    ``lengths + 1``, if it knows one.  Returns logits (B, 1, V) f32.
    """
    x = L.apply_embedding(params["embed"], token, run_dtype(run))

    def make_cache(si, pi):
        pool = pools[si]
        return L.PagedAttnCache(k_pages=pool["k_pages"][pi],
                                v_pages=pool["v_pages"][pi],
                                block_tables=block_tables, lengths=lengths,
                                max_kv_len=max_kv_len,
                                **_pool_scales(pool, pi))

    return _head(params, cfg, _apply_stack(params, x, cfg, run, make_cache))


def prefill_chunk_paged(params: Params, tokens: Tensor, pools, block_tables,
                        cache_lens, chunk_lens, cfg: ArchConfig,
                        run: RunConfig,
                        max_kv_len: int | None = None) -> Tensor:
    """One fixed-shape prefill chunk straight into the paged pools.

    tokens (B, C) int, zero-padded past ``chunk_lens``; block_tables
    (B, mp) int32; cache_lens (B,) int32 — tokens already in the pool;
    chunk_lens (B,) int32 — valid tokens entering this chunk;
    ``max_kv_len`` the host's bound on ``cache_lens + chunk_lens``, if
    it knows one.  Every
    layer scatters the chunk's K/V into its pool pages and attends
    through the block tables.  Returns logits (B, 1, V) f32 of each
    row's last valid chunk position (only meaningful for the final chunk
    of a prompt).
    """
    x = L.apply_embedding(params["embed"], tokens, run_dtype(run))

    def make_cache(si, pi):
        pool = pools[si]
        return L.PagedPrefillCache(k_pages=pool["k_pages"][pi],
                                   v_pages=pool["v_pages"][pi],
                                   block_tables=block_tables,
                                   lengths=cache_lens, chunk_lens=chunk_lens,
                                   max_kv_len=max_kv_len,
                                   **_pool_scales(pool, pi))

    x = _apply_stack(params, x, cfg, run, make_cache)
    last = torch.clamp(chunk_lens.long() - 1, min=0)
    x_last = x[torch.arange(x.shape[0], device=x.device), last][:, None]
    return _head(params, cfg, x_last)
