"""Decoder-only LM assembled from an ArchConfig's layer periods.

The counterpart of the JAX package's ``models/transformer.py`` for the
paged serving path, restricted to attention+MLP blocks (the dense archs
in ``configs``).  Parameters keep the JAX package's tree: the period
blocks are stacked on a leading ``n_periods`` axis, so
``params_from_jax`` converts a JAX tree leaf by leaf.  The JAX package
scans over the periods; here a Python loop walks them.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core.policies import SoftmaxPolicy
from repro_torch.models import layers as L
from repro_torch.models.convert import tree_map
from repro_torch.runtime.paged_cache import pool_leaf_specs

Tensor = torch.Tensor
Params = dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def run_dtype(run: RunConfig) -> torch.dtype:
    return _DTYPES[run.dtype]


def check_paged_supported(cfg: ArchConfig) -> None:
    """The port serves attention+MLP decoders (the dense serving archs)."""
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


def apply_block(p: Params, x: Tensor, cfg: ArchConfig, run: RunConfig, *,
                policy: SoftmaxPolicy, cache) -> Tensor:
    h = L.apply_norm(p["norm1"], x, cfg.norm_eps)
    x = x + L.apply_paged_attention(
        p["mixer"], h, cache, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, qk_norm=cfg.qk_norm,
        norm_eps=cfg.norm_eps,
        rope_theta=cfg.rope_theta if cfg.rope else None, policy=policy,
        paged_backend=run.paged_backend)
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
                device="cpu") -> Params:
    """Random f32 parameters in the JAX package's tree layout, drawn from
    ``generator`` (torch's own stream: not the JAX package's numbers)."""
    check_paged_supported(cfg)
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


def init_paged_pools(cfg: ArchConfig, n_pages: int, page_size: int,
                     dtype: torch.dtype, device):
    """Per-layer paged KV pools, periods-stacked: one dict per period
    spec, each leaf ``(n_periods, n_pages, page_size, KVH, Dh)``.  Page 0
    of every pool is the reserved null page."""
    check_paged_supported(cfg)
    specs = pool_leaf_specs(n_pages, page_size, cfg.n_kv_heads,
                            cfg.resolved_head_dim)
    return tuple(
        {name: torch.zeros((cfg.n_periods,) + shape, dtype=dtype,
                           device=device)
         for name, (shape, _) in specs.items()}
        for _ in cfg.period)


def _apply_stack(params: Params, x: Tensor, cfg: ArchConfig, run: RunConfig,
                 make_cache) -> Tensor:
    """Run every layer, periods outermost as the JAX package's scan does;
    ``make_cache(spec_index, period_index)`` builds a layer's paged cache
    over views of its pools (written in place)."""
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


def decode_step_paged(params: Params, token: Tensor, pools, block_tables,
                      lengths, cfg: ArchConfig, run: RunConfig) -> Tensor:
    """One continuous-batching decode step against the paged pools.

    token (B, 1) int; block_tables (B, mp) int32; lengths (B,) int32 —
    tokens already cached per slot (shared by every layer; the pools are
    per layer and updated in place).  Returns logits (B, 1, V) f32.
    """
    x = L.apply_embedding(params["embed"], token, run_dtype(run))

    def make_cache(si, pi):
        pool = pools[si]
        return L.PagedAttnCache(k_pages=pool["k_pages"][pi],
                                v_pages=pool["v_pages"][pi],
                                block_tables=block_tables, lengths=lengths)

    return _head(params, cfg, _apply_stack(params, x, cfg, run, make_cache))


def prefill_chunk_paged(params: Params, tokens: Tensor, pools, block_tables,
                        cache_lens, chunk_lens, cfg: ArchConfig,
                        run: RunConfig) -> Tensor:
    """One fixed-shape prefill chunk straight into the paged pools.

    tokens (B, C) int, zero-padded past ``chunk_lens``; block_tables
    (B, mp) int32; cache_lens (B,) int32 — tokens already in the pool;
    chunk_lens (B,) int32 — valid tokens entering this chunk.  Every
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
                                   lengths=cache_lens, chunk_lens=chunk_lens)

    x = _apply_stack(params, x, cfg, run, make_cache)
    last = torch.clamp(chunk_lens.long() - 1, min=0)
    x_last = x[torch.arange(x.shape[0], device=x.device), last][:, None]
    return _head(params, cfg, x_last)
