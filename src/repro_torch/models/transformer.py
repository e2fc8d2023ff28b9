"""Decoder-only LM assembled from an ArchConfig's layer periods.

The counterpart of the JAX package's ``models/transformer.py`` for the
serving paths.  A block is a norm, a mixer — attention, or Mamba, mLSTM
or sLSTM (``models/ssm.py``) — and, unless its FFN is ``"none"``
(xLSTM), a second norm and an MLP or an MoE FFN (``models/moe.py``):

  * ``prefill`` / ``decode_step`` — the lockstep path over per-layer
    caches (:class:`layers.AttnCache` for attention, the recurrent
    state of ``ssm.py`` for the other mixers), ``run.softmax_policy``
    in every attention; every arch of ``configs`` but the
    encoder-decoder (:func:`check_supported`);
  * ``prefill_chunk_paged`` / ``decode_step_paged`` — the
    continuous-batching engine's steps against the paged pools, for
    decoders of attention mixers only (:func:`check_paged_supported`),
    as in the JAX package;
  * ``train_logits`` — the full sequence with no cache under the exact
    softmax, differentiable: the MoE FFNs add their load-balance loss
    to ``aux``, and ``run.remat`` recomputes each period's activations
    in the backward (``torch.utils.checkpoint``), as the JAX package's
    ``jax.checkpoint`` does.  Without a cache every mixer builds its
    outputs without writing into a tensor autograd saved.

``prefill`` and ``train_logits`` take the Σe^x calibration
``collector`` (``core/calibration.py``), which every attention layer
offers its logits (``layers.apply_attention``); a collector turns remat
off, as in the JAX package.

Under an active tensor-parallel mesh (``partitioning.mesh_scope``) the
paged steps serve one rank's share: its pools
(:func:`init_paged_pools` with the ``mesh``), and — with weights cut by
``partitioning.shard_params`` — its cut of the MLP (summed over the
ranks after ``w_down``), of the embedding (vocabulary rows, summed) and
of the LM head (vocabulary columns, gathered); see ``layers.py`` for the
attention.  An MoE FFN runs replicated on every rank (its weights are
not cut: expert parallelism is not ported, and ``shard_params`` refuses
an MoE arch).

Parameters keep the JAX package's tree: the period blocks are stacked on
a leading ``n_periods`` axis, so ``params_from_jax`` converts a JAX tree
leaf by leaf.  The JAX package scans over the periods; here a Python
loop walks them.  Caches and pools are updated in place.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, LayerSpec, RunConfig
from repro_torch.core.policies import EXACT, SoftmaxPolicy
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.convert import cast_params, tree_map
from repro_torch.models.device import resolve_device
from repro_torch.runtime import partitioning as PT
from repro_torch.runtime.paged_cache import pool_leaf_specs

Tensor = torch.Tensor
Params = dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int8": torch.int8}


def run_dtype(run: RunConfig) -> torch.dtype:
    return _DTYPES[run.dtype]


MIXERS = ("attn", "mamba", "mlstm", "slstm")
FFNS = ("mlp", "moe", "none")


def check_supported(cfg: ArchConfig) -> None:
    """The lockstep path serves decoders of any mixer of :data:`MIXERS`
    with an FFN of :data:`FFNS`; an encoder-decoder goes through
    ``models/encdec.py``."""
    bad = [(s.mixer, s.ffn) for s in cfg.period
           if s.mixer not in MIXERS or s.ffn not in FFNS]
    if bad or cfg.encoder_layers:
        raise NotImplementedError(
            f"{cfg.name}: the port's decoders take mixers {MIXERS} with an "
            f"FFN of {FFNS}, got {bad or 'an encoder-decoder'}")


def paged_supported(cfg: ArchConfig) -> bool:
    """Whether the paged path serves ``cfg``: a decoder of attention
    mixers with an MLP or an MoE FFN (the dense and MoE serving archs),
    as the JAX package's paged path is — a recurrent mixer keeps no
    per-token KV to page."""
    return not cfg.encoder_layers and all(
        s.mixer == "attn" and s.ffn in ("mlp", "moe") for s in cfg.period)


def check_paged_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` unless :func:`paged_supported`."""
    if not paged_supported(cfg):
        got = ("an encoder-decoder" if cfg.encoder_layers else
               sorted({(s.mixer, s.ffn) for s in cfg.period}))
        raise NotImplementedError(
            f"{cfg.name}: paged KV serving takes attention decoders with an "
            f"MLP or MoE FFN only, got {got}")


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def init_block(cfg: ArchConfig, spec: LayerSpec,
               generator: torch.Generator, device) -> Params:
    p: Params = {"norm1": L.init_norm(cfg.d_model, device)}
    if spec.mixer == "attn":
        p["mixer"] = L.init_attention(
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            generator, device, qk_norm=cfg.qk_norm, with_bias=cfg.attn_bias)
    elif spec.mixer == "mamba":
        p["mixer"] = SSM.init_mamba(cfg.d_model, generator, device)
    elif spec.mixer == "mlstm":
        p["mixer"] = SSM.init_mlstm(cfg.d_model, cfg.n_heads, generator,
                                    device)
    else:
        p["mixer"] = SSM.init_slstm(cfg.d_model, cfg.n_heads, generator,
                                    device)
    if spec.ffn == "none":
        return p
    p["norm2"] = L.init_norm(cfg.d_model, device)
    if spec.ffn == "moe":
        m = cfg.moe
        p["ffn"] = MOE.init_moe(cfg.d_model, m.d_expert, m.n_experts,
                                m.n_shared, generator, device)
    else:
        p["ffn"] = L.init_mlp(cfg.d_model, cfg.d_ff, generator, device,
                              gated=cfg.mlp_gated)
    return p


def block_cache(cfg: ArchConfig, spec: LayerSpec, b: int, max_len: int,
                dtype, device):
    """A layer's lockstep cache: K/V for attention, the recurrent state
    for the other mixers."""
    if spec.mixer == "attn":
        return L.AttnCache.zeros(b, cfg.n_kv_heads, max_len,
                                 cfg.resolved_head_dim, dtype, device)
    if spec.mixer == "mamba":
        return SSM.MambaCache.zeros(b, cfg.d_model, dtype, device)
    if spec.mixer == "mlstm":
        return SSM.MLSTMCache.zeros(b, cfg.d_model, cfg.n_heads, device)
    return SSM.SLSTMCache.zeros(b, cfg.d_model, cfg.n_heads, device)


def apply_block(p: Params, x: Tensor, cfg: ArchConfig, run: RunConfig,
                spec: LayerSpec, *, policy: SoftmaxPolicy, cache,
                collector=None, return_aux: bool = False, path: str = ""):
    """One layer (``path``: its place in the parameter tree,
    ``periods/<i>``); returns ``(x, aux)``: ``aux`` holds an MoE FFN's
    training terms (``moe.aux_losses``) when ``return_aux``, else is
    empty."""
    scope = PT.active_scope()
    h = L.apply_norm(p["norm1"], x, cfg.norm_eps)
    if spec.mixer == "attn":
        mixed = L.apply_attention(
            p["mixer"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, causal=True, qk_norm=cfg.qk_norm,
            norm_eps=cfg.norm_eps,
            rope_theta=cfg.rope_theta if cfg.rope else None, policy=policy,
            backend=run.attention_backend, cache=cache,
            paged_backend=run.paged_backend, kv_dtype=run.kv_dtype,
            collector=collector, path=f"{path}/mixer")
    elif spec.mixer == "mamba":
        mixed = SSM.apply_mamba(p["mixer"], h, cache=cache,
                                path=f"{path}/mixer")
    elif spec.mixer == "mlstm":
        mixed = SSM.apply_mlstm(p["mixer"], h, n_heads=cfg.n_heads,
                                cache=cache)
    else:
        mixed = SSM.apply_slstm(p["mixer"], h, n_heads=cfg.n_heads,
                                cache=cache)
    x = x + mixed
    if spec.ffn == "none":
        return x, {}
    h2 = L.apply_norm(p["norm2"], x, cfg.norm_eps)
    if spec.ffn == "moe":
        m = cfg.moe
        y = MOE.apply_moe(
            p["ffn"], h2, n_experts=m.n_experts, top_k=m.top_k,
            capacity_factor=m.capacity_factor,
            router_policy=run.router_policy, return_aux=return_aux,
            d_expert=m.d_expert, n_shared=m.n_shared, path=f"{path}/ffn")
        y, aux = y if return_aux else (y, {})
        return x + y, aux
    return x + L.apply_mlp(
        p["ffn"], h2, row_mesh=scope.model_mesh(f"{path}/ffn/w_up")), {}


def _stack_into(out, tree, i: int):
    """Write ``tree``'s leaves into slot ``i`` of the stacked ``out``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _stack_into(out[k], v, i)
    else:
        out[i].copy_(tree)


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda", dtype: torch.dtype | None = None,
                layout=None) -> Params:
    """Random f32 parameters in the JAX package's tree layout, drawn from
    ``generator`` (torch's own stream: not the JAX package's numbers), on
    the card unless ``device="cpu"``.

    With ``dtype`` each block is cast (``convert.cast_params``) as soon as
    it is drawn and written into the periods-stacked leaves, so the f32
    model never exists whole: the result equals ``cast_params`` of the
    f32 init, at the memory of the cast model plus one f32 block (a
    16.9B-parameter MoE decoder fits the card in bf16, not in f32).
    With a ``layout`` (``partitioning.Layout``) each block is cut to the
    rank's part as soon as it is drawn, so the result equals
    ``layout.cut`` of the whole init while no more than one block of the
    model exists whole."""
    check_supported(cfg)
    device = resolve_device(device)
    periods = []
    for si, spec in enumerate(cfg.period):
        stacked = None
        for i in range(cfg.n_periods):
            block = init_block(cfg, spec, generator, device)
            if dtype is not None:
                block = cast_params(block, dtype)
            if layout is not None:
                block = PT._walk(block, lambda p, x: layout.cut_leaf(
                    f"periods/{si}/{p}", x, one_period=True))
            if stacked is None:
                stacked = tree_map(lambda a, _: a.new_empty(
                    (cfg.n_periods,) + tuple(a.shape)), block)
            _stack_into(stacked, block, i)
            del block
        if layout is not None:
            stacked = PT._walk(stacked, lambda p, x: PT.cut_leaf(
                x, layout.specs[f"periods/{si}/{p}"][:1], layout.mesh))
        periods.append(stacked)

    def cut(name, tree):
        tree = tree if dtype is None else cast_params(tree, dtype)
        return tree if layout is None else PT._walk(
            tree, lambda p, x: layout.cut_leaf(f"{name}/{p}", x))
    p = {
        "embed": cut("embed", L.init_embedding(cfg.vocab_size, cfg.d_model,
                                               generator, device)),
        "periods": periods,
        "final_norm": cut("final_norm", L.init_norm(cfg.d_model, device)),
    }
    if not cfg.tie_embeddings:
        p["head"] = cut("head", L.init_lm_head(cfg.d_model, cfg.vocab_size,
                                               generator, device))
    return p


def init_caches(cfg: ArchConfig, b: int, max_len: int, dtype, device,
                mesh=None, shard_kv_seq: bool = False):
    """Lockstep caches: ``caches[period][spec]``, one zeroed cache per
    layer (:func:`block_cache`).  With a ``mesh``, ``b`` is the global
    batch and each cache this rank's cut (``partitioning.cache_specs``:
    its rows, its KV heads or its shard of the length)."""
    check_supported(cfg)
    if mesh is not None:
        return PT.local_caches(
            lambda: init_caches(cfg, b, max_len, dtype, "meta"), mesh, b,
            cfg.n_kv_heads, shard_kv_seq, device)
    return [[block_cache(cfg, spec, b, max_len, dtype, device)
             for spec in cfg.period] for _ in range(cfg.n_periods)]


def serving_mesh():
    """``(mesh, global rows factor)`` of the active serving scope (a
    scope with cut weights): the mesh, and how many ranks share the
    batch's rows; ``(None, 1)`` without one."""
    scope = PT.active_scope()
    if scope.mesh is None or not scope.cut:
        return None, 1
    return scope.mesh, scope.mesh.size(scope.tokens)


def init_paged_pools(cfg: ArchConfig, n_pages: int, page_size: int,
                     dtype: torch.dtype, device, kv_dtype: str = "f32",
                     mesh=None):
    """Per-layer paged KV pools, periods-stacked: one dict per period
    spec, each leaf ``(n_periods,) + spec shape``.  Every leaf takes its
    own dtype from ``pool_leaf_specs``: ``dtype`` pages for an ``f32``
    pool; int8 pages plus zeroed f32 ``k_scales`` / ``v_scales`` for
    ``int8``.  Page 0 of every pool is the reserved null page.  With a
    ``mesh`` of ``tp > 1`` the page axis is padded to a multiple of tp
    and each rank allocates only its share
    (``partitioning.local_pool_specs``: its KV heads, or its page slab
    and sink page)."""
    check_paged_supported(cfg)
    page_dtype = {v: k for k, v in _DTYPES.items()}[dtype]
    specs = PT.local_pool_specs(
        pool_leaf_specs(n_pages, page_size, cfg.n_kv_heads,
                        cfg.resolved_head_dim, kv_dtype=kv_dtype,
                        page_dtype=page_dtype, tp=PT.mesh_model_tp(mesh)),
        mesh, cfg.n_kv_heads)
    return tuple(
        {name: torch.zeros((cfg.n_periods,) + shape, dtype=_DTYPES[dt],
                           device=device)
         for name, (shape, dt) in specs.items()}
        for _ in cfg.period)


def remat(fn):
    """``fn`` with its activations recomputed in the backward instead of
    saved (``torch.utils.checkpoint``, non-reentrant): the JAX package's
    ``jax.checkpoint``."""
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _apply_stack(params: Params, x: Tensor, cfg: ArchConfig, run: RunConfig,
                 make_cache, *, policy: SoftmaxPolicy | None = None,
                 collector=None, train: bool = False):
    """Run every layer, periods outermost as the JAX package's scan does;
    ``make_cache(spec_index, period_index)`` gives a layer's cache (a
    lockstep cache, or a paged cache over views of its pools, written in
    place; None in training).  ``policy`` defaults to the run's.
    Returns ``x``, or with ``train`` ``(x, load_balance_loss)`` — the
    MoE blocks' sum, None without one — each period under
    :func:`remat` when ``run.remat`` and no collector is given."""
    policy = policy or run.softmax_policy

    def period(x, pi):
        lb = None
        for si, spec in enumerate(cfg.period):
            pp = PT.use_leaves(params["periods"][si], f"periods/{si}", pi)
            x, aux = apply_block(pp, x, cfg, run, spec, policy=policy,
                                 cache=make_cache(si, pi),
                                 collector=collector, return_aux=train,
                                 path=f"periods/{si}")
            if "load_balance_loss" in aux:
                lb = aux["load_balance_loss"] + (0 if lb is None else lb)
        return x, lb

    if train and run.remat and collector is None:
        period = remat(PT.keep_scope(period))
    lb_total = None
    for pi in range(cfg.n_periods):
        x, lb = period(x, pi)
        if lb is not None:
            lb_total = lb if lb_total is None else lb_total + lb
    return (x, lb_total) if train else x


def _head(params: Params, cfg: ArchConfig, x: Tensor) -> Tensor:
    """f32 logits; a head (or tied table) cut over the vocabulary under
    an active mesh gives this rank's columns, gathered over the ranks."""
    x = L.apply_norm(PT.use_leaves(params["final_norm"], "final_norm"), x,
                     cfg.norm_eps)
    mesh = PT.active_scope().model_mesh(
        "embed/table" if cfg.tie_embeddings else "head/w")
    if mesh is not None:
        x = PT.copy_to(x, mesh, site="head.in")
    if cfg.tie_embeddings:
        table = PT.use_leaves(params["embed"], "embed")["table"]
        logits = x.float() @ table.float().T
    else:
        logits = L.apply_lm_head(PT.use_leaves(params["head"], "head"), x)
    if mesh is not None:
        logits = PT.gather_from(logits, mesh, dim=-1, site="head")
    return logits


def _embed(params: Params, tokens: Tensor, cfg: ArchConfig,
           run: RunConfig) -> Tensor:
    return L.apply_embedding(PT.use_leaves(params["embed"], "embed"), tokens,
                             run_dtype(run), path="embed")


def train_logits(params: Params, tokens: Tensor, cfg: ArchConfig,
                 run: RunConfig, collector=None):
    """(B, S) int tokens → ``(logits (B, S, V) f32, aux)`` under the exact
    softmax, no cache; ``aux["load_balance_loss"]`` is the MoE blocks'
    sum (0 without one)."""
    x = _embed(params, tokens, cfg, run)
    x, lb = _apply_stack(params, x, cfg, run, lambda si, pi: None,
                         policy=EXACT, collector=collector, train=True)
    if lb is None:
        lb = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(params, cfg, x), {"load_balance_loss": lb}


def prefill(params: Params, tokens: Tensor, cfg: ArchConfig, run: RunConfig,
            max_len: int, logits: str = "all", collector=None):
    """Fill fresh lockstep caches for the (B, S) prompt; returns
    ``(logits, caches)``.  ``logits='last'`` applies the LM head to the
    final position only; ``collector`` taps every attention's logits."""
    mesh, rows = serving_mesh()
    caches = init_caches(cfg, tokens.shape[0] * rows, max_len,
                         run_dtype(run), tokens.device, mesh=mesh,
                         shard_kv_seq=run.shard_kv_seq)
    x = _embed(params, tokens, cfg, run)
    x = _apply_stack(params, x, cfg, run, lambda si, pi: caches[pi][si],
                     collector=collector)
    if logits == "last":
        x = x[:, -1:]
    return _head(params, cfg, x), caches


def decode_step(params: Params, token: Tensor, caches, cfg: ArchConfig,
                run: RunConfig):
    """One lockstep decode step: token (B, 1) against the caches (updated
    in place); returns ``(logits (B, 1, V), caches)``."""
    x = _embed(params, token, cfg, run)
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
    x = _embed(params, token, cfg, run)

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
    x = _embed(params, tokens, cfg, run)

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
