"""Whisper-style encoder-decoder backbone (the lockstep serving path).

The counterpart of the JAX package's ``models/encdec.py``.  The audio
conv frontend is a stub, as there: the encoder takes precomputed frame
embeddings (B, L_enc, d_model), the output of Whisper's two conv
layers.  Downstream everything is real: a bidirectional encoder, a
causal decoder with self-attention caches and cross-attention K/V
computed once at prefill, LayerNorm + GELU, biases everywhere.
Sinusoidal positions on both sides, as in the JAX package.

Every attention goes through ``ops.lut_attention`` with
``run.attention_backend``: the encoder's self-attention and the
decoder's cross-attention carry no ``kv_len`` (REXP's fused α form on
the dense kernel), the decoder's cached self-attention does (the
faithful per-element σ).  The self-caches are the port's in-place
:class:`layers.AttnCache`; as in the JAX package they hold K/V in the
run dtype (``run.kv_dtype`` applies to the decoder-only archs).
``train_logits`` runs both stacks with no cache under the exact
softmax, each block under ``transformer.remat`` when ``run.remat``, as
the JAX package's ``jax.checkpoint`` does.

Under a mesh (a training step's or a serving step's scope) the leaves
are a rank's cut, as the decoder-only path's are: every block gathers
its ``'data'`` cuts just before use (``partitioning.use_leaves``), an
attention cut by heads computes the rank's heads (its cross K/V too)
and an MLP cut by hidden units sums over ``'model'``; the serving
self-caches are the rank's cut (``partitioning.cache_specs``).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core.policies import EXACT, SoftmaxPolicy
from repro_torch.models import layers as L
from repro_torch.models.device import resolve_device
from repro_torch.models.transformer import remat, run_dtype, serving_mesh
from repro_torch.runtime import partitioning as PT

Tensor = torch.Tensor
Params = dict[str, Any]


def sinusoidal_positions(length: int, d_model: int, offset: int = 0,
                         device="cuda") -> Tensor:
    """(length, d_model) f32: sin of every angle, then cos; on the card
    unless ``device="cpu"``."""
    device = resolve_device(device)
    pos = offset + torch.arange(length, dtype=torch.float32,
                                device=device)[:, None]
    dim = torch.arange(d_model // 2, dtype=torch.float32,
                       device=device)[None, :]
    angle = pos / torch.pow(10_000.0, 2.0 * dim / d_model)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def _init_attn_block(cfg: ArchConfig, generator: torch.Generator, device,
                     cross: bool) -> Params:
    def attn():
        return L.init_attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.resolved_head_dim, generator, device,
                                with_bias=True)

    p = {
        "norm1": L.init_norm(cfg.d_model, device, with_bias=True),
        "self_attn": attn(),
        "norm_mlp": L.init_norm(cfg.d_model, device, with_bias=True),
        "mlp": L.init_mlp(cfg.d_model, cfg.d_ff, generator, device,
                          gated=False),
    }
    if cross:
        p["norm2"] = L.init_norm(cfg.d_model, device, with_bias=True)
        p["cross_attn"] = attn()
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """Random f32 parameters in the JAX package's tree layout (lists of
    encoder and decoder blocks), drawn from ``generator``; biases zero,
    as the JAX package initializes them; on the card unless
    ``device="cpu"``."""
    device = resolve_device(device)
    return {
        "embed": L.init_embedding(cfg.vocab_size, cfg.d_model, generator,
                                  device),
        "enc_norm": L.init_norm(cfg.d_model, device, with_bias=True),
        "dec_norm": L.init_norm(cfg.d_model, device, with_bias=True),
        "encoder": [_init_attn_block(cfg, generator, device, cross=False)
                    for _ in range(cfg.encoder_layers)],
        "decoder": [_init_attn_block(cfg, generator, device, cross=True)
                    for _ in range(cfg.n_layers)],
        "head": L.init_lm_head(cfg.d_model, cfg.vocab_size, generator,
                               device),
    }


def _attn_kwargs(cfg: ArchConfig, run: RunConfig, policy: SoftmaxPolicy):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, qk_norm=False,
                norm_eps=cfg.norm_eps, rope_theta=None, policy=policy,
                backend=run.attention_backend)


def encode(params: Params, frames: Tensor, cfg: ArchConfig, run: RunConfig,
           policy: SoftmaxPolicy, train: bool = False) -> Tensor:
    """Stub frame embeddings (B, L_enc, D) → encoder states; ``train``
    puts each block under :func:`remat` when ``run.remat``."""
    x = frames + sinusoidal_positions(frames.shape[1], cfg.d_model,
                                      device=frames.device).to(frames.dtype)
    kw = _attn_kwargs(cfg, run, policy)

    def block(blk, x, i):
        blk = PT.use_leaves(blk, f"encoder/{i}")
        h = L.apply_norm(blk["norm1"], x, cfg.norm_eps)
        x = x + L.apply_attention(blk["self_attn"], h, causal=False,
                                  path=f"encoder/{i}/self_attn", **kw)
        h = L.apply_norm(blk["norm_mlp"], x, cfg.norm_eps)
        return x + _mlp(blk["mlp"], h, f"encoder/{i}/mlp")

    if train and run.remat:
        block = remat(PT.keep_scope(block))
    for i, blk in enumerate(params["encoder"]):
        x = block(blk, x, i)
    return L.apply_norm(PT.use_leaves(params["enc_norm"], "enc_norm"), x,
                        cfg.norm_eps)


def _mlp(p: Params, x: Tensor, path: str) -> Tensor:
    """The MLP at ``path``, summed over ``'model'`` when the scope
    computes on its hidden units' cut."""
    return L.apply_mlp(p, x, row_mesh=PT.active_scope().model_mesh(
        f"{path}/w_up"))


def _decoder_pass(params: Params, x: Tensor, cfg: ArchConfig,
                  run: RunConfig, policy: SoftmaxPolicy, caches,
                  cross_kvs, enc: Tensor | None = None) -> Tensor:
    """Every decoder block: causal self-attention (cached, the caches
    advancing in place), cross-attention to the cached encoder K/V, MLP.
    Training passes no caches or K/V (``None`` each) but the encoder
    states ``enc``, and puts each block under :func:`remat` when
    ``run.remat``."""
    kw = _attn_kwargs(cfg, run, policy)

    def block(blk, x, cache, cross_kv, enc, i):
        blk = PT.use_leaves(blk, f"decoder/{i}")
        h = L.apply_norm(blk["norm1"], x, cfg.norm_eps)
        x = x + L.apply_attention(blk["self_attn"], h, causal=True,
                                  cache=cache, path=f"decoder/{i}/self_attn",
                                  **kw)
        h = L.apply_norm(blk["norm2"], x, cfg.norm_eps)
        x = x + L.apply_attention(blk["cross_attn"], h, kv_x=enc,
                                  precomputed_kv=cross_kv,
                                  path=f"decoder/{i}/cross_attn", **kw)
        h = L.apply_norm(blk["norm_mlp"], x, cfg.norm_eps)
        return x + _mlp(blk["mlp"], h, f"decoder/{i}/mlp")

    if enc is not None and run.remat:
        block = remat(PT.keep_scope(block))
    for i, (blk, cache, cross_kv) in enumerate(zip(params["decoder"], caches,
                                                  cross_kvs)):
        x = block(blk, x, cache, cross_kv, enc, i)
    return x


def _embed_dec(params: Params, tokens: Tensor, cfg: ArchConfig, dtype,
               offset: int = 0) -> Tensor:
    x = L.apply_embedding(PT.use_leaves(params["embed"], "embed"), tokens,
                          dtype, path="embed")
    return x + sinusoidal_positions(tokens.shape[1], cfg.d_model, offset,
                                    device=tokens.device).to(dtype)


def _logits(params: Params, x: Tensor, cfg: ArchConfig) -> Tensor:
    """f32 logits; a head cut over the vocabulary gives this rank's
    columns, gathered over ``'model'``."""
    x = L.apply_norm(PT.use_leaves(params["dec_norm"], "dec_norm"), x,
                     cfg.norm_eps)
    head = PT.use_leaves(params["head"], "head")
    mesh = PT.active_scope().model_mesh("head/w")
    if mesh is None:
        return L.apply_lm_head(head, x)
    logits = L.apply_lm_head(head, PT.copy_to(x, mesh, site="head.in"))
    return PT.gather_from(logits, mesh, dim=-1, site="head")


def train_logits(params: Params, tokens: Tensor, cfg: ArchConfig,
                 run: RunConfig, encoder_input: Tensor, collector=None):
    """(B, S) tokens and stub frames (B, L_enc, D) → ``(logits (B, S, V)
    f32, {})`` under the exact softmax, no cache.  ``collector`` is
    accepted and unused, as in the JAX package."""
    dtype = run_dtype(run)
    enc = encode(params, encoder_input.to(dtype), cfg, run, EXACT,
                 train=True)
    x = _embed_dec(params, tokens, cfg, dtype)
    n = len(params["decoder"])
    x = _decoder_pass(params, x, cfg, run, EXACT, [None] * n, [None] * n,
                      enc)
    return _logits(params, x, cfg), {}


def prefill(params: Params, tokens: Tensor, cfg: ArchConfig, run: RunConfig,
            max_len: int, encoder_input: Tensor, logits: str = "all"):
    """Encode ``encoder_input`` (B, L_enc, D), project every decoder
    block's cross K/V once, and fill fresh self-caches of ``max_len``
    positions with the (B, S) prompt.  Returns ``(logits, state)`` with
    state = (self caches, cross K/V); ``logits='last'`` applies the LM
    head to the final position only."""
    dtype = run_dtype(run)
    policy = run.softmax_policy
    enc = encode(params, encoder_input.to(dtype), cfg, run, policy)
    cross_kvs = []
    for i, blk in enumerate(params["decoder"]):
        path = f"decoder/{i}/cross_attn"
        heads = PT.active_scope().model_mesh(f"{path}/wk")
        kvh = cfg.n_kv_heads // (heads.tp if heads is not None else 1)
        attn = PT.use_leaves(blk["cross_attn"], path)
        cross_kvs.append(L.cross_attention_kv(
            attn, enc, n_kv_heads=kvh, head_dim=cfg.resolved_head_dim))
    caches = init_caches(cfg, tokens.shape[0], max_len, dtype, tokens.device,
                         run.shard_kv_seq)
    x = _embed_dec(params, tokens, cfg, dtype)
    x = _decoder_pass(params, x, cfg, run, policy, caches, cross_kvs)
    if logits == "last":
        x = x[:, -1:]
    return _logits(params, x, cfg), (caches, cross_kvs)


def init_caches(cfg: ArchConfig, b: int, max_len: int, dtype, device,
                shard_kv_seq: bool = False):
    """The decoder's zeroed self-caches for ``b`` rows, one a block;
    under a serving scope the rank's cut (``b`` its rows)."""
    mesh, rows = serving_mesh()

    def whole(dev):
        return [L.AttnCache.zeros(b * rows, cfg.n_kv_heads, max_len,
                                  cfg.resolved_head_dim, dtype, dev)
                for _ in range(cfg.n_layers)]

    if mesh is None:
        return whole(device)
    return PT.local_caches(lambda: whole("meta"), mesh, b * rows,
                           cfg.n_kv_heads, shard_kv_seq, device)


def decode_step(params: Params, token: Tensor, state, cfg: ArchConfig,
                run: RunConfig):
    """One lockstep decode step: token (B, 1) against the state (caches
    updated in place); returns ``(logits (B, 1, V), state)``."""
    caches, cross_kvs = state
    x = _embed_dec(params, token, cfg, run_dtype(run),
                   offset=caches[0].length)
    x = _decoder_pass(params, x, cfg, run, run.softmax_policy, caches,
                      cross_kvs)
    return _logits(params, x, cfg), state
