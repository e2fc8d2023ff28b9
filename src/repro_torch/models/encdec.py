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
Training (``train_logits``) is not ported.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core.policies import SoftmaxPolicy
from repro_torch.models import layers as L
from repro_torch.models.device import resolve_device
from repro_torch.models.transformer import run_dtype

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
           policy: SoftmaxPolicy) -> Tensor:
    """Stub frame embeddings (B, L_enc, D) → encoder states."""
    x = frames + sinusoidal_positions(frames.shape[1], cfg.d_model,
                                      device=frames.device).to(frames.dtype)
    kw = _attn_kwargs(cfg, run, policy)
    for blk in params["encoder"]:
        h = L.apply_norm(blk["norm1"], x, cfg.norm_eps)
        x = x + L.apply_attention(blk["self_attn"], h, causal=False, **kw)
        h = L.apply_norm(blk["norm_mlp"], x, cfg.norm_eps)
        x = x + L.apply_mlp(blk["mlp"], h)
    return L.apply_norm(params["enc_norm"], x, cfg.norm_eps)


def _decoder_pass(params: Params, x: Tensor, cfg: ArchConfig,
                  run: RunConfig, policy: SoftmaxPolicy, caches,
                  cross_kvs) -> Tensor:
    """Every decoder block: cached causal self-attention, cross-attention
    to the cached encoder K/V, MLP.  The caches advance in place."""
    kw = _attn_kwargs(cfg, run, policy)
    for blk, cache, cross_kv in zip(params["decoder"], caches, cross_kvs):
        h = L.apply_norm(blk["norm1"], x, cfg.norm_eps)
        x = x + L.apply_attention(blk["self_attn"], h, causal=True,
                                  cache=cache, **kw)
        h = L.apply_norm(blk["norm2"], x, cfg.norm_eps)
        x = x + L.apply_attention(blk["cross_attn"], h,
                                  precomputed_kv=cross_kv, **kw)
        h = L.apply_norm(blk["norm_mlp"], x, cfg.norm_eps)
        x = x + L.apply_mlp(blk["mlp"], h)
    return x


def _embed_dec(params: Params, tokens: Tensor, cfg: ArchConfig, dtype,
               offset: int = 0) -> Tensor:
    x = L.apply_embedding(params["embed"], tokens, dtype)
    return x + sinusoidal_positions(tokens.shape[1], cfg.d_model, offset,
                                    device=tokens.device).to(dtype)


def _logits(params: Params, x: Tensor, cfg: ArchConfig) -> Tensor:
    x = L.apply_norm(params["dec_norm"], x, cfg.norm_eps)
    return L.apply_lm_head(params["head"], x)


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
    cross_kvs = [L.cross_attention_kv(blk["cross_attn"], enc,
                                      n_kv_heads=cfg.n_kv_heads,
                                      head_dim=cfg.resolved_head_dim)
                 for blk in params["decoder"]]
    caches = [L.AttnCache.zeros(tokens.shape[0], cfg.n_kv_heads, max_len,
                                cfg.resolved_head_dim, dtype, tokens.device)
              for _ in params["decoder"]]
    x = _embed_dec(params, tokens, cfg, dtype)
    x = _decoder_pass(params, x, cfg, run, policy, caches, cross_kvs)
    if logits == "last":
        x = x[:, -1:]
    return _logits(params, x, cfg), (caches, cross_kvs)


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
