"""Uniform model interface over the port's zoo: decoder-only LMs — dense,
MoE, hybrid or recurrent (``transformer.py``, ``moe.py``, ``ssm.py``) —
and the Whisper encoder-decoder (``encdec.py``)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.models.convert import cast_params
from repro_torch.models.device import resolve_device
from repro_torch.runtime import partitioning as PT


@dataclasses.dataclass(frozen=True)
class Model:
    """cfg + the entry points of the lockstep path and of the paged
    serving engine.

    Unlike the JAX package's steps, which return new caches or pools,
    the steps here update the caches and pools in place (the lockstep
    steps still return them, as the JAX package's do).  Everything runs
    on the card unless the caller passes ``device="cpu"``.  An
    encoder-decoder, and a decoder with a mixer other than attention
    (Jamba, xLSTM), serve the lockstep path only: their paged methods
    raise ``NotImplementedError``, as in the JAX package.
    """

    cfg: ArchConfig
    is_encdec: bool = False

    def init(self, generator: torch.Generator, device="cuda",
             dtype: torch.dtype | None = None, layout=None):
        """Random f32 parameters drawn from ``generator`` (which must
        live on ``device``), cast to ``dtype`` as ``convert.cast_params``
        casts when it is given (a decoder casts block by block, so its
        f32 weights never exist whole); with a ``layout``
        (``partitioning.Layout``) the rank's cut of them (a decoder cuts
        block by block)."""
        device = resolve_device(device)
        if self.is_encdec:
            params = ED.init_params(self.cfg, generator, device)
            params = params if dtype is None else cast_params(params, dtype)
            return params if layout is None else layout.cut(params)
        return TF.init_params(self.cfg, generator, device, dtype, layout)

    def train_logits(self, params, tokens, run: RunConfig,
                     encoder_input=None, collector=None):
        """The training forward of (B, S) ``tokens`` (an encoder-decoder's
        with its frames ``encoder_input``): ``(logits (B, S, V) f32,
        aux)`` under the exact softmax, differentiable."""
        if self.is_encdec:
            return ED.train_logits(params, tokens, self.cfg, run,
                                   encoder_input, collector=collector)
        return TF.train_logits(params, tokens, self.cfg, run,
                               collector=collector)

    def prefill(self, params, tokens, run: RunConfig, max_len: int,
                encoder_input=None, logits: str = "all", collector=None):
        """Lockstep prefill of (B, S) ``tokens`` into fresh contiguous
        caches of ``max_len`` positions: ``(logits, state)``.  An
        encoder-decoder first encodes ``encoder_input`` (B, L_enc, D).
        ``collector`` taps a decoder's attention logits (Σe^x
        calibration); the encoder-decoder takes none."""
        if self.is_encdec:
            if collector is not None:
                raise ValueError("the Σe^x collector taps the decoder-only "
                                 "path's prefill")
            return ED.prefill(params, tokens, self.cfg, run, max_len,
                              encoder_input, logits=logits)
        return TF.prefill(params, tokens, self.cfg, run, max_len,
                          logits=logits, collector=collector)

    def decode_step(self, params, token, state, run: RunConfig):
        """One lockstep decode step: ``(logits (B, 1, V), state)``."""
        if self.is_encdec:
            return ED.decode_step(params, token, state, self.cfg, run)
        return TF.decode_step(params, token, state, self.cfg, run)

    def decode_state_struct(self, b: int, max_len: int, run: RunConfig,
                            mesh=None):
        """The serving state of ``b`` rows and ``max_len`` positions on
        the meta device — shapes and dtypes, nothing allocated (the JAX
        package's ``ShapeDtypeStruct`` tree): ``init_caches``' tree for a
        decoder, ``(self caches, cross K/V pairs)`` for an
        encoder-decoder.  With a ``mesh`` each leaf has this rank's
        shape under ``partitioning.cache_specs`` (``b`` stays the global
        batch), and a cache whose length is cut names its axes."""
        cfg = self.cfg
        dtype = TF.run_dtype(run)
        dh = cfg.resolved_head_dim
        if self.is_encdec:
            caches = [L.AttnCache.zeros(b, cfg.n_kv_heads, max_len, dh,
                                        dtype, "meta")
                      for _ in range(cfg.n_layers)]
            cross = [tuple(torch.empty((b, cfg.n_kv_heads, cfg.encoder_seq,
                                        dh), dtype=dtype, device="meta")
                           for _ in range(2))
                     for _ in range(cfg.n_layers)]
            whole = (caches, cross)
        else:
            whole = TF.init_caches(cfg, b, max_len, dtype, "meta")
        if mesh is None:
            return whole
        return PT.local_state(
            whole, mesh, b, cfg.n_kv_heads, run.shard_kv_seq,
            lambda x, shape, spec: torch.empty(shape, dtype=x.dtype,
                                               device="meta"))

    def check_paged(self, what: str) -> None:
        """Raise ``NotImplementedError`` unless the paged path serves this
        model (a decoder of attention mixers)."""
        if self.is_encdec:
            raise NotImplementedError(f"{what}: decoder-only LMs")
        TF.check_paged_supported(self.cfg)

    def init_paged_pools(self, n_pages: int, page_size: int, run: RunConfig,
                         device, mesh=None):
        """Per-layer paged KV pools on ``device``: pages of dtype
        ``run.dtype`` (``kv_dtype="f32"``), or int8 pages plus f32 row
        scales (``kv_dtype="int8"``); with a ``mesh``, this rank's
        share."""
        self.check_paged("paged decode")
        return TF.init_paged_pools(self.cfg, n_pages, page_size,
                                   TF.run_dtype(run), device,
                                   kv_dtype=run.kv_dtype, mesh=mesh)

    def decode_step_paged(self, params, token, pools, block_tables, lengths,
                          run: RunConfig, max_kv_len: int | None = None):
        """One decode step against paged pools (per-slot lengths;
        ``max_kv_len`` the host's bound on ``lengths + 1``)."""
        self.check_paged("paged decode")
        return TF.decode_step_paged(params, token, pools, block_tables,
                                    lengths, self.cfg, run, max_kv_len)

    def prefill_chunk_paged(self, params, tokens, pools, block_tables,
                            cache_lens, chunk_lens, run: RunConfig,
                            max_kv_len: int | None = None):
        """One fixed-shape prompt chunk straight into the paged pools
        (``max_kv_len`` the host's bound on ``cache_lens + chunk_lens``)."""
        self.check_paged("paged prefill")
        return TF.prefill_chunk_paged(params, tokens, pools, block_tables,
                                      cache_lens, chunk_lens, self.cfg, run,
                                      max_kv_len)


def build_model(cfg: ArchConfig) -> Model:
    if cfg.encoder_layers:
        return Model(cfg=cfg, is_encdec=True)
    TF.check_supported(cfg)
    return Model(cfg=cfg)
