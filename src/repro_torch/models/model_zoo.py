"""Uniform model interface over the port's zoo: decoder-only LMs, dense
or MoE (``transformer.py``, ``moe.py``), and the Whisper encoder-decoder
(``encdec.py``)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as TF
from repro_torch.models.convert import cast_params
from repro_torch.models.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Model:
    """cfg + the entry points of the lockstep path and of the paged
    serving engine.

    Unlike the JAX package's steps, which return new caches or pools,
    the steps here update the caches and pools in place (the lockstep
    steps still return them, as the JAX package's do).  Everything runs
    on the card unless the caller passes ``device="cpu"``.  An
    encoder-decoder serves the lockstep path only: its paged methods
    raise, as in the JAX package.
    """

    cfg: ArchConfig
    is_encdec: bool = False

    def init(self, generator: torch.Generator, device="cuda",
             dtype: torch.dtype | None = None):
        """Random f32 parameters drawn from ``generator`` (which must
        live on ``device``), cast to ``dtype`` as ``convert.cast_params``
        casts when it is given (a decoder casts block by block, so its
        f32 weights never exist whole)."""
        device = resolve_device(device)
        if self.is_encdec:
            params = ED.init_params(self.cfg, generator, device)
            return params if dtype is None else cast_params(params, dtype)
        return TF.init_params(self.cfg, generator, device, dtype)

    def prefill(self, params, tokens, run: RunConfig, max_len: int,
                encoder_input=None, logits: str = "all"):
        """Lockstep prefill of (B, S) ``tokens`` into fresh contiguous
        caches of ``max_len`` positions: ``(logits, state)``.  An
        encoder-decoder first encodes ``encoder_input`` (B, L_enc, D)."""
        if self.is_encdec:
            return ED.prefill(params, tokens, self.cfg, run, max_len,
                              encoder_input, logits=logits)
        return TF.prefill(params, tokens, self.cfg, run, max_len,
                          logits=logits)

    def decode_step(self, params, token, state, run: RunConfig):
        """One lockstep decode step: ``(logits (B, 1, V), state)``."""
        if self.is_encdec:
            return ED.decode_step(params, token, state, self.cfg, run)
        return TF.decode_step(params, token, state, self.cfg, run)

    def _check_paged(self, what: str) -> None:
        if self.is_encdec:
            raise NotImplementedError(f"{what}: decoder-only LMs")

    def init_paged_pools(self, n_pages: int, page_size: int, run: RunConfig,
                         device, mesh=None):
        """Per-layer paged KV pools on ``device``: pages of dtype
        ``run.dtype`` (``kv_dtype="f32"``), or int8 pages plus f32 row
        scales (``kv_dtype="int8"``); with a ``mesh``, this rank's
        share."""
        self._check_paged("paged decode")
        return TF.init_paged_pools(self.cfg, n_pages, page_size,
                                   TF.run_dtype(run), device,
                                   kv_dtype=run.kv_dtype, mesh=mesh)

    def decode_step_paged(self, params, token, pools, block_tables, lengths,
                          run: RunConfig, max_kv_len: int | None = None):
        """One decode step against paged pools (per-slot lengths;
        ``max_kv_len`` the host's bound on ``lengths + 1``)."""
        self._check_paged("paged decode")
        return TF.decode_step_paged(params, token, pools, block_tables,
                                    lengths, self.cfg, run, max_kv_len)

    def prefill_chunk_paged(self, params, tokens, pools, block_tables,
                            cache_lens, chunk_lens, run: RunConfig,
                            max_kv_len: int | None = None):
        """One fixed-shape prompt chunk straight into the paged pools
        (``max_kv_len`` the host's bound on ``cache_lens + chunk_lens``)."""
        self._check_paged("paged prefill")
        return TF.prefill_chunk_paged(params, tokens, pools, block_tables,
                                      cache_lens, chunk_lens, self.cfg, run,
                                      max_kv_len)


def build_model(cfg: ArchConfig) -> Model:
    if cfg.encoder_layers:
        return Model(cfg=cfg, is_encdec=True)
    TF.check_paged_supported(cfg)
    return Model(cfg=cfg)
