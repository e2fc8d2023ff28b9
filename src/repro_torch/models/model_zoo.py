"""Uniform model interface over the port's zoo (decoder-only LMs)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.models import transformer as TF


def resolve_device(device) -> torch.device:
    """``cuda`` unless the caller asks for the CPU; a CUDA device that is
    not there raises (the port never carries on on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' "
            "to run its plain PyTorch versions on the CPU")
    return device


@dataclasses.dataclass(frozen=True)
class Model:
    """cfg + the entry points of the lockstep path and of the paged
    serving engine.

    Unlike the JAX package's steps, which return new caches or pools,
    the steps here update the caches and pools in place (the lockstep
    steps still return them, as the JAX package's do).  Everything runs
    on the card unless the caller passes ``device="cpu"``.
    """

    cfg: ArchConfig

    def init(self, generator: torch.Generator, device="cuda"):
        """Random f32 parameters drawn from ``generator`` (which must
        live on ``device``)."""
        return TF.init_params(self.cfg, generator, resolve_device(device))

    def prefill(self, params, tokens, run: RunConfig, max_len: int,
                logits: str = "all"):
        """Lockstep prefill of (B, S) ``tokens`` into fresh contiguous
        caches of ``max_len`` positions: ``(logits, caches)``."""
        return TF.prefill(params, tokens, self.cfg, run, max_len,
                          logits=logits)

    def decode_step(self, params, token, state, run: RunConfig):
        """One lockstep decode step: ``(logits (B, 1, V), caches)``."""
        return TF.decode_step(params, token, state, self.cfg, run)

    def init_paged_pools(self, n_pages: int, page_size: int, run: RunConfig,
                         device):
        """Per-layer paged KV pools on ``device``: pages of dtype
        ``run.dtype`` (``kv_dtype="f32"``), or int8 pages plus f32 row
        scales (``kv_dtype="int8"``)."""
        return TF.init_paged_pools(self.cfg, n_pages, page_size,
                                   TF.run_dtype(run), device,
                                   kv_dtype=run.kv_dtype)

    def decode_step_paged(self, params, token, pools, block_tables, lengths,
                          run: RunConfig):
        """One decode step against paged pools (per-slot lengths)."""
        return TF.decode_step_paged(params, token, pools, block_tables,
                                    lengths, self.cfg, run)

    def prefill_chunk_paged(self, params, tokens, pools, block_tables,
                            cache_lens, chunk_lens, run: RunConfig):
        """One fixed-shape prompt chunk straight into the paged pools."""
        return TF.prefill_chunk_paged(params, tokens, pools, block_tables,
                                      cache_lens, chunk_lens, self.cfg, run)


def build_model(cfg: ArchConfig) -> Model:
    TF.check_paged_supported(cfg)
    return Model(cfg=cfg)
