"""Uniform model interface over the port's zoo (decoder-only LMs)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.models import transformer as TF


@dataclasses.dataclass(frozen=True)
class Model:
    """cfg + the entry points the paged serving engine calls.

    Unlike the JAX package's steps, which return ``(logits, new_pools)``,
    the paged steps here update the pools in place and return the
    logits.
    """

    cfg: ArchConfig

    def init(self, generator: torch.Generator, device="cpu"):
        return TF.init_params(self.cfg, generator, device)

    def init_paged_pools(self, n_pages: int, page_size: int, run: RunConfig,
                         device):
        """Per-layer paged KV pools (dtype ``run.dtype``) on ``device``."""
        if run.kv_dtype != "f32":
            raise NotImplementedError(
                f"kv_dtype {run.kv_dtype!r}: the port has f32 pools only")
        return TF.init_paged_pools(self.cfg, n_pages, page_size,
                                   TF.run_dtype(run), device)

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
