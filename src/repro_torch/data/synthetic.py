"""Deterministic, resumable synthetic LM data pipeline.

A copy of the JAX package's ``data/synthetic.py`` (numpy only), so the
port draws byte-for-byte the same batches for every seed and step.

Every batch is a pure function of (seed, step) — Philox counter-based —
so restart-from-checkpoint reproduces the exact token stream with no
iterator state to save (the checkpoint step IS the data cursor).  This is
the property fault-tolerant training needs: bit-exact resume.

Two generators:
  * ``uniform``  — iid tokens (throughput tests).
  * ``markov``   — a fixed random first-order process with per-state
    successor sets; has real learnable structure so training-loss curves
    and exact-vs-LUT eval deltas are meaningful (the end-to-end paper
    validation trains on this).

Per-host sharding: each host materializes only its slice of the global
batch (``host_slice``), indexed so the global stream is independent of
host count — elastic re-scaling does not change the data.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "markov"   # 'markov' | 'uniform'
    branching: int = 8     # successors per state (markov)


def _philox(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=cfg.seed, counter=step))


def _successor_table(cfg: DataConfig) -> np.ndarray:
    """(V, branching) fixed successor sets — derived from seed only."""
    rng = np.random.Generator(np.random.Philox(key=cfg.seed ^ 0xA5A5A5))
    return rng.integers(0, cfg.vocab_size,
                        size=(cfg.vocab_size, cfg.branching), dtype=np.int32)


class SyntheticDataset:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._succ = _successor_table(cfg) if cfg.kind == "markov" else None

    def batch(self, step: int, host_slice: slice | None = None) -> np.ndarray:
        """(batch, seq_len + 1) int32 — inputs are [:, :-1], labels [:, 1:]."""
        cfg = self.cfg
        rng = _philox(cfg, step)
        b, s = cfg.global_batch, cfg.seq_len + 1
        if cfg.kind == "uniform":
            out = rng.integers(0, cfg.vocab_size, size=(b, s), dtype=np.int32)
        else:
            # vectorized markov walk: choice index stream + successor table
            choices = rng.integers(0, cfg.branching, size=(b, s),
                                   dtype=np.int32)
            out = np.empty((b, s), dtype=np.int32)
            out[:, 0] = rng.integers(0, cfg.vocab_size, size=b,
                                     dtype=np.int32)
            succ = self._succ
            for t in range(1, s):
                out[:, t] = succ[out[:, t - 1], choices[:, t]]
        if host_slice is not None:
            out = out[host_slice]
        return out

    def batches(self, start_step: int = 0):
        step = start_step
        while True:
            yield step, self.batch(step)
            step += 1
