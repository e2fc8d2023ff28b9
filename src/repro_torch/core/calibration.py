"""Σe^x calibration — paper §5.3 / Fig. 4 and the LUT-sizing rule.

The JAX package's ``core/calibration.py`` in torch.  The only
data-dependent quantity of both methods is the range of the softmax
denominator: ``max(Σe^x)`` decides ``x_s`` (REXP's LUT_α length) and
the σ table's column count (2D-LUT).  The paper observes Σe^x ≤ 60 for
NLP attention and a right tail for DETR+DC5 (why those models need a
256 → 512-entry LUT_α).  A :class:`SumCollector` threaded through a
model's ``prefill`` or ``train_logits`` (``collector=``) is offered a
slice of every attention layer's logits; it keeps their per-row Σe^x on
the host, and :meth:`SumCollector.result` histograms them (numpy, as in
the JAX package) and recommends the table sizes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import numpy as np
import torch

Tensor = torch.Tensor


def row_exp_sums(logits: Tensor, axis: int = -1) -> Tensor:
    """Σ_j e^{x_j − max(x)} per softmax row (the Fig. 4 statistic), in
    f32; non-finite entries (a causal mask's −inf) add nothing, and a
    row with a non-finite maximum is shifted by 0."""
    x = logits.float()
    m = torch.amax(x, dim=axis, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(torch.isfinite(x), torch.exp(x - m),
                    torch.zeros_like(x))
    return torch.sum(e, dim=axis)


@dataclasses.dataclass
class CalibrationResult:
    """Aggregated Σe^x statistics across softmax sites."""

    count: int
    mean: float
    p50: float
    p99: float
    p999: float
    max: float
    hist_counts: np.ndarray  # histogram, paper Fig. 4 (bins=50, range=(0,500))
    hist_edges: np.ndarray

    def recommend_alpha_len(self, headroom: float = 1.25) -> int:
        """REXP ``x_s`` + 1: cover p99.9 with headroom (paper §5.3 logic —
        DETR+DC5's right tail is exactly what a too-small LUT_α clips)."""
        return int(np.ceil(self.p999 * headroom)) + 1

    def recommend_sigma_cols(self, headroom: float = 1.25) -> int:
        """2D-LUT column count (scale_Σ = 1.0 ⇒ cols ≈ max Σe^x)."""
        return max(2, int(np.ceil(self.p999 * headroom)))


class SumCollector:
    """Accumulates Σe^x samples streamed out of instrumented models, up
    to ``max_samples`` (later offers are dropped whole or cut)."""

    def __init__(self, max_samples: int = 2_000_000):
        self._chunks: list[np.ndarray] = []
        self._n = 0
        self._max = max_samples

    def offer(self, logits: Tensor, axis: int = -1) -> None:
        if self._n >= self._max:
            return
        s = row_exp_sums(logits, axis).reshape(-1).cpu().numpy()
        take = min(s.size, self._max - self._n)
        self._chunks.append(s[:take])
        self._n += take

    def samples(self) -> np.ndarray:
        """Every Σe^x kept, in the order offered."""
        if not self._chunks:
            raise ValueError("no Σe^x samples collected")
        return np.concatenate(self._chunks)

    def result(self, hist_bins: int = 50,
               hist_range: tuple[float, float] = (0.0, 500.0)
               ) -> CalibrationResult:
        s = self.samples()
        counts, edges = np.histogram(s, bins=hist_bins, range=hist_range)
        return CalibrationResult(
            count=int(s.size),
            mean=float(s.mean()),
            p50=float(np.percentile(s, 50)),
            p99=float(np.percentile(s, 99)),
            p999=float(np.percentile(s, 99.9)),
            max=float(s.max()),
            hist_counts=counts,
            hist_edges=edges,
        )


def calibrate_from_logits(batches: Iterable[Tensor], axis: int = -1,
                          **hist_kw) -> CalibrationResult:
    """One-shot calibration over an iterable of logit tensors."""
    c = SumCollector()
    for b in batches:
        c.offer(b, axis)
    return c.result(**hist_kw)


def calibrate_model(
    apply_fn: Callable[..., Tensor],
    batches: Iterable,
    collector: SumCollector | None = None,
) -> CalibrationResult:
    """Run ``apply_fn(batch, collector=...)`` over batches and aggregate;
    ``apply_fn`` routes the attention logits into the collector (a
    model's ``prefill`` or ``train_logits`` with ``collector=``)."""
    collector = collector or SumCollector()
    for b in batches:
        apply_fn(b, collector=collector)
    return collector.result()
