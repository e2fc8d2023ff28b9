"""Learning-rate schedules: pure functions of the step, a tensor.

The JAX package's ``optim/schedules.py`` in torch: each schedule maps an
integer step tensor to an f32 learning rate on the step's device, so
the optimizer never reads the step on the host.
"""

from __future__ import annotations

import math

import torch


def linear_warmup_cosine(peak_lr: float, warmup_steps: int,
                         total_steps: int, min_ratio: float = 0.1):
    """Linear warm-up to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``min_ratio · peak_lr`` at ``total_steps``."""
    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)
