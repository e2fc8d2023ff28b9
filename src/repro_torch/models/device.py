"""Where the port's entry points put their tensors.

One function, :func:`resolve_device`, that every entry point which
allocates (model parameters, positions, converted weights and pools, the
engine, the launcher) passes its ``device`` argument through, so they
share one default: the card.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``cuda`` unless the caller asks for the CPU; a CUDA device that is
    not there raises (the port never carries on on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' "
            "to run its plain PyTorch versions on the CPU")
    return device
