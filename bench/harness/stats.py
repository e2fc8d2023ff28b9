"""Percentiles of host-clock samples."""

from __future__ import annotations

import numpy as np


def percentile(values, p: float):
    """The ``p``-th percentile (linear between order statistics), None
    without values."""
    values = list(values)
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), p,
                               method="linear"))
