"""Oracle for the row-wise LUT-softmax kernels.

The counterpart of the JAX package's ``kernels/lut_softmax/ref.py``: it
delegates to ``core.lut_softmax``, the canonical semantics, and exposes
the intermediate integer tensors for stage-by-stage comparisons.  On
rows of finite and ``−inf`` entries the kernels agree with it bit for
bit; on rows holding ``+inf`` or ``NaN`` they take the max over the
finite entries, where ``core`` turns the non-finite max into 0 (see
``lut_softmax.py``).
"""

from __future__ import annotations

import torch

from repro_torch.core import lut_softmax as _core
from repro_torch.core.lut_builder import Lut2DTables, RexpTables

Tensor = torch.Tensor


def rexp_softmax_ref(x: Tensor, tables: RexpTables,
                     index_mode: str = "round") -> Tensor:
    """Row softmax (last axis) via REXP."""
    return _core.softmax_rexp(x, tables, axis=-1, index_mode=index_mode)


def lut2d_softmax_ref(x: Tensor, tables: Lut2DTables,
                      index_mode: str = "round") -> Tensor:
    """Row softmax (last axis) via 2D-LUT."""
    return _core.softmax_lut2d(x, tables, axis=-1, index_mode=index_mode)


def rexp_stages_ref(x: Tensor, tables: RexpTables,
                    index_mode: str = "round"):
    """Intermediate integer tensors (e_int, S, α_int, σ_int)."""
    e_int = _core.rexp_exp_int(x, tables, axis=-1, index_mode=index_mode)
    s = torch.sum(e_int.float(), dim=-1, keepdim=True)
    idx_a = _core.rexp_alpha_index(s, tables, index_mode)
    alpha = torch.as_tensor(tables.lut_alpha, dtype=torch.int32,
                            device=x.device)[idx_a]
    sigma_int = torch.round((e_int * alpha).float()
                            / tables.precision.qmax).to(torch.int32)
    return e_int, s, alpha, sigma_int
