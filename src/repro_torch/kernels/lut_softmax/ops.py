"""Public API of the row-wise LUT softmax.

``lut_softmax(x, policy, axis)`` routes by :class:`SoftmaxPolicy`, as
the JAX package's ``kernels/lut_softmax/ops.py`` does:

* ``use_kernel=False``, or the ``exact`` / ``rexp_unnorm`` /
  ``log2_prior`` impls → ``core.make_softmax_fn`` (the core semantics);
* ``rexp`` / ``lut2d`` with ``use_kernel=True`` → the row kernel over
  the last axis (``axis`` is moved there and back): on CUDA tensors the
  CUDA kernel, which launches or raises; on CPU tensors its plain
  version.

The kernel route takes the row max over the finite entries (the TPU
kernel's semantics), ``make_softmax_fn`` over every entry (the core's):
the two differ only on rows holding ``+inf`` or ``NaN``.
"""

from __future__ import annotations

import torch

from repro_torch.core.lut_softmax import make_softmax_fn
from repro_torch.core.policies import SoftmaxPolicy
from repro_torch.kernels.lut_attention.ops import _tables_for
from repro_torch.kernels.lut_softmax.lut_softmax import (lut2d_softmax_cuda,
                                                         rexp_softmax_cuda)

Tensor = torch.Tensor


def lut_softmax(x: Tensor, policy: SoftmaxPolicy, axis: int = -1) -> Tensor:
    """Softmax under ``policy`` along ``axis`` (kernel or core path)."""
    if not policy.use_kernel or policy.impl in ("exact", "rexp_unnorm",
                                                "log2_prior"):
        return make_softmax_fn(policy)(x, axis=axis)
    if axis not in (-1, x.dim() - 1):
        out = lut_softmax(x.movedim(axis, -1), policy)
        return out.movedim(-1, axis)
    if policy.impl == "rexp":
        return rexp_softmax_cuda(x, _tables_for(policy), policy.index_mode)
    if policy.impl == "lut2d":
        return lut2d_softmax_cuda(x, _tables_for(policy), policy.index_mode)
    raise ValueError(f"unsupported kernel impl {policy.impl!r}")
