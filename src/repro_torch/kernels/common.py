"""The paged kernels' per-element LUT pipeline, in plain torch.

The counterpart of the in-kernel helpers of the JAX package's
``kernels/common.py`` (``policy_e_terms``, ``policy_kernel_tables``,
``rexp_sigma``, ``lut2d_sigma_int``).  Given a row's global max ``m``
and global integer Σ, they compute each element's numerator and weight
— the same arithmetic, step for step, as the ``__device__`` functions of
``csrc/lut_pipeline.cuh``, which is what lets a pass-structured kernel
reproduce the row-at-once semantics of ``core.lut_softmax`` bit for bit.
The tests hold these helpers to ``core.lut_softmax``; the CUDA kernels
are held to the plain paged versions on the card.

On a GPU a table read is an indexed load from shared memory, so the
TPU's select-chain / one-hot lookups have no counterpart here: every
read is a gather, which gives the same int32 values.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.core.lut_builder import Lut2DTables, RexpTables
from repro_torch.core.lut_softmax import _bin_index, inv_scale

Tensor = torch.Tensor


def policy_e_terms(s: Tensor, m_row: Tensor, lut_main: Tensor, method: str,
                   exp_step: float, index_mode: str) -> Tensor:
    """Per-element numerators given the global row max ``m_row`` (R,).

    ``s`` (R, C) are masked f32 logits;
    exact  → f32 ``exp(s − m)``;
    rexp   → int  ``LUT_1/e[bin(m − s)]``;
    lut2d  → int  ``LUT_exp[bin((m − s)/step)]``.
    Masked (−inf) logits yield hard zeros, never the terminal LUT entry.
    """
    finite = torch.isfinite(s)
    if method == "exact":
        return torch.where(finite, torch.exp(s - m_row[:, None]),
                           torch.zeros_like(s))
    n = lut_main.shape[0]
    d = m_row[:, None] - s
    if method == "lut2d":
        d = d * inv_scale(exp_step)
    d = torch.where(finite, d, torch.full_like(d, n - 1))
    e = lut_main[_bin_index(d, index_mode, 0, n - 1)]
    return torch.where(finite, e, torch.zeros_like(e))


def policy_kernel_tables(method: str, tables):
    """The kernels' LUT operands: ``(lut_main, lut_aux, exp_step, qmax,
    scale_ex, scale_sum)``.

    ``lut_main`` is 1-D (``LUT_1/e`` or ``LUT_exp``), ``lut_aux`` 2-D
    (``LUT_α`` as one row, or ``LUT_σ``); ``exact`` passes 1-entry
    placeholders through the same signature so every policy shares one
    launch.  Both are int32 numpy arrays: the wrappers move them to the
    device once per policy.
    """
    if method == "rexp":
        assert isinstance(tables, RexpTables)
        return (np.asarray(tables.lut_recip_exp, np.int32),
                np.asarray(tables.lut_alpha, np.int32)[None, :],
                1.0, tables.precision.qmax, 0.0, 0.0)
    if method == "lut2d":
        assert isinstance(tables, Lut2DTables)
        return (np.asarray(tables.lut_exp, np.int32),
                np.asarray(tables.lut_sigma, np.int32),
                tables.exp_step, tables.precision.qmax,
                tables.scale_ex, tables.scale_sum)
    if method == "exact":
        return (np.zeros((1,), np.int32), np.zeros((1, 1), np.int32),
                1.0, 1, 0.0, 0.0)
    raise ValueError(f"unsupported paged-kernel method {method!r}")


#: the CUDA kernels' method and input-type codes: the LUT-attention kernels
#: take f32/bf16, the row-wise softmax and flash attention f16 as well
KERNEL_METHODS = {"exact": 0, "rexp": 1, "lut2d": 2}
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
FLOAT_DTYPES = {**KERNEL_DTYPES, torch.float16: 2}


def shapes_only(t: Tensor) -> bool:
    """Whether ``t`` carries shapes only — a fake tensor
    (``FakeTensorMode``, the dry run's) or one on the meta device — so a
    kernel's wrapper gives an output of the kernel's shape and dtype and
    runs nothing: no plain version, no build, no launch."""
    return t.is_meta or is_fake(t)


@functools.lru_cache(maxsize=64)
def kernel_tables(method: str, tables, index_mode: str,
                  device: torch.device):
    """The LUT operands of ``method`` on ``device`` plus the scalar kernel
    arguments (method, round mode, the f32 reciprocals) — built once per
    table bundle and device, read-only afterwards.  Every CUDA kernel's
    wrapper takes its tables from here."""
    if method not in KERNEL_METHODS:
        raise ValueError(f"unsupported kernel policy {method!r}")
    if index_mode not in ("round", "floor"):
        raise ValueError(f"unknown index_mode {index_mode!r}")
    (lut_main, lut_aux, exp_step, qmax, scale_ex,
     scale_sum) = policy_kernel_tables(method, tables)
    main = torch.as_tensor(np.ascontiguousarray(lut_main), device=device)
    aux = torch.as_tensor(np.ascontiguousarray(lut_aux), device=device)
    ints = (main.numel(), aux.shape[0], aux.shape[1], KERNEL_METHODS[method],
            int(index_mode == "round"))
    floats = (inv_scale(exp_step), inv_scale(qmax),
              inv_scale(qmax * scale_ex) if scale_ex else 0.0,
              inv_scale(qmax * scale_sum) if scale_sum else 0.0)
    return main, aux, ints, floats


def rexp_sigma(e_int: Tensor, s_row: Tensor, lut_alpha: Tensor, qmax: int,
               index_mode: str) -> Tensor:
    """Faithful Algorithm 1 per-element ``σ_int = round(e·α/qmax)`` (f32).

    ``e_int`` (R, C) integer numerators; ``s_row`` (R,) the *global*
    integer Σ of each row (f32-exact).  Callers dequantize by 1/qmax.
    """
    inv = inv_scale(qmax)
    ja = _bin_index(s_row * inv, index_mode, 0, lut_alpha.shape[0] - 1)
    prod = (e_int * lut_alpha[ja][:, None]).float()
    return torch.round(prod * inv)


def lut2d_sigma_int(e_int: Tensor, s_row: Tensor, lut_sigma: Tensor,
                    qmax: int, scale_ex: float, scale_sum: float,
                    index_mode: str) -> Tensor:
    """Algorithm 2 per-element ``σ_int = LUT_σ[i(e), j(S)]`` (int32)."""
    n_rows, n_cols = lut_sigma.shape
    i_idx = _bin_index(e_int.float() * inv_scale(qmax * scale_ex),
                       index_mode, 0, n_rows - 1)
    j_idx = _bin_index(s_row * inv_scale(qmax * scale_sum), index_mode,
                       1, n_cols) - 1
    return lut_sigma[i_idx, j_idx[:, None].expand_as(i_idx)]
