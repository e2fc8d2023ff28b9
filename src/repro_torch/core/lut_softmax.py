"""LUT-based softmax approximation — paper Algorithms 1 and 2, in torch.

The port's copy of the *reference semantics* (``repro.core.lut_softmax``
in the JAX package): on the same f32 logits every function here returns
the same bits as its JAX counterpart (``tests/test_torch_lut_softmax.py``
pins this), and the CUDA paged kernels reproduce the same integer
pipeline (bins, ``e_int``, Σ, ``σ_int``) element by element.

Integer semantics
-----------------
* REXP (Algorithm 1)::

      d_i     = max(x) − x_i                      (≥ 0)
      e_i     = LUT_1/e[ bin(d_i) ]               (int, ≤ qmax)
      S       = Σ_j e_j                           (int accumulate)
      α       = LUT_α[ clamp(bin(S / qmax)) ]     (int, ≤ qmax)
      σ_int_i = round(e_i · α / qmax)
      σ_i     = σ_int_i / qmax

* 2D-LUT (Algorithm 2)::

      e_i     = LUT_exp[ bin(d_i / step) ]
      S       = Σ_j e_j
      i-idx   = clamp(bin(e_i / (qmax·scale_ex)))
      j-idx   = clamp(bin(S / (qmax·scale_Σ)), 1, C)
      σ_i     = LUT_σ[i-idx][j-idx − 1] / qmax

``bin`` is round half to even (``index_mode="round"``, ``torch.round``)
or truncation (``"floor"``).  Divisions by table constants are
multiplies by the f32 reciprocal (:func:`inv_scale`), exactly as in the
JAX package.  Sums are accumulated in f32, exact below 2^24.  A bin is
clamped while still a float and only then converted to an integer: that
equals XLA's saturating float→int conversion followed by the clip, where
a plain ``.to(torch.int32)`` of a huge value would wrap.

Masking: ``−inf`` logits contribute a hard 0 (never the terminal LUT
entry), and fully-masked rows give all-zero rows rather than NaN.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lut_builder import Lut2DTables, RexpTables

Tensor = torch.Tensor


def _bin_index(v: Tensor, index_mode: str, lo: int, hi: int) -> Tensor:
    """Clamped piecewise-constant bin index of a float value (int64)."""
    if index_mode == "round":
        r = torch.round(v)
    elif index_mode == "floor":
        r = torch.floor(v)
    else:
        raise ValueError(f"unknown index_mode {index_mode!r}")
    return torch.clamp(r, lo, hi).long()


def inv_scale(denom: float) -> float:
    """The f32 reciprocal ``1/denom`` as a Python float.

    The value is exactly representable in f32, so ``x * inv_scale(c)`` on
    an f32 tensor is the same single f32 multiply the JAX package and the
    CUDA kernels perform (an f32×f32 product is exact in double, so the
    single rounding to f32 is the same whichever precision torch uses).
    """
    return float(np.float32(1.0 / denom))


def _masked_max(x: Tensor, axis: int) -> Tensor:
    """Row max that is safe for fully-masked (-inf) rows."""
    m = torch.amax(x, dim=axis, keepdim=True)
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def softmax_exact(x: Tensor, axis: int = -1) -> Tensor:
    """Eq. (2): numerically-stable exact softmax."""
    x = x.float()
    m = _masked_max(x, axis)
    e = torch.where(torch.isfinite(x), torch.exp(x - m), torch.zeros_like(x))
    s = torch.sum(e, dim=axis, keepdim=True)
    return e / torch.clamp(s, min=torch.finfo(torch.float32).tiny)


def _lut(table: np.ndarray, like: Tensor) -> Tensor:
    return torch.as_tensor(np.asarray(table, np.int32), device=like.device)


def rexp_exp_int(x: Tensor, tables: RexpTables, axis: int = -1,
                 index_mode: str = "round") -> Tensor:
    """Integer numerator ``e_int = LUT_1/e[bin(max(x) − x)]`` (int32)."""
    x = x.float()
    lut = _lut(tables.lut_recip_exp, x)
    n = lut.shape[0]
    finite = torch.isfinite(x)
    d = _masked_max(x, axis) - x
    idx = _bin_index(torch.where(finite, d, torch.full_like(d, n - 1)),
                     index_mode, 0, n - 1)
    return torch.where(finite, lut[idx], torch.zeros((), dtype=lut.dtype,
                                                     device=x.device))


def rexp_alpha_index(s: Tensor, tables: RexpTables,
                     index_mode: str = "round") -> Tensor:
    """α-table index: ``clamp(bin(S / qmax), 0, x_s)`` (Algorithm 1 line 9)."""
    n_alpha = tables.lut_alpha.shape[0]
    return _bin_index(s.float() * inv_scale(tables.precision.qmax),
                      index_mode, 0, n_alpha - 1)


def softmax_rexp(x: Tensor, tables: RexpTables, axis: int = -1,
                 index_mode: str = "round") -> Tensor:
    """Algorithm 1 (REXP), vectorized over ``axis``.  Returns f32 in [0, 1]."""
    qmax = tables.precision.qmax
    e_int = rexp_exp_int(x, tables, axis, index_mode)
    s = torch.sum(e_int.float(), dim=axis, keepdim=True)  # exact below 2^24
    alpha_int = _lut(tables.lut_alpha, x)[rexp_alpha_index(s, tables,
                                                           index_mode)]
    prod = e_int * alpha_int  # int32; ≤ qmax² < 2^30
    inv = inv_scale(qmax)
    sigma_int = torch.round(prod.float() * inv)
    return sigma_int * inv


def lut2d_exp_int(x: Tensor, tables: Lut2DTables, axis: int = -1,
                  index_mode: str = "round") -> Tensor:
    """Integer numerator via the 1-D exp table (Algorithm 2 lines 4-7)."""
    x = x.float()
    lut = _lut(tables.lut_exp, x)
    n = lut.shape[0]
    finite = torch.isfinite(x)
    d = _masked_max(x, axis) - x
    scaled = torch.where(finite, d * inv_scale(tables.exp_step),
                         torch.full_like(d, n - 1))
    idx = _bin_index(scaled, index_mode, 0, n - 1)
    return torch.where(finite, lut[idx], torch.zeros((), dtype=lut.dtype,
                                                     device=x.device))


def softmax_lut2d(x: Tensor, tables: Lut2DTables, axis: int = -1,
                  index_mode: str = "round") -> Tensor:
    """Algorithm 2 (2D LUT), vectorized over ``axis``.  Returns f32 in [0, 1]."""
    qmax = tables.precision.qmax
    lut_sigma = _lut(tables.lut_sigma, x)
    n_rows, n_cols = lut_sigma.shape
    e_int = lut2d_exp_int(x, tables, axis, index_mode)
    s = torch.sum(e_int.float(), dim=axis, keepdim=True)
    i_idx = _bin_index(e_int.float() * inv_scale(qmax * tables.scale_ex),
                       index_mode, 0, n_rows - 1)
    # column j = bin(S_real / scale_Σ) ∈ [1, n_cols], stored shifted
    # (col 0 ↔ j = 1)
    j_idx = _bin_index(s * inv_scale(qmax * tables.scale_sum), index_mode,
                       1, n_cols) - 1
    lin = i_idx * n_cols + j_idx.expand_as(i_idx)
    return lut_sigma.reshape(-1)[lin].float() * inv_scale(qmax)
