"""LUT construction — paper Eq. (4), (7), (8) and Tables 5 / 8.

All LUT contents are built offline in float64 and stored as int32 arrays
(value range fits the precision's ``qmax``); the *runtime* never computes
``exp`` or a division when an approximate method is selected.

Construction conventions (validated against the paper's own tables in
``tests/test_lut_builder.py``; ``tests/test_torch_luts.py`` pins this
copy byte-equal to the JAX package's):

* Entries use round-to-nearest (the paper's ``⌊·⌉`` brackets).  With
  rounding, the natural "stop after the first all-zero entry" rule
  reproduces the published ``LUT_1/e`` lengths exactly:
  int16 → 1×13, uint8 → 1×8, uint4 → 1×5, uint2 → 1×3.
* ``LUT_α`` length is a *calibration* parameter ``x_s`` (paper uses
  1×16 for NLP, 1×256/320/512 for DETR, 1×7 for uint2 NLP).  Index 0
  saturates to ``qmax`` (α = 1; correct because max-normalization
  guarantees Σσ* ≥ 1), and the terminal entry is 0 per Eq. (7).
* ``LUT_exp`` / ``LUT_σ`` granularities follow Table 8 defaults
  (step 0.1 × 101 entries for int16/uint8; 11×60 σ-table with
  scale_ex = 0.1, scale_Σ = 1.0, max Σe^x = 60).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.precision import Precision, get_precision, sigma_acc_max_lk

# ---------------------------------------------------------------------------
# Table 8 defaults (NLP experiments) per precision name.
# ---------------------------------------------------------------------------

#: LUT_alpha length (= x_s + 1 entries, indices 0..x_s) per Table 8, NLP.
DEFAULT_ALPHA_LEN = {"int16": 16, "uint8": 16, "uint4": 16, "uint2": 7}

#: (step, length) of the 1-D exp LUT for the 2D-LUT method, per Table 8.
DEFAULT_EXP_TABLE = {
    "int16": (0.1, 101),
    "uint8": (0.1, 101),
    "uint4": (1.0 / 16.0, 48),
    "uint2": (0.25, 12),
}

#: (n_rows, n_cols) of LUT_sigma per Table 8 — rows index the numerator
#: (scale_ex = 0.1 ⇒ 11 rows), cols index the denominator Σe^x
#: (scale_Σ = 1.0 ⇒ cols = max(Σe^x)).
DEFAULT_SIGMA_SHAPE = {
    "int16": (11, 60),
    "uint8": (11, 60),
    "uint4": (11, 29),
    "uint2": (11, 8),
}

#: bytes per entry used by the paper's size accounting (Tables 5 and 8):
#: 2 for int16, 1 for every uint precision (no sub-byte packing counted).
ENTRY_BYTES = {"int16": 2, "uint8": 1, "uint4": 1, "uint2": 1}

SCALE_EX = 0.1  # paper §4.2: scale_{e^x} = 0.1 for all precisions
SCALE_SUM = 1.0  # paper §4.2: scale_Σ = 1.0

#: The paper's headline table budget: every per-policy LUT bundle stays
#: within 1.5 KB (Table 8 tops out at the int16 2D-LUT pair; the uint8
#: bundle is the "~700 Bytes" abstract claim).  The CUDA kernels copy a
#: bundle into shared memory, so this also bounds their table footprint.
LUT_BYTE_BUDGET = 1536


def _check_max_context(tables: "RexpTables | Lut2DTables",
                       max_context: int | None) -> None:
    """Build-time mirror of the static overflow proof.

    A table bundle destined for an engine whose pool admits
    ``max_context`` keys per row must satisfy ``qmax · max_context ≤``
    the Σ-accumulator limit — otherwise the integer Σ can overflow (lose
    f32 integer exactness) at full context and the softmax silently
    saturates.  Fail at build, not at token 16M.
    """
    if max_context is None:
        return
    bound = tables.max_lk
    if max_context > bound:
        raise ValueError(
            f"{type(tables).__name__}({tables.precision.name}): "
            f"max_context {max_context} exceeds the integer-Σ overflow "
            f"bound max_lk={bound} (qmax={tables.precision.qmax}); use a "
            f"narrower precision or a smaller context")


def _round_half_even(x: np.ndarray | float) -> np.ndarray:
    """Round-to-nearest-even, matching the paper's published table sizes."""
    return np.rint(np.asarray(x, dtype=np.float64))


# ---------------------------------------------------------------------------
# REXP method tables (Eq. 4 and Eq. 7)
# ---------------------------------------------------------------------------


def build_lut_recip_exp(precision: str | Precision) -> np.ndarray:
    """``LUT_1/e[i] = round(e^{-i} · qmax)`` for i = 0..x_q+1 (Eq. 4).

    Trailing entries past the first zero are dropped — with rounding this
    reproduces the exact published lengths (1×13 / 1×8 / 1×5 / 1×3).
    """
    p = get_precision(precision)
    vals = []
    for i in range(p.x_q + 2):
        v = int(_round_half_even(math.exp(-i) * p.qmax))
        vals.append(v)
        if v == 0:
            break
    return np.asarray(vals, dtype=np.int32)


def build_lut_alpha(precision: str | Precision, length: int | None = None) -> np.ndarray:
    """``LUT_α[j] = round(qmax / j)`` for j = 1..x_s−1; entry 0 = qmax; last = 0.

    ``length`` = x_s + 1 total entries (paper Table 5: 256/320/512 for DETR;
    Table 8: 16 for NLP).  Entry 0 saturates to qmax (α = 1) because
    max-normalization guarantees Σσ* ≥ 1 so index 0 only fires when the
    integer sum rounds down to ~1.  Terminal entry is 0 per Eq. (7).
    """
    p = get_precision(precision)
    if length is None:
        length = DEFAULT_ALPHA_LEN[p.name]
    if length < 2:
        raise ValueError(f"LUT_alpha needs >= 2 entries, got {length}")
    lut = np.zeros(length, dtype=np.int32)
    lut[0] = p.qmax
    for j in range(1, length):
        lut[j] = int(_round_half_even(p.qmax / j))
    lut[length - 1] = 0  # LUT_α[x_s] = 0 (saturation per Eq. 7)
    return lut


# ---------------------------------------------------------------------------
# 2D-LUT method tables (LUT_exp and Eq. 8)
# ---------------------------------------------------------------------------


def build_lut_exp(
    precision: str | Precision,
    step: float | None = None,
    length: int | None = None,
) -> np.ndarray:
    """1-D exp table: ``LUT_exp[n] = round(e^{-n·step} · qmax)``.

    Covers normalized inputs x ∈ [−step·(length−1), 0]; indices past the
    end clamp to the final entry (which is ≈ 0 at the default lengths).
    """
    p = get_precision(precision)
    dstep, dlen = DEFAULT_EXP_TABLE[p.name]
    step = dstep if step is None else step
    length = dlen if length is None else length
    n = np.arange(length, dtype=np.float64)
    return _round_half_even(np.exp(-n * step) * p.qmax).astype(np.int32)


def build_lut_sigma(
    precision: str | Precision,
    n_rows: int | None = None,
    n_cols: int | None = None,
    scale_ex: float = SCALE_EX,
    scale_sum: float = SCALE_SUM,
) -> np.ndarray:
    """2-D softmax table (Eq. 8).

    ``LUT_σ[i][j-1] = round( (i·scale_ex) / (j·scale_Σ) · qmax )`` clipped to
    qmax, for i = 0..n_rows−1 (numerator e^x bins) and j = 1..n_cols
    (denominator Σe^x bins; j ≥ 1 always holds after max-normalization).
    Stored with the j axis shifted down by one so column 0 ↔ j = 1.
    """
    p = get_precision(precision)
    drows, dcols = DEFAULT_SIGMA_SHAPE[p.name]
    n_rows = drows if n_rows is None else n_rows
    n_cols = dcols if n_cols is None else n_cols
    i = np.arange(n_rows, dtype=np.float64)[:, None] * scale_ex
    j = (np.arange(n_cols, dtype=np.float64)[None, :] + 1.0) * scale_sum
    vals = _round_half_even(i / j * p.qmax)
    return np.clip(vals, 0, p.qmax).astype(np.int32)


# ---------------------------------------------------------------------------
# Bundles
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class RexpTables:
    """LUT bundle for the REXP method (Algorithm 1).  Compared and hashed
    by identity, so a bundle can key the kernels' device-table cache."""

    precision: Precision
    lut_recip_exp: np.ndarray  # 1-D, int32
    lut_alpha: np.ndarray  # 1-D, int32

    @property
    def nbytes(self) -> int:
        """Size accounting used by paper Tables 5 / 8 (entries × entry bytes)."""
        eb = ENTRY_BYTES[self.precision.name]
        return (self.lut_recip_exp.size + self.lut_alpha.size) * eb

    @property
    def max_lk(self) -> int:
        """Integer-Σ overflow bound: max keys per softmax row."""
        return sigma_acc_max_lk(self.precision.qmax)

    def __repr__(self) -> str:
        return (f"RexpTables({self.precision.name}, "
                f"lut_recip_exp=1x{self.lut_recip_exp.size}, "
                f"lut_alpha=1x{self.lut_alpha.size}, "
                f"nbytes={self.nbytes}, max_lk={self.max_lk})")


@dataclasses.dataclass(frozen=True, eq=False)
class Lut2DTables:
    """LUT bundle for the 2D-LUT method (Algorithm 2).  Compared and
    hashed by identity, as :class:`RexpTables`."""

    precision: Precision
    lut_exp: np.ndarray  # 1-D, int32
    lut_sigma: np.ndarray  # 2-D, int32, shape (n_rows, n_cols); col 0 ↔ j=1
    exp_step: float
    scale_ex: float = SCALE_EX
    scale_sum: float = SCALE_SUM

    @property
    def nbytes(self) -> int:
        eb = ENTRY_BYTES[self.precision.name]
        return (self.lut_exp.size + self.lut_sigma.size) * eb

    @property
    def max_lk(self) -> int:
        """Integer-Σ overflow bound: max keys per softmax row."""
        return sigma_acc_max_lk(self.precision.qmax)

    def __repr__(self) -> str:
        r, c = self.lut_sigma.shape
        return (f"Lut2DTables({self.precision.name}, "
                f"lut_exp=1x{self.lut_exp.size}, lut_sigma={r}x{c}, "
                f"exp_step={self.exp_step}, "
                f"nbytes={self.nbytes}, max_lk={self.max_lk})")


def build_rexp_tables(
    precision: str | Precision, alpha_len: int | None = None,
    *, max_context: int | None = None,
) -> RexpTables:
    """``max_context`` (when known, e.g. the engine pool's) asserts the
    integer-Σ overflow bound at build time — see :func:`_check_max_context`."""
    p = get_precision(precision)
    t = RexpTables(
        precision=p,
        lut_recip_exp=build_lut_recip_exp(p),
        lut_alpha=build_lut_alpha(p, alpha_len),
    )
    _check_max_context(t, max_context)
    return t


def build_lut2d_tables(
    precision: str | Precision,
    exp_step: float | None = None,
    exp_len: int | None = None,
    n_rows: int | None = None,
    n_cols: int | None = None,
    *, max_context: int | None = None,
) -> Lut2DTables:
    """``max_context`` (when known, e.g. the engine pool's) asserts the
    integer-Σ overflow bound at build time — see :func:`_check_max_context`."""
    p = get_precision(precision)
    dstep, _ = DEFAULT_EXP_TABLE[p.name]
    step = dstep if exp_step is None else exp_step
    t = Lut2DTables(
        precision=p,
        lut_exp=build_lut_exp(p, step, exp_len),
        lut_sigma=build_lut_sigma(p, n_rows, n_cols),
        exp_step=step,
    )
    _check_max_context(t, max_context)
    return t


def table_census(tables: RexpTables | Lut2DTables) -> dict:
    """Machine-readable table metadata (the kernel guard's LUT census).

    Per-table entry counts and bytes under the paper's accounting
    (entries × :data:`ENTRY_BYTES`), plus the derived overflow bound.
    """
    eb = ENTRY_BYTES[tables.precision.name]
    if isinstance(tables, RexpTables):
        per = {"lut_recip_exp": tables.lut_recip_exp.size * eb,
               "lut_alpha": tables.lut_alpha.size * eb}
    else:
        per = {"lut_exp": tables.lut_exp.size * eb,
               "lut_sigma": tables.lut_sigma.size * eb}
    return {"precision": tables.precision.name,
            "qmax": tables.precision.qmax,
            "entry_bytes": eb,
            "tables": per,
            "lut_bytes": tables.nbytes,
            "max_lk": tables.max_lk}
