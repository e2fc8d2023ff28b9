"""Precision registry for LUT-based softmax approximation.

The paper (Table 5 / Table 8) evaluates four precisions.  ``w`` is the
number of *value* bits per LUT entry; the quantization ceiling is
``qmax = 2**w - 1`` (the paper's ``prec`` constant; note the paper's A.2
text mentions ``scale = 32768`` for int16 — we use the consistent
``2**w - 1`` everywhere and record the discrepancy in DESIGN.md).

All integer LUT arithmetic is carried in int32: the widest product is
``(2**15 - 1)**2 < 2**30``, safely inside int32.
"""

from __future__ import annotations

import dataclasses
import math


# ---------------------------------------------------------------------------
# Integer-Σ accumulator range (the overflow-proof constants)
# ---------------------------------------------------------------------------

#: f32 represents every integer up to 2^24 exactly; past it, integer
#: accumulation silently loses low bits.
F32_EXACT_LIMIT = 1 << 24

#: largest int32 — the width a hardware integer Σ accumulator would carry.
INT32_LIMIT = (1 << 31) - 1

#: The binding Σ-accumulator ceiling.  The reference semantics
#: (``core.lut_softmax``) and both CUDA paged kernels accumulate the
#: integer numerators in f32, so the f32-exact limit binds before int32
#: would: ``Σ e_int ≤ qmax · Lk`` must stay ≤ 2^24 for the integer
#: pipeline to be bit-exact.  ``ServingEngine`` rejects a pool whose
#: context exceeds the per-policy bound derived from this constant;
#: ``lut_builder`` mirrors it at table-build time.
SIGMA_ACC_LIMIT = min(F32_EXACT_LIMIT, INT32_LIMIT)


def sigma_acc_max_lk(qmax: int) -> int:
    """Largest row length Lk with a provably exact integer Σ.

    Worst case every numerator hits the table ceiling ``qmax``, so
    ``Σ e_int ≤ qmax · Lk``; the Σ stays exactly representable (f32) and
    inside int32 iff ``Lk ≤ SIGMA_ACC_LIMIT // qmax``.
    """
    if qmax < 1:
        raise ValueError(f"qmax {qmax} < 1")
    return SIGMA_ACC_LIMIT // qmax


@dataclasses.dataclass(frozen=True)
class Precision:
    """A LUT quantization precision (paper Tables 5 and 8)."""

    name: str
    w: int  # value bits per entry ("BITS PER ENTRY" column)

    @property
    def qmax(self) -> int:
        """Quantization ceiling ``2**w - 1`` (paper's ``prec``)."""
        return (1 << self.w) - 1

    @property
    def max_lk(self) -> int:
        """Largest keys-per-row with a provably exact integer Σ."""
        return sigma_acc_max_lk(self.qmax)

    @property
    def x_q(self) -> int:
        """Efficient quantization boundary ``ceil(ln(2**w - 1))`` (Eq. 4)."""
        return math.ceil(math.log(self.qmax))

    @property
    def lut_recip_exp_len(self) -> int:
        """Length of ``LUT_1/e``: indices ``0 .. x_q + 1`` inclusive (Eq. 4)."""
        return self.x_q + 2


# Paper Table 5 / Table 8, "BITS PER ENTRY" column.
INT16 = Precision("int16", 15)
UINT8 = Precision("uint8", 8)
UINT4 = Precision("uint4", 4)
UINT2 = Precision("uint2", 2)

PRECISIONS: dict[str, Precision] = {p.name: p for p in (INT16, UINT8, UINT4, UINT2)}


def get_precision(name: str | Precision) -> Precision:
    if isinstance(name, Precision):
        return name
    try:
        return PRECISIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown precision {name!r}; expected one of {sorted(PRECISIONS)}"
        ) from None
