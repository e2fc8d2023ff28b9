"""The port's copies of the LUT builders against the JAX package's.

``repro_torch.core`` keeps its own copies of ``precision``, ``policies``
and ``lut_builder`` (importing ``repro.core`` would pull in JAX); every
table must be byte-equal to the original, and the size accounting and
the integer-Σ overflow bound must agree.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import lut_builder as J
from repro.core import policies as JP
from repro.core import precision as JPR
from repro_torch.core import lut_builder as T
from repro_torch.core import policies as TP
from repro_torch.core import precision as TPR

torch.set_num_threads(1)

PRECISIONS = sorted(JPR.PRECISIONS)


def _same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("precision", PRECISIONS)
def test_rexp_tables_byte_equal(precision):
    jt, tt = J.build_rexp_tables(precision), T.build_rexp_tables(precision)
    _same_bytes(tt.lut_recip_exp, jt.lut_recip_exp)
    _same_bytes(tt.lut_alpha, jt.lut_alpha)
    assert (tt.nbytes, tt.max_lk) == (jt.nbytes, jt.max_lk)
    for n in (2, 7, 256):
        _same_bytes(T.build_lut_alpha(precision, n),
                    J.build_lut_alpha(precision, n))


@pytest.mark.parametrize("precision", PRECISIONS)
def test_lut2d_tables_byte_equal(precision):
    jt, tt = J.build_lut2d_tables(precision), T.build_lut2d_tables(precision)
    _same_bytes(tt.lut_exp, jt.lut_exp)
    _same_bytes(tt.lut_sigma, jt.lut_sigma)
    assert (tt.exp_step, tt.scale_ex, tt.scale_sum) == \
        (jt.exp_step, jt.scale_ex, jt.scale_sum)
    assert (tt.nbytes, tt.max_lk) == (jt.nbytes, jt.max_lk)
    _same_bytes(T.build_lut_exp(precision, 0.05, 33),
                J.build_lut_exp(precision, 0.05, 33))
    _same_bytes(T.build_lut_sigma(precision, 5, 9),
                J.build_lut_sigma(precision, 5, 9))


@pytest.mark.parametrize("precision", PRECISIONS)
def test_census_and_overflow_bound_agree(precision):
    for build_t, build_j in ((T.build_rexp_tables, J.build_rexp_tables),
                             (T.build_lut2d_tables, J.build_lut2d_tables)):
        assert T.table_census(build_t(precision)) == \
            J.table_census(build_j(precision))
    p_t, p_j = TPR.get_precision(precision), JPR.get_precision(precision)
    assert dataclasses.astuple(p_t) == dataclasses.astuple(p_j)
    assert (p_t.qmax, p_t.max_lk, p_t.x_q, p_t.lut_recip_exp_len) == \
        (p_j.qmax, p_j.max_lk, p_j.x_q, p_j.lut_recip_exp_len)
    assert p_t.max_lk == (1 << 24) // p_t.qmax
    bound = p_t.max_lk
    T.build_rexp_tables(precision, max_context=bound)
    for build in (T.build_rexp_tables, T.build_lut2d_tables):
        with pytest.raises(ValueError, match="overflow"):
            build(precision, max_context=bound + 1)


def test_uint8_lut2d_census_is_761_bytes():
    """The paper's "~700 Bytes" claim, as the JAX package ledgers it."""
    assert T.table_census(T.build_lut2d_tables("uint8"))["lut_bytes"] == 761


def test_constants_and_policy_copy():
    assert (TPR.F32_EXACT_LIMIT, TPR.INT32_LIMIT, TPR.SIGMA_ACC_LIMIT) == \
        (JPR.F32_EXACT_LIMIT, JPR.INT32_LIMIT, JPR.SIGMA_ACC_LIMIT)
    assert T.LUT_BYTE_BUDGET == J.LUT_BYTE_BUDGET
    assert [f.name for f in dataclasses.fields(TP.SoftmaxPolicy)] == \
        [f.name for f in dataclasses.fields(JP.SoftmaxPolicy)]
    assert dataclasses.asdict(TP.EXACT) == dataclasses.asdict(JP.EXACT)
    with pytest.raises(ValueError):
        TPR.get_precision("int3")
