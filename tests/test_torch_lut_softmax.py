"""The port's LUT softmax against the JAX package's, bit for bit.

On the same f32 logits, ``repro_torch.core.lut_softmax`` must return the
same bits as ``repro.core.lut_softmax`` for REXP and 2D-LUT at every
precision and both bin modes: random rows, fully ``-inf`` rows, partly
masked rows, and rows built so that ``m − x`` (or ``(m − x)/step``) lands
exactly on a .5 bin edge, where round-half-to-even decides.  Exact
softmax goes through different ``exp`` implementations and is held to
1e-6.  The kernels' per-element helpers (``kernels/common.py``) must
reproduce the row-at-once semantics exactly, as the CUDA pipeline does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lut_builder as JB
from repro.core import lut_softmax as JS
from repro.kernels import common as JC
from repro_torch.core import lut_builder as TB
from repro_torch.core import lut_softmax as TS
from repro_torch.kernels import common as TC

torch.set_num_threads(1)

PRECISIONS = ["int16", "uint8", "uint4", "uint2"]
MODES = ["round", "floor"]


def _rows(rng, method, precision, n=64):
    """(rows, n) f32 logits covering the cases the module docstring lists."""
    x = (rng.normal(size=(8, n)) * 3).astype(np.float32)
    wide = (rng.normal(size=(4, n)) * 30).astype(np.float32)
    masked = (rng.normal(size=(4, n)) * 3).astype(np.float32)
    masked[rng.random(masked.shape) < 0.5] = -np.inf
    masked[0, :] = -np.inf                       # fully masked row
    masked[1, 1:] = -np.inf                      # a single live key
    # .5 edges: d = m − x at (k + 0.5) · step, m = 0 at column 0
    step = (TB.build_lut2d_tables(precision).exp_step
            if method == "lut2d" else 1.0)
    edge = np.zeros((2, n), np.float32)
    k = np.arange(n - 1) % 20
    edge[0, 1:] = -((k + 0.5) * step)
    edge[1, 1:] = -((k + 0.5) * step) + np.float32(0.25) * (k % 2)
    ties = np.repeat(rng.normal(size=(2, 1)), n, axis=1).astype(np.float32)
    return np.concatenate([x, wide, masked, edge, ties])


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("index_mode", MODES)
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("method", ["rexp", "lut2d"])
def test_lut_softmax_bitwise_equal(method, precision, index_mode):
    rng = np.random.default_rng(PRECISIONS.index(precision))
    x = _rows(rng, method, precision)
    if method == "rexp":
        jt, tt = JB.build_rexp_tables(precision), TB.build_rexp_tables(
            precision)
        ref = JS.softmax_rexp(jnp.asarray(x), jt, index_mode=index_mode)
        out = TS.softmax_rexp(torch.from_numpy(x), tt, index_mode=index_mode)
    else:
        jt, tt = JB.build_lut2d_tables(precision), TB.build_lut2d_tables(
            precision)
        ref = JS.softmax_lut2d(jnp.asarray(x), jt, index_mode=index_mode)
        out = TS.softmax_lut2d(torch.from_numpy(x), tt,
                               index_mode=index_mode)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))
    assert not np.any(out.numpy()[4 + 8])        # the fully-masked row


@pytest.mark.parametrize("axis", [-1, 0])
def test_exact_softmax_close(axis):
    rng = np.random.default_rng(11)
    x = _rows(rng, "rexp", "uint8")
    if axis == 0:
        x = np.ascontiguousarray(x.T)
    ref = np.asarray(JS.softmax_exact(jnp.asarray(x), axis=axis))
    out = TS.softmax_exact(torch.from_numpy(x), axis=axis).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    assert not np.any(np.isnan(out))


@pytest.mark.parametrize("index_mode", MODES)
@pytest.mark.parametrize("method", ["rexp", "lut2d"])
def test_integer_pieces_bitwise_equal(method, index_mode):
    """e_int and the α index, the pieces the kernels rebuild per element."""
    rng = np.random.default_rng(21)
    x = _rows(rng, method, "uint8")
    if method == "rexp":
        jt, tt = JB.build_rexp_tables("uint8"), TB.build_rexp_tables("uint8")
        je = JS.rexp_exp_int(jnp.asarray(x), jt, index_mode=index_mode)
        te = TS.rexp_exp_int(torch.from_numpy(x), tt, index_mode=index_mode)
        s = np.asarray(je, np.float32).sum(-1, keepdims=True)
        np.testing.assert_array_equal(
            TS.rexp_alpha_index(torch.from_numpy(s), tt, index_mode).numpy(),
            np.asarray(JS.rexp_alpha_index(jnp.asarray(s), jt, index_mode)))
    else:
        jt = JB.build_lut2d_tables("uint8")
        tt = TB.build_lut2d_tables("uint8")
        je = JS.lut2d_exp_int(jnp.asarray(x), jt, index_mode=index_mode)
        te = TS.lut2d_exp_int(torch.from_numpy(x), tt, index_mode=index_mode)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


@pytest.mark.parametrize("index_mode", MODES)
@pytest.mark.parametrize("method", ["exact", "rexp", "lut2d"])
def test_kernel_pipeline_helpers(method, index_mode):
    """Per-element pipeline given the global m and Σ — the arithmetic of
    ``csrc/lut_pipeline.cuh`` — against the JAX in-kernel helpers and the
    row-at-once semantics."""
    rng = np.random.default_rng(31)
    x = _rows(rng, "rexp" if method != "lut2d" else "lut2d", "uint8")
    tables_t = (TB.build_rexp_tables("uint8") if method == "rexp"
                else TB.build_lut2d_tables("uint8") if method == "lut2d"
                else None)
    tables_j = (JB.build_rexp_tables("uint8") if method == "rexp"
                else JB.build_lut2d_tables("uint8") if method == "lut2d"
                else None)
    lut_main, lut_aux, step, qmax, sx, ss = TC.policy_kernel_tables(
        method, tables_t)
    jm, ja, *jrest = JC.policy_kernel_tables(method, tables_j)
    np.testing.assert_array_equal(lut_main, np.asarray(jm)[0])
    np.testing.assert_array_equal(lut_aux, np.asarray(ja))
    assert (step, qmax, sx, ss) == tuple(jrest)

    m = np.max(x, axis=-1)
    m = np.where(np.isfinite(m), m, 0).astype(np.float32)
    xt, mt = torch.from_numpy(x), torch.from_numpy(m)
    e = TC.policy_e_terms(xt, mt, torch.from_numpy(lut_main), method, step,
                          index_mode)
    je = JC.policy_e_terms(jnp.asarray(x), jnp.asarray(m), jnp.asarray(
        lut_main), method, step, index_mode, "gather")
    if method == "exact":
        np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-6,
                                   atol=1e-6)
        return
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    s = e.float().sum(-1)
    if method == "rexp":
        w = TC.rexp_sigma(e, s, torch.from_numpy(lut_aux[0]), qmax,
                          index_mode) * TS.inv_scale(qmax)
        ref = TS.softmax_rexp(xt, tables_t, index_mode=index_mode)
    else:
        w = TC.lut2d_sigma_int(e, s, torch.from_numpy(lut_aux), qmax, sx,
                               ss, index_mode).float() * TS.inv_scale(qmax)
        ref = TS.softmax_lut2d(xt, tables_t, index_mode=index_mode)
    np.testing.assert_array_equal(_bits(w.numpy()), _bits(ref.numpy()))


def test_inv_scale_is_the_f32_reciprocal():
    for denom in (255, 0.1, 25.5, 65535 * 0.1, 3.0):
        assert TS.inv_scale(denom) == float(JS.inv_scale(denom))
        assert TS.inv_scale(denom) == float(np.float32(1.0 / denom))
