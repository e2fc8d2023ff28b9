"""The port's row-wise LUT softmax (``kernels/lut_softmax``) against the
JAX package's, bit for bit.

``lut_softmax(x, policy(use_kernel=True))`` on CPU tensors runs the
kernel's plain version; it must return the bits of the JAX package's
``lut_softmax`` with ``use_kernel=True`` — the Pallas kernel in
interpret mode — over JAX's own kernel-test sweep (``SHAPES`` ×
``PRECISIONS`` of ``tests/test_kernels.py``) × both bin modes × f32,
f16 and bf16 inputs, with ``−inf`` masks, a fully masked row and
``axis=1``.  The TPU kernel's first step casts its input to f32, so the
JAX side takes the f32 upcast of the f16 / bf16 values, stacked with the
f32 case into one call; ``test_half_inputs_through_jax`` pins that
upcast against JAX's own f16 / bf16 calls.

Rows holding ``+inf`` or ``NaN`` are where the JAX package disagrees
with itself: its ``core`` (``make_softmax_fn``) takes the row max over
every entry, its Pallas kernel over the finite ones.  The port keeps
both, and ``test_nonfinite_split_matches_the_jax_pair`` pins each side
to its JAX counterpart.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import lut_builder as JB
from repro.core import lut_softmax as JS
from repro.core.policies import SoftmaxPolicy as JPol
from repro.kernels.lut_softmax import ops as jops
from repro.kernels.lut_softmax import ref as jref
from repro_torch.core import lut_builder as TB
from repro_torch.core.policies import SoftmaxPolicy as TPol
from repro_torch.kernels.lut_softmax import lut_softmax as tker
from repro_torch.kernels.lut_softmax import ops as tops
from repro_torch.kernels.lut_softmax import ref as tref

torch.set_num_threads(1)

PRECISIONS = ["int16", "uint8", "uint4", "uint2"]
SHAPES = [(4, 64), (3, 5, 200), (17, 333), (1, 8)]
MODES = ["round", "floor"]
HALF = {"f16": (np.float16, torch.float16),
        "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _logits(rng, shape):
    """Normal logits (σ = 3) with a quarter of the entries ``−inf`` and,
    where there is more than one row, the last row fully masked."""
    x = rng.normal(0, 3, shape).astype(np.float32)
    x[rng.random(shape) < 0.25] = -np.inf
    rows = x.reshape(-1, shape[-1])
    if rows.shape[0] > 1:
        rows[-1] = -np.inf
    return x


def _pols(impl, precision, index_mode):
    kw = dict(impl=impl, precision=precision, index_mode=index_mode,
              use_kernel=True)
    return JPol(**kw), TPol(**kw)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("index_mode", MODES)
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("impl", ["rexp", "lut2d"])
def test_kernel_route_bitwise_equal_to_pallas(impl, precision, index_mode,
                                              shape):
    rng = np.random.default_rng(SHAPES.index(shape))
    x = _logits(rng, shape)
    variants = {"f32": (x, torch.float32)}
    for name, (np_dt, t_dt) in HALF.items():
        variants[name] = (x.astype(np_dt).astype(np.float32), t_dt)
    jpol, tpol = _pols(impl, precision, index_mode)
    ref = np.asarray(jops.lut_softmax(
        jnp.asarray(np.stack([v for v, _ in variants.values()])), jpol))
    for i, (name, (xv, t_dt)) in enumerate(variants.items()):
        out = tops.lut_softmax(torch.from_numpy(xv).to(t_dt), tpol)
        assert out.dtype == torch.float32 and out.shape == shape
        np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref[i]),
                                      err_msg=name)
    rows = ref[0].reshape(-1, shape[-1])
    if rows.shape[0] > 1:
        assert not rows[-1].any()                   # the fully masked row


@pytest.mark.parametrize("half", sorted(HALF))
@pytest.mark.parametrize("impl", ["rexp", "lut2d"])
def test_half_inputs_through_jax(impl, half):
    """JAX's own f16 / bf16 call gives what its f32 upcast gives, and the
    port's f16 / bf16 call the same bits."""
    np_dt, t_dt = HALF[half]
    x = _logits(np.random.default_rng(5), (17, 333)).astype(np_dt)
    jpol, tpol = _pols(impl, "uint8", "round")
    ref = np.asarray(jops.lut_softmax(jnp.asarray(x), jpol))
    up = np.asarray(jops.lut_softmax(jnp.asarray(x.astype(np.float32)),
                                     jpol))
    np.testing.assert_array_equal(_bits(ref), _bits(up))
    out = tops.lut_softmax(torch.from_numpy(x.astype(np.float32)).to(t_dt),
                           tpol)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))


@pytest.mark.parametrize("impl", ["rexp", "lut2d"])
def test_axis_one(impl):
    """``axis`` is moved to the last position and back."""
    x = _logits(np.random.default_rng(6), (3, 5, 200))
    jpol, tpol = _pols(impl, "uint8", "round")
    ref = np.asarray(jops.lut_softmax(jnp.asarray(x), jpol, axis=1))
    out = tops.lut_softmax(torch.from_numpy(x), tpol, axis=1)
    assert out.shape == x.shape
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))


@pytest.mark.parametrize("impl", ["rexp", "lut2d"])
@pytest.mark.parametrize("bad", [np.inf, np.nan], ids=["inf", "nan"])
def test_nonfinite_split_matches_the_jax_pair(bad, impl):
    """The row ``[1, 2, +inf, 0.5, −inf, 3, 0, 0]`` (and NaN for
    +inf): the core route's max is non-finite, so it becomes 0; the kernel
    route's is 3, the max of the finite entries.  Each side holds its JAX
    counterpart bitwise, and the two sides differ."""
    x = np.array([[1, 2, bad, 0.5, -np.inf, 3, 0, 0],
                  [1, 2, 4, 0.5, -np.inf, 3, 0, 0]], np.float32)
    jk, tk = _pols(impl, "uint8", "round")
    jc, tc = (type(p)(impl=impl, precision="uint8") for p in (jk, tk))
    core = tops.lut_softmax(torch.from_numpy(x), tc).numpy()
    kern = tops.lut_softmax(torch.from_numpy(x), tk).numpy()
    np.testing.assert_array_equal(
        _bits(core), _bits(jops.lut_softmax(jnp.asarray(x), jc)))
    np.testing.assert_array_equal(
        _bits(kern), _bits(jops.lut_softmax(jnp.asarray(x), jk)))
    assert not np.array_equal(core[0], kern[0])
    np.testing.assert_array_equal(core[1], kern[1])    # a finite row
    assert kern[0, 2] == 0 and kern[0, 4] == 0
    if impl == "rexp" and bad == np.inf:
        np.testing.assert_allclose(
            kern[0], [0.071, 0.184, 0, 0.071, 0, 0.502, 0.027, 0.027],
            atol=1e-3)
        np.testing.assert_allclose(core[0][np.isfinite(x[0])], 0.165,
                                   atol=1e-3)


@pytest.mark.parametrize("impl", ["exact", "rexp_unnorm", "log2_prior",
                                  "rexp", "lut2d"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_core_routes(impl, use_kernel):
    """``use_kernel=False`` and the impls without a kernel go to
    ``make_softmax_fn``, as in the JAX package (exact within 1e-6,
    log2_prior within one level, the rest bitwise)."""
    x = _logits(np.random.default_rng(7), (6, 40))
    kw = dict(impl=impl, precision="uint4", use_kernel=use_kernel)
    ref = np.asarray(jops.lut_softmax(jnp.asarray(x), JPol(**kw)))
    out = tops.lut_softmax(torch.from_numpy(x), TPol(**kw)).numpy()
    if impl == "exact":
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    elif impl == "log2_prior":
        assert np.abs(out - ref).max() <= (1 + 1e-6) / 15
    else:
        np.testing.assert_array_equal(_bits(out), _bits(ref))


def test_cpu_tensors_launch_nothing():
    x = torch.from_numpy(_logits(np.random.default_rng(8), (4, 64)))
    before = (tker.rexp_softmax_cuda.launches,
              tker.lut2d_softmax_cuda.launches)
    for impl in ("rexp", "lut2d"):
        tops.lut_softmax(x, TPol(impl=impl, use_kernel=True))
    assert (tker.rexp_softmax_cuda.launches,
            tker.lut2d_softmax_cuda.launches) == before


@pytest.mark.parametrize("index_mode", MODES)
def test_refs_and_stages(index_mode):
    """The oracles of ``ref.py`` against the JAX package's."""
    x = _logits(np.random.default_rng(9), (5, 96))
    jr, tr = JB.build_rexp_tables("uint8"), TB.build_rexp_tables("uint8")
    jl, tl = JB.build_lut2d_tables("uint8"), TB.build_lut2d_tables("uint8")
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_array_equal(
        _bits(tref.rexp_softmax_ref(xt, tr, index_mode).numpy()),
        _bits(jref.rexp_softmax_ref(xj, jr, index_mode)))
    np.testing.assert_array_equal(
        _bits(tref.lut2d_softmax_ref(xt, tl, index_mode).numpy()),
        _bits(jref.lut2d_softmax_ref(xj, jl, index_mode)))
    for t, j in zip(tref.rexp_stages_ref(xt, tr, index_mode),
                    jref.rexp_stages_ref(xj, jr, index_mode)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(      # finite/−inf rows: kernel == core
        _bits(tker.rexp_softmax_plain(xt, tr, index_mode).numpy()),
        _bits(JS.softmax_rexp(xj, jr, index_mode=index_mode)))


ROW_COLS = [1, 7, 8, 300, 1500, 1501, 2048, 4097, 16384, 65536]


@pytest.mark.parametrize("esize", [4, 2], ids=["f32", "16-bit"])
@pytest.mark.parametrize("cols", ROW_COLS)
def test_row_plan_fits_alignment_and_shared_memory(cols, esize):
    """The CUDA kernel's launch plan (``row_plan``, computed on the host):
    over input pointers shifted by 0–8 elements or by one row (``x[1:]``)
    and output pointers shifted by 0–3 floats, the vector it picks is the
    widest of 8, 4 and 1 elements whose loads divide the input's row
    alignment and whose f32 stores divide the output's (a misaligned
    vector access faults on the card); the warp route's register bucket
    holds the row; a row staged by a bulk copy is 16-byte aligned; the
    shared memory stays within 227 KB and holds the tables and the row
    buffers (a warp's next row, or the cta route's staged rows)."""
    base = 1 << 20

    def fits(v, x_ptr, out_ptr):
        store = min(16, 4 * v)
        return (v * esize <= 16 and cols % v == 0
                and x_ptr % (v * esize) == 0 and out_ptr % store == 0
                and (cols * esize) % (v * esize) == 0
                and (cols * 4) % store == 0)

    for n_main, n_aux in ((8, 16), (101, 11 * 60)):
        for rows in (1, 72000):
            for x_off in [*range(9), cols]:
                for out_off in range(4):
                    x_ptr, out_ptr = base + x_off * esize, base + out_off * 4
                    plan = tker.row_plan(rows, cols, esize, x_ptr, out_ptr,
                                         132, n_main, n_aux)
                    assert fits(plan.vec, x_ptr, out_ptr), plan
                    assert not any(fits(v, x_ptr, out_ptr) for v in (8, 4)
                                   if v > plan.vec), plan
                    tables = tker.table_bytes(n_main, n_aux)
                    assert tables <= plan.smem <= tker.SMEM_LIMIT
                    assert plan.grid >= 1 and plan.threads % 32 == 0
                    if plan.route == "warp":
                        stage = (-(-cols * esize // 16) * 16
                                 if esize == 2 and plan.vec * esize >= 4
                                 else 0)
                        assert plan.smem >= (tables + plan.threads // 32
                                             * stage)
                        assert cols <= 32 * plan.per_lane
                        assert plan.per_lane % plan.vec == 0
                        assert plan.grid <= -(-rows // (plan.threads // 32))
                    else:
                        assert plan.route == "cta" and cols > 2048
                        assert plan.grid <= rows
                        if plan.stages:
                            assert plan.vec * esize == 16
                            assert (plan.smem >= plan.stages * cols * esize
                                    + tables)
