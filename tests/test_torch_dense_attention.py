"""The port's dense LUT attention against the JAX package's.

The plain version of the dense CUDA kernel (``lut_attention_plain``,
i.e. ``ref.lut_attention_ref``) is held to the JAX package's Pallas
kernel ``lut_attention_pallas`` run in interpret mode, on the same
seeded numpy inputs, in each of the kernel's modes (REXP's fused α
form, REXP's and 2D-LUT's faithful σ): causal and not, ``Lq ≠ Lk``,
GQA, and ``Lk`` not a multiple of the TPU kernel's 128-key block.

* Exact-logit inputs (q, k small integers × 2^-2; the scales are powers
  of two or apply one rounding to an exact dot) give the same f32
  logits in every summation order, so the integer pipeline must agree:
  outputs within 2e-6, far below the 1/qmax · |v| a moved bin costs.
* Random inputs: XLA and torch sum the f32 dot in other orders, and a
  logit on a bin edge may land in the neighbouring bin; outputs within
  one LUT step (2/qmax · max|v|).

The ``kv_len`` form (a pre-allocated cache's valid length, causal
queries right-aligned to it) is held to the JAX package's naive
``lut_attention(kv_len=...)``, and the wrapper's CPU behaviour and the
mode split are pinned.  The kernel itself is held to this plain version
on the card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policies import SoftmaxPolicy as JPol
from repro.kernels.lut_attention import ops as jops
from repro.kernels.lut_attention.lut_attention import lut_attention_pallas
from repro_torch.core.policies import SoftmaxPolicy as TPol
from repro_torch.core.precision import get_precision
from repro_torch.kernels.lut_attention import ops as tops
from repro_torch.kernels.lut_attention.lut_attention import (
    MIN_TILE_ROWS, MODES, ROUTES, dense_route, lut_attention_cuda,
    lut_attention_plain, mode_of)

torch.set_num_threads(1)

EXACT_TOL = 2e-6

#: (B, H, KVH, Lq, Lk, D, causal)
CASES = [
    (1, 2, 2, 16, 16, 64, False),      # encoder-like, square
    (2, 4, 2, 5, 20, 32, True),        # GQA 2, Lq ≠ Lk, right-aligned
    (1, 4, 1, 8, 200, 64, True),       # GQA 4, Lk not a multiple of 128
    (2, 2, 2, 1, 150, 64, False),      # cross-attention decode, Lq = 1
    (1, 2, 2, 7, 130, 16, False),      # cross-attention prefill
]

#: mode → (method, fused_requant)
MODE_ARGS = {"rexp_fused": ("rexp", True), "rexp": ("rexp", False),
             "lut2d": ("lut2d", False)}


def _inputs(seed, case, exact_logits):
    b, h, kvh, lq, lk, d, _ = case
    rng = np.random.default_rng(seed)
    if exact_logits:
        q = rng.integers(-4, 5, size=(b, h, lq, d)) * 0.25
        k = rng.integers(-4, 5, size=(b, kvh, lk, d)) * 0.25
    else:
        q = rng.normal(size=(b, h, lq, d))
        k = rng.normal(size=(b, kvh, lk, d))
    v = rng.normal(size=(b, kvh, lk, d))
    return [x.astype(np.float32) for x in (q, k, v)]


def _both(mode, case, prec, q, k, v, index_mode="round"):
    method, fused = MODE_ARGS[mode]
    kw = dict(impl=method, precision=prec, index_mode=index_mode)
    causal = case[-1]
    ref = lut_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jops._tables_for(JPol(**kw)), method=method, causal=causal,
        index_mode=index_mode, fused_requant=fused, interpret=True)
    out = lut_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        tops._tables_for(TPol(**kw)), method=method, causal=causal,
        index_mode=index_mode, fused_requant=fused)
    assert out.dtype == torch.float32 and out.shape == q.shape
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_pallas_on_exact_logits(mode, case):
    q, k, v = _inputs(1, case, exact_logits=True)
    out, ref = _both(mode, case, "uint8", q, k, v)
    np.testing.assert_allclose(out, ref, rtol=0, atol=EXACT_TOL)


@pytest.mark.parametrize("prec,index_mode", [("int16", "round"),
                                             ("uint4", "floor"),
                                             ("uint2", "round")])
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_pallas_at_other_precisions(mode, prec, index_mode):
    """The other table sizes and the floor bin mode, GQA and causal.
    int16 keeps Lk ≤ 2^24 // qmax (512): above it the f32 Σ is no
    longer exact in any order."""
    case = CASES[1]
    q, k, v = _inputs(2, case, exact_logits=True)
    out, ref = _both(mode, case, prec, q, k, v, index_mode)
    np.testing.assert_allclose(out, ref, rtol=0, atol=EXACT_TOL)


@pytest.mark.parametrize("case", CASES[:4], ids=str)
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_pallas_on_random_inputs(mode, case):
    q, k, v = _inputs(3, case, exact_logits=False)
    out, ref = _both(mode, case, "uint8", q, k, v)
    step = 2.0 / get_precision("uint8").qmax * float(np.abs(v).max())
    assert float(np.abs(out - ref).max()) <= step


@pytest.mark.parametrize("impl", ["exact", "rexp", "lut2d"])
@pytest.mark.parametrize("lq,causal", [(1, True), (5, True), (5, False)])
def test_kv_len_form_matches_jax_naive(impl, lq, causal):
    """A cache of 24 allocated positions, 13 valid: the tail is masked
    and causal queries sit at positions [13 − Lq, 13), not at the end of
    the allocation.  The plain form is the faithful σ; the dispatcher
    takes it whenever a kv_len is given."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 4, lq, 16)).astype(np.float32)
    k = rng.normal(size=(2, 2, 24, 16)).astype(np.float32)
    v = rng.normal(size=(2, 2, 24, 16)).astype(np.float32)
    k[:, :, 13:] = 1e3      # junk past kv_len must not reach the output
    v[:, :, 13:] = -1e3
    kw = dict(impl=impl, precision="uint8") if impl != "exact" else {}
    ref = np.asarray(jops.lut_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), JPol(**kw),
        causal=causal, kv_len=13, backend="naive"))
    out = tops.lut_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), TPol(**kw), causal=causal,
                             kv_len=13).numpy()
    assert np.abs(ref).max() < 10
    np.testing.assert_allclose(out, ref, rtol=2e-6, atol=2e-6)
    if impl != "exact":
        plain = lut_attention_plain(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            tops._tables_for(TPol(**kw)), method=impl, causal=causal,
            kv_len=13).numpy()
        np.testing.assert_array_equal(plain, out)


def test_kv_len_at_full_length_is_the_cacheless_form():
    """kv_len = Lk changes nothing: the same mask and alignment."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(5, CASES[1], False))
    tables = tops._tables_for(TPol(impl="lut2d", precision="uint8"))
    a = lut_attention_plain(q, k, v, tables, method="lut2d", causal=True)
    b = lut_attention_plain(q, k, v, tables, method="lut2d", causal=True,
                            kv_len=k.shape[2])
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(x) for x in _inputs(6, CASES[2], True))
    tables = tops._tables_for(TPol(impl="rexp", precision="uint8"))
    before = (dict(lut_attention_cuda.launches),
              dict(lut_attention_cuda.route_launches))
    for fused in (False, True):
        out = lut_attention_cuda(q, k, v, tables, method="rexp",
                                 causal=True, fused_requant=fused, kv_len=150)
        ref = lut_attention_plain(q, k, v, tables, method="rexp",
                                  causal=True, fused_requant=fused,
                                  kv_len=150)
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert (lut_attention_cuda.launches,
            lut_attention_cuda.route_launches) == before


def test_modes():
    """Fused only for REXP; 2D-LUT ignores the flag; the kernel has no
    exact body."""
    assert mode_of("rexp", True) == "rexp_fused"
    assert mode_of("rexp", False) == "rexp"
    assert mode_of("lut2d", True) == mode_of("lut2d", False) == "lut2d"
    with pytest.raises(ValueError, match="rexp"):
        mode_of("exact", False)
    assert set(lut_attention_cuda.launches) == set(MODES)


#: (name, dtype, Dh, Lq, precision, route) — the main path's calls and
#: the inputs the tile engine does not take; calls of fewer than
#: MIN_TILE_ROWS rows take the split route in any type
ROUTE_CASES = [
    ("whisper encoder", torch.bfloat16, 64, 1500, "uint8", "tiles"),
    ("gqa prefill", torch.bfloat16, 128, 256, "uint8", "tiles"),
    ("qwen3 lockstep prefill", torch.bfloat16, 128, 300, "uint4", "tiles"),
    ("uint2", torch.bfloat16, 64, 1500, "uint2", "tiles"),
    ("f32", torch.float32, 64, 1500, "uint8", "simt"),
    ("int16", torch.bfloat16, 64, 1500, "int16", "tiles"),
    ("Dh 256", torch.bfloat16, 256, 1500, "uint8", "simt"),
    ("Dh 36", torch.bfloat16, 36, 1500, "uint8", "simt"),
    ("int16 Dh 256", torch.bfloat16, 256, 511, "int16", "simt"),
    ("decode step", torch.bfloat16, 64, 1, "uint8", "split"),
    ("cross prefill", torch.bfloat16, 64, 5, "uint8", "split"),
    ("f32 decode step", torch.float32, 64, 1, "uint8", "split"),
    ("int16 decode step", torch.bfloat16, 64, 1, "int16", "split"),
    ("Dh 256 decode step", torch.bfloat16, 256, 1, "uint8", "split"),
    ("qwen3 lockstep decode", torch.bfloat16, 128, 1, "uint8", "split"),
]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", ROUTE_CASES, ids=lambda c: c[0])
def test_dense_route(case, mode):
    """bf16 calls with Dh ≤ 128 and at least MIN_TILE_ROWS rows take the
    tile engine in every mode and at every precision (int16 too); f32,
    Dh 256 and head dims off the 16-byte grid take the CUDA-core tile
    engine at as many rows; calls of fewer rows take the split route,
    whatever their type."""
    _, dtype, dh, lq, _, want = case
    assert dense_route(dtype, dh, lq, mode) == want
    assert dense_route(dtype, dh, MIN_TILE_ROWS - 1, mode) == "split"
    assert dense_route(dtype, dh, MIN_TILE_ROWS, mode) != "split"


@pytest.mark.parametrize("case", [c for c in ROUTE_CASES
                                  if c[0] in ("f32", "int16 Dh 256",
                                              "Dh 256", "Dh 36")],
                         ids=lambda c: c[0])
def test_forced_tile_route_the_engine_does_not_take_raises(case):
    """A forced ``route="tiles"`` on inputs the tile engine does not take
    (f32, a head dim it has no tile for, at any precision) raises before
    any launch or plain run, on any device; so does a route the kernel
    does not have."""
    _, dtype, dh, _, prec, _ = case
    rng = np.random.default_rng(16)
    q, k = (torch.from_numpy(rng.normal(size=(1, 2, n, dh))).to(dtype)
            for n in (3, 5))
    tables = tops._tables_for(TPol(impl="rexp", precision=prec))
    before = (dict(lut_attention_cuda.launches),
              dict(lut_attention_cuda.route_launches))
    with pytest.raises(ValueError, match="tile route"):
        lut_attention_cuda(q, k, k, tables, route="tiles")
    with pytest.raises(ValueError, match="unknown dense route"):
        lut_attention_cuda(q, k, k, tables, route="rows")
    assert (lut_attention_cuda.launches,
            lut_attention_cuda.route_launches) == before
    assert set(lut_attention_cuda.route_launches) == set(ROUTES)


def test_forced_routes_on_cpu_run_the_plain_version():
    """On CPU tensors every forced route runs the plain version, so a
    test may name the route without a card; nothing is counted.  No
    route looks at the row count: a forced route takes a five-row
    call."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _inputs(17, CASES[1], True))
    tables = tops._tables_for(TPol(impl="lut2d", precision="uint8"))
    before = dict(lut_attention_cuda.route_launches)
    ref = lut_attention_plain(q, k, v, tables, method="lut2d", causal=True)
    for route in ROUTES:
        out = lut_attention_cuda(q, k, v, tables, method="lut2d",
                                 causal=True, route=route)
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert lut_attention_cuda.route_launches == before
