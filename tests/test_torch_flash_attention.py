"""The port's exact flash attention and blocked attention path against
the JAX package's.

* The flash kernel's plain version (``flash_attention_plain``) returns
  the ``(out, m, l)`` of the JAX package's ``flash_attention_pallas``
  (Pallas interpret mode): out within 2e-5, m and l within 1e-5
  relative — XLA and torch order the f32 sums differently — over GQA,
  causal and not, Lk = 300 (not a multiple of a block) and Lq > Lk,
  where the causal rows that see no key give out 0, m = −inf, l = 0.
* ``lut_attention_blocked`` holds the JAX function for exact (2e-5 on
  random inputs), REXP and 2D-LUT (2e-6 on integer q, k, whose logits
  are exact in any order; on random inputs under 2 % of elements beyond
  1e-4, since a logit on a bin edge may land in the next bin, as
  ``tests/test_kernels.py`` allows), causal and not, with scalar and
  per-row ``kv_len``, ``q_start``, and a 1500-key non-divisible case.
* ``flash_attention`` holds JAX's on every backend (the port's ``auto``
  against JAX's ``pallas``; with a cache's ``kv_len``, against JAX's
  default ``naive``, which is what the kernel computes with one), and
  the knobs the port does not take raise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policies import SoftmaxPolicy as JPol
from repro.kernels.flash_attention import ops as jfops
from repro.kernels.flash_attention import ref as jfref
from repro.kernels.flash_attention.flash_attention import (
    flash_attention_pallas)
from repro.kernels.lut_attention import ops as jops
from repro_torch.core.policies import SoftmaxPolicy as TPol
from repro_torch.kernels.flash_attention import flash_attention as tflash
from repro_torch.kernels.flash_attention import ops as tfops
from repro_torch.kernels.flash_attention import ref as tfref
from repro_torch.kernels.lut_attention import ops as tops

torch.set_num_threads(1)

EXACT_TOL = dict(rtol=2e-5, atol=2e-5)
INT_TOL = dict(rtol=2e-6, atol=2e-6)


def _qkv(rng, b, h, kvh, lq, lk, d, integer=False):
    def gen(shape):
        if integer:
            return np.round(rng.normal(0, 2, shape)).astype(np.float32)
        return rng.normal(0, 1, shape).astype(np.float32)
    return (gen((b, h, lq, d)), gen((b, kvh, lk, d)),
            rng.normal(0, 1, (b, kvh, lk, d)).astype(np.float32))


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


FLASH_CASES = [  # (B, H, KVH, Lq, Lk, D, causal)
    (2, 4, 2, 64, 300, 32, False),     # GQA, Lk not a multiple of a block
    (2, 4, 2, 64, 300, 32, True),
    (1, 4, 4, 40, 40, 64, True),
    (1, 8, 2, 100, 64, 16, True),      # Lq > Lk: 36 rows see no key
    (1, 2, 1, 24, 8, 16, False),       # Lq > Lk, not causal
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_plain_matches_pallas(case):
    b, h, kvh, lq, lk, d, causal = case
    rng = np.random.default_rng(sum(case))
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(rng, b, h, kvh, lq, lk, d))
    jo, jm, jl = (np.asarray(a) for a in flash_attention_pallas(
        jq, jk, jv, causal=causal))
    to, tm, tl = (a.numpy() for a in tflash.flash_attention_plain(
        tq, tk, tv, causal=causal))
    assert to.shape == (b, h, lq, d) and tm.shape == tl.shape == (b, h, lq)
    np.testing.assert_allclose(to, jo, **EXACT_TOL)
    np.testing.assert_allclose(tm, jm, rtol=1e-5, atol=0)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    blind = ~np.isfinite(jm)
    if causal and lq > lk:
        assert blind.sum() == b * h * (lq - lk)
    np.testing.assert_array_equal(to[blind], 0)
    np.testing.assert_array_equal(tl[blind], 0)
    assert np.all(np.isneginf(tm[blind]))


def test_flash_wrapper_on_cpu_and_ref():
    """On CPU tensors the wrapper runs its plain version and counts no
    launch; the port's oracle holds the JAX one."""
    rng = np.random.default_rng(3)
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(rng, 1, 4, 2, 33, 47, 16))
    before = dict(tflash.flash_attention_cuda.launches)
    for causal in (False, True):
        out = tflash.flash_attention_cuda(tq, tk, tv, causal=causal,
                                          scale=0.3)
        plain = tflash.flash_attention_plain(tq, tk, tv, causal=causal,
                                             scale=0.3)
        for a, p in zip(out, plain):
            torch.testing.assert_close(a, p, rtol=0, atol=0)
        np.testing.assert_allclose(
            tfref.flash_attention_ref(tq, tk, tv, causal=causal,
                                      scale=0.3).numpy(),
            np.asarray(jfref.flash_attention_ref(jq, jk, jv, causal=causal,
                                                 scale=0.3)), **EXACT_TOL)
    assert tflash.flash_attention_cuda.launches == before


BLOCKED_CASES = [  # (name, B, H, KVH, Lq, Lk, D, causal, kv_len, q_start,
    #                 q_chunk, k_chunk)
    ("plain", 2, 4, 2, 64, 256, 32, False, None, None, 32, 64),
    ("causal", 2, 4, 2, 64, 256, 32, True, None, None, 32, 64),
    ("kv_len", 2, 4, 2, 16, 200, 32, True, 130, None, 16, 64),
    ("per-row kv_len", 3, 4, 2, 8, 96, 16, True, (96, 41, 9), None, 8, 32),
    ("q_start", 3, 4, 2, 8, 96, 16, True, (60, 41, 9), (52, 20, 1), 8, 32),
    ("1500 keys", 1, 4, 4, 50, 1500, 32, False, None, None, 32, 512),
]


def _blocked_args(case):
    (_, b, h, kvh, lq, lk, d, causal, kv_len, q_start, qc, kc) = case

    def arg(x, lib):
        if x is None or isinstance(x, int):
            return x
        return lib(np.asarray(x, np.int32))
    kw = dict(causal=causal, q_chunk=qc, k_chunk=kc)
    return ((b, h, kvh, lq, lk, d),
            dict(kw, kv_len=arg(kv_len, jnp.asarray),
                 q_start=arg(q_start, jnp.asarray)),
            dict(kw, kv_len=arg(kv_len, torch.from_numpy),
                 q_start=arg(q_start, torch.from_numpy)))


@pytest.mark.parametrize("case", BLOCKED_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("impl", ["exact", "rexp", "lut2d"])
def test_blocked_matches_jax(impl, case):
    dims, jkw, tkw = _blocked_args(case)
    rng = np.random.default_rng(len(case[0]))
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(rng, *dims,
                                            integer=impl != "exact"))
    kw = dict(impl=impl, precision="uint8") if impl != "exact" else {}
    ref = np.asarray(jops.lut_attention_blocked(jq, jk, jv, JPol(**kw),
                                                **jkw))
    out = tops.lut_attention_blocked(tq, tk, tv, TPol(**kw), **tkw).numpy()
    assert out.shape == ref.shape == dims[:2] + (dims[3], dims[5])
    np.testing.assert_allclose(out, ref,
                               **(EXACT_TOL if impl == "exact" else INT_TOL))


@pytest.mark.parametrize("impl", ["rexp", "lut2d"])
def test_blocked_random_inputs_boundary_flips(impl):
    """Continuous q, k: an ulp of logit may cross a bin edge; fewer than
    2 % of the elements may move by more than 1e-4."""
    rng = np.random.default_rng(12)
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(rng, 2, 4, 2, 128, 256, 64))
    kw = dict(impl=impl, precision="uint8")
    ref = np.asarray(jops.lut_attention_blocked(
        jq, jk, jv, JPol(**kw), causal=True, q_chunk=64, k_chunk=128))
    out = tops.lut_attention_blocked(tq, tk, tv, TPol(**kw), causal=True,
                                     q_chunk=64, k_chunk=128).numpy()
    assert np.mean(~np.isclose(out, ref, rtol=1e-4, atol=1e-4)) < 0.02


def test_blocked_never_holds_more_than_a_tile(monkeypatch):
    """Every logits tile is (B, KVH, G, q_chunk, k_chunk)."""
    shapes = []
    grouped = tops._grouped_logits

    def spy(qc, kc, scale):
        s = grouped(qc, kc, scale)
        shapes.append(tuple(s.shape))
        return s

    monkeypatch.setattr(tops, "_grouped_logits", spy)
    q, k, v = (torch.from_numpy(a) for a in _qkv(
        np.random.default_rng(13), 1, 4, 2, 40, 100, 8))
    for impl in ("exact", "rexp"):
        tops.lut_attention_blocked(q, k, v, TPol(impl=impl), q_chunk=16,
                                   k_chunk=32)
    assert set(shapes) == {(1, 2, 2, 16, 32)}


@pytest.mark.parametrize("backend", ["auto", "naive", "blocked"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_backends_match_jax(backend, causal):
    """The port's ``auto`` (the plain version on CPU tensors) against JAX's
    ``pallas`` (interpret mode); ``naive`` and ``blocked`` against
    theirs, also with a cache's ``kv_len``."""
    rng = np.random.default_rng(14)
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(rng, 2, 4, 2, 48, 160, 32))
    jb = "pallas" if backend == "auto" else backend
    kw = dict(causal=causal, q_chunk=16, k_chunk=64)
    ref = jfops.flash_attention(jq, jk, jv, backend=jb, **kw)
    out = tfops.flash_attention(tq, tk, tv, backend=backend, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **EXACT_TOL)
    # JAX's pallas takes no kv_len: the port's auto computes its naive
    ref = jfops.flash_attention(jq, jk, jv,
                                backend="naive" if backend == "auto" else jb,
                                kv_len=jnp.int32(100), **kw)
    out = tfops.flash_attention(tq, tk, tv, backend=backend, kv_len=100,
                                **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **EXACT_TOL)


@pytest.mark.parametrize("kv_len", [3, 0, torch.tensor(3)], ids=str)
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_auto_with_kv_len_matches_jax_naive(causal, kv_len):
    """``flash_attention(..., backend="auto", kv_len=…)`` on CPU tensors
    (the kernel's plain version) returns JAX's default ``naive`` result:
    keys at or past kv_len masked, causal queries right-aligned to it; a
    kv_len of 0 leaves every row without a key (out 0)."""
    rng = np.random.default_rng(16)
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(rng, 1, 2, 2, 4, 6, 8))
    n = int(kv_len)
    ref = jfops.flash_attention(jq, jk, jv, causal=causal, kv_len=n)
    before = dict(tflash.flash_attention_cuda.launches)
    out = tfops.flash_attention(tq, tk, tv, causal=causal, kv_len=kv_len)
    assert tflash.flash_attention_cuda.launches == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **EXACT_TOL)
    if n == 0:
        _, m, l = tflash.flash_attention_plain(tq, tk, tv, causal=causal,
                                               kv_len=kv_len)
        assert not out.any() and not l.any() and torch.isneginf(m).all()


@pytest.mark.parametrize("backend,kw,match", [
    ("cuda", {}, "CUDA tensors"),         # no kernel for CPU tensors
    ("pallas", {}, "pallas"),             # the JAX knob; the port's 'cuda'
])
def test_flash_attention_knobs_that_raise(backend, kw, match):
    q = torch.zeros((1, 2, 4, 8))
    before = dict(tflash.flash_attention_cuda.launches)
    with pytest.raises(ValueError, match=match):
        tfops.flash_attention(q, q, q, backend=backend, **kw)
    assert tflash.flash_attention_cuda.launches == before


def test_lut_attention_routes_blocked():
    """``lut_attention(backend="blocked")`` is the blocked path with the
    caller's chunks, and holds JAX's ``lut_attention`` on that knob."""
    rng = np.random.default_rng(15)
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(rng, 1, 4, 2, 20, 70, 16,
                                            integer=True))
    for impl in ("rexp", "lut2d"):
        kw = dict(impl=impl, precision="uint4")
        out = tops.lut_attention(tq, tk, tv, TPol(**kw), causal=True,
                                 kv_len=50, backend="blocked", q_chunk=8,
                                 k_chunk=16)
        torch.testing.assert_close(out, tops.lut_attention_blocked(
            tq, tk, tv, TPol(**kw), causal=True, kv_len=50, q_chunk=8,
            k_chunk=16), rtol=0, atol=0)
        ref = jops.lut_attention(jq, jk, jv, JPol(**kw), causal=True,
                                 kv_len=jnp.int32(50), backend="blocked",
                                 q_chunk=8, k_chunk=16)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **INT_TOL)


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "tiles"),    # the Whisper encoder
    (torch.bfloat16, 128, "tiles"),   # Qwen3-32B
    (torch.float16, 128, "tiles"),
    (torch.bfloat16, 8, "tiles"),     # zero-padded to the 64-wide tile
    (torch.bfloat16, 40, "tiles"),
    (torch.float32, 64, "simt"),      # p·V in IEEE f32 on the CUDA cores
    (torch.bfloat16, 256, "simt"),    # wider than the 128-wide tile
    (torch.float16, 36, "simt"),      # not a whole 16-byte chunk
])
def test_flash_route(dtype, d, route):
    """16-bit inputs with D ≤ 128, a multiple of 8, take the tile engine;
    f32 and every other D the CUDA-core kernel.  A forced ``"tiles"``
    that the inputs do not suit raises before any launch or plain run;
    one they suit runs (on CPU tensors, the plain version)."""
    assert tflash.flash_route(dtype, d) == route
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _qkv(rng, 1, 2, 1, 5, 9, d))
    before = dict(tflash.flash_attention_cuda.launches)
    if route == "simt":
        with pytest.raises(ValueError, match="tile route"):
            tflash.flash_attention_cuda(q, k, v, route="tiles")
    else:
        out = tflash.flash_attention_cuda(q, k, v, causal=True,
                                          route="tiles")
        for a, p in zip(out, tflash.flash_attention_plain(q, k, v,
                                                          causal=True)):
            torch.testing.assert_close(a, p, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown flash route"):
        tflash.flash_attention_cuda(q, k, v, route="rows")
    assert tflash.flash_attention_cuda.launches == before
    assert set(before) == set(tflash.ROUTES)
