"""The port's paged decode and prefill against the JAX package.

``repro_torch``'s plain paged versions (what its kernel wrappers run on
CPU tensors) are held to the JAX Pallas kernels in interpret mode and to
the JAX dense reference on the same numpy inputs: every policy, GQA
ratios 1/2/4, ragged ``kv_lens`` (page-aligned, partial-page, single
token), chunk cursors with ``Lq % C ≠ 0``, permuted block tables, and
finite junk in the null page and in pages no slot owns.  Tolerance is
the JAX suite's own (``tests/test_paged_decode_kernel.py``): the integer
LUT pipeline is identical, the f32 dot and σ·V contraction sum in
another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import strategies
from repro.kernels.lut_attention import ops as jops
from repro.kernels.lut_attention.paged_decode import (
    paged_decode_attention as jax_paged_decode)
from repro.kernels.lut_attention.paged_prefill import (
    paged_prefill_attention as jax_paged_prefill)
from repro_torch.core.policies import SoftmaxPolicy
from repro_torch.kernels.lut_attention import ops as tops
from repro_torch.kernels.lut_attention.paged_decode import (
    paged_decode_attention, paged_decode_plain)
from repro_torch.kernels.lut_attention.paged_prefill import (
    paged_prefill_attention, paged_prefill_plain)

torch.set_num_threads(1)

JAX_POLICIES = strategies.make_policies()
TORCH_POLICIES = {
    "exact": SoftmaxPolicy(),
    "rexp": SoftmaxPolicy(impl="rexp", precision="uint8"),
    "lut2d": SoftmaxPolicy(impl="lut2d", precision="uint8"),
}
TOL = dict(rtol=2e-6, atol=2e-6)


def _problem(rng, *, kv_lens, g, c=1, q_start=None, kvh=2, dh=16, ps=8,
             mp=4):
    """numpy pool + permuted block tables; slot i owns ceil(kv_lens[i]/ps)
    pages, every other page (the null page included) holds finite junk."""
    b = len(kv_lens)
    n_pages = 1 + b * mp + 2
    q = rng.normal(size=(b, kvh * g, c, dh)).astype(np.float32)
    kp = rng.normal(size=(n_pages, ps, kvh, dh)).astype(np.float32)
    vp = rng.normal(size=(n_pages, ps, kvh, dh)).astype(np.float32)
    phys = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((b, mp), np.int32)
    for i, kl in enumerate(kv_lens):
        n_owned = -(-int(kl) // ps)
        bt[i, :n_owned] = phys[i * mp:i * mp + n_owned]
    kl = np.asarray(kv_lens, np.int32)
    qs = (np.asarray(q_start, np.int32) if q_start is not None
          else kl - 1)
    return q, kp, vp, bt, kl, qs


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


#: (policy, G) pairs also run through the JAX Pallas kernel in interpret
#: mode — each policy and each G once; the JAX suite itself pins that
#: kernel to the dense reference every case here is held to.
INTERPRET = {("exact", 4), ("rexp", 1), ("lut2d", 2)}


@pytest.mark.parametrize("impl", sorted(TORCH_POLICIES))
@pytest.mark.parametrize("g", [1, 2, 4])
def test_decode_matches_jax_kernel_and_dense(impl, g):
    rng = np.random.default_rng(g)
    q, kp, vp, bt, kl, _ = _problem(rng, kv_lens=(24, 17, 1), g=g)
    out = paged_decode_attention(*_t(q, kp, vp, bt, kl),
                                 TORCH_POLICIES[impl]).numpy()
    jpol = JAX_POLICIES[impl]
    dense = jops.lut_attention_paged_decode(*_j(q, kp, vp, bt, kl), jpol,
                                            backend="dense")
    assert out.shape == q.shape
    np.testing.assert_allclose(out, np.asarray(dense), **TOL)
    if (impl, g) in INTERPRET:
        kernel = jax_paged_decode(*_j(q, kp, vp, bt, kl),
                                  jops._tables_for(jpol), method=jpol.impl,
                                  index_mode=jpol.index_mode, interpret=True)
        np.testing.assert_allclose(out, np.asarray(kernel), **TOL)


@pytest.mark.parametrize("impl,g,q_start,chunk", [
    ("exact", 4, (0, 8, 19), (5, 5, 5)),   # first chunk, mid-prompt, pages
    ("rexp", 1, (3, 0, 12), (5, 2, 4)),    # partial chunks: Lq % C != 0
    ("lut2d", 2, (20, 5, 0), (1, 5, 3)),
    ("rexp", 4, (0, 9, 26), (5, 3, 5)),
    ("lut2d", 1, (7, 0, 16), (2, 5, 5)),
    ("exact", 2, (24, 1, 5), (5, 4, 1)),
])
def test_prefill_matches_jax_kernel_and_dense(impl, g, q_start, chunk):
    rng = np.random.default_rng(10 + g)
    kv = tuple(s + n for s, n in zip(q_start, chunk))
    q, kp, vp, bt, kl, qs = _problem(rng, kv_lens=kv, g=g, c=5,
                                     q_start=q_start)
    out = paged_prefill_attention(*_t(q, kp, vp, bt, qs, kl),
                                  TORCH_POLICIES[impl]).numpy()
    jpol = JAX_POLICIES[impl]
    dense = jops.lut_attention_paged_prefill(
        *_j(q, kp, vp, bt, qs, kl), jpol, backend="dense")
    assert out.shape == q.shape
    np.testing.assert_allclose(out, np.asarray(dense), **TOL)
    if (impl, g) in INTERPRET:
        kernel = jax_paged_prefill(*_j(q, kp, vp, bt, qs, kl),
                                   jops._tables_for(jpol), method=jpol.impl,
                                   index_mode=jpol.index_mode,
                                   interpret=True)
        np.testing.assert_allclose(out, np.asarray(kernel), **TOL)


@pytest.mark.parametrize("index_mode", ["round", "floor"])
@pytest.mark.parametrize("precision", ["int16", "uint4", "uint2"])
def test_dense_decode_matches_jax_across_precisions(precision, index_mode):
    """The remaining table precisions and the floor bin mode, against the
    JAX dense reference (the Pallas kernels share its integer path)."""
    rng = np.random.default_rng(3)
    q, kp, vp, bt, kl, _ = _problem(rng, kv_lens=(21, 6), g=2)
    for impl in ("rexp", "lut2d"):
        tpol = SoftmaxPolicy(impl=impl, precision=precision,
                             index_mode=index_mode)
        jpol = JAX_POLICIES[impl].__class__(impl=impl, precision=precision,
                                            index_mode=index_mode)
        out = tops.lut_attention_paged_decode(*_t(q, kp, vp, bt, kl), tpol,
                                              backend="dense").numpy()
        ref = jops.lut_attention_paged_decode(*_j(q, kp, vp, bt, kl), jpol,
                                              backend="dense")
        np.testing.assert_allclose(out, np.asarray(ref), err_msg=impl, **TOL)


def test_junk_pages_and_permutation_do_not_matter():
    """Poisoning every page a slot does not own, and relabelling the
    physical pages, leaves the plain versions' output unchanged bit for
    bit — the paged indirection is exact."""
    rng = np.random.default_rng(5)
    pol = TORCH_POLICIES["lut2d"]
    q, kp, vp, bt, kl, _ = _problem(rng, kv_lens=(9, 13, 5), g=2)
    base = paged_decode_plain(*_t(q, kp, vp, bt, kl), pol)
    owned = {int(p) for i, n in enumerate(kl)
             for p in bt[i, :-(-int(n) // kp.shape[1])]}
    junk = [p for p in range(kp.shape[0]) if p not in owned]
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[junk], vp2[junk] = 1e6, -1e6
    poisoned = paged_decode_plain(*_t(q, kp2, vp2, bt, kl), pol)
    np.testing.assert_array_equal(poisoned.numpy(), base.numpy())
    perm = np.concatenate([[0], rng.permutation(np.arange(1, kp.shape[0]))])
    kp3, vp3 = np.empty_like(kp), np.empty_like(vp)
    kp3[perm], vp3[perm] = kp, vp
    moved = paged_decode_plain(*_t(q, kp3, vp3, perm[bt].astype(np.int32),
                                   kl), pol)
    np.testing.assert_array_equal(moved.numpy(), base.numpy())


def test_prefill_with_one_row_is_decode():
    """A one-row chunk at q_start = kv_len − 1 is a decode step."""
    rng = np.random.default_rng(6)
    pol = TORCH_POLICIES["rexp"]
    q, kp, vp, bt, kl, qs = _problem(rng, kv_lens=(11, 4), g=2)
    dec = paged_decode_plain(*_t(q, kp, vp, bt, kl), pol)
    pre = paged_prefill_plain(*_t(q, kp, vp, bt, qs, kl), pol)
    np.testing.assert_array_equal(pre.numpy(), dec.numpy())


def test_dispatch_matrix():
    cpu = torch.device("cpu")
    assert tops.resolve_paged_backend("auto", cpu) == "dense"
    assert tops.resolve_paged_backend("dense", cpu) == "dense"
    assert tops.resolve_paged_backend("auto", "cuda") == "cuda"
    assert tops.resolve_paged_backend("cuda", "cuda") == "cuda"
    assert tops.resolve_paged_backend("dense", "cuda") == "dense"
    assert tops.resolve_paged_prefill_backend("auto", cpu) == "dense"
    for resolve in (tops.resolve_paged_backend,
                    tops.resolve_paged_prefill_backend):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            resolve("cuda", cpu)
        with pytest.raises(ValueError, match="unknown"):
            resolve("pallas", cpu)


def test_cuda_backend_on_cpu_tensors_raises():
    """``paged_backend='cuda'`` never falls back: CPU tensors raise in
    both phases, and the kernels' launch counters do not move."""
    rng = np.random.default_rng(7)
    pol = TORCH_POLICIES["rexp"]
    q, kp, vp, bt, kl, qs = _problem(rng, kv_lens=(8, 3), g=2)
    before = (paged_decode_attention.launches,
              paged_prefill_attention.launches)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.lut_attention_paged_decode(*_t(q, kp, vp, bt, kl), pol,
                                        backend="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.lut_attention_paged_prefill(*_t(q, kp, vp, bt, qs, kl), pol,
                                         backend="cuda")
    # auto on the CPU runs the plain version through the kernel wrappers
    out = tops.lut_attention_paged_decode(*_t(q, kp, vp, bt, kl), pol)
    np.testing.assert_array_equal(
        out.numpy(), paged_decode_plain(*_t(q, kp, vp, bt, kl), pol).numpy())
    assert (paged_decode_attention.launches,
            paged_prefill_attention.launches) == before
