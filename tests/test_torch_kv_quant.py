"""The port's int8 KV quantization and int8 paged attention against the
JAX package's, on the CPU.

* ``core.quantization``: ``quantize_rows`` gives the same int8 codes and
  the same f32 scales bit for bit as the JAX function (zero rows,
  extreme magnitudes, bf16 input cast to f32 included), and so do
  ``dequantize_rows`` / ``fake_quant_rows`` and the PTQ-D fake
  quantizers; the PTQ-D parameter pass and its error report match.
* The int8 plain paged decode and prefill (what the kernel wrappers run
  on CPU tensors) agree with the JAX package's int8 Pallas kernels in
  interpret mode within 2e-6, the JAX suite's own tolerance
  (``tests/test_kv_quant.py``): the same quantized pool bytes
  (``convert.pool_from_jax``), every policy, G ∈ {1, 4}, permuted block
  tables, junk codes and scales in the null page and NaN scales in
  pages no block table names.  The f32 dot and σ·V contraction sum in
  another order; the integer LUT pipeline is the same.
* Junk — NaN and inf scales included — in the null page changes no bit
  of the plain versions' output, and page relabelling none either.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import strategies
from repro.core import quantization as JQ
from repro.kernels.lut_attention import ops as jops
from repro.runtime.paged_cache import pool_leaf_specs as jax_leaf_specs
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import RunConfig as TRun
from repro_torch.core import quantization as TQ
from repro_torch.core.policies import SoftmaxPolicy
from repro_torch.kernels.lut_attention import ops as tops
from repro_torch.kernels.lut_attention.paged_decode import (
    paged_decode_attention, paged_decode_plain)
from repro_torch.kernels.lut_attention.paged_prefill import (
    paged_prefill_attention, paged_prefill_plain)
from repro_torch.models import build_model as torch_build
from repro_torch.models.convert import pool_from_jax
from repro_torch.runtime.paged_cache import pool_leaf_specs

torch.set_num_threads(1)

JAX_POLICIES = strategies.make_policies()
TORCH_POLICIES = {
    "exact": SoftmaxPolicy(),
    "rexp": SoftmaxPolicy(impl="rexp", precision="uint8"),
    "lut2d": SoftmaxPolicy(impl="lut2d", precision="uint8"),
}
TOL = dict(rtol=2e-6, atol=2e-6)


def _bits(x):
    """Bit pattern of an f32 array: equal bits, not merely equal values
    (so −0 ≠ +0 and NaN payloads count)."""
    return np.asarray(x, np.float32).view(np.int32)


def _rows(case):
    rng = np.random.default_rng(0)
    if case == "normal":
        return rng.normal(size=(5, 7, 16)).astype(np.float32) * 3.0
    if case == "zero_rows":
        x = rng.normal(size=(6, 8)).astype(np.float32)
        x[[1, 4]] = 0.0
        return x
    if case == "extreme":
        return np.array([[1e-30] * 4, [1e30] * 4, [0.0] * 4,
                         [3e38, -3e38, 1.0, -2.0], [1e-45, 0.0, -1e-45, 0.0],
                         [2.5, -2.5, 0.5, 1.5]], np.float32)
    if case == "bf16_cast":
        x = torch.from_numpy(rng.normal(size=(9, 128)).astype(np.float32))
        return x.bfloat16().float().numpy()
    if case == "wide":
        return (rng.normal(size=(40, 128)) * 1e3).astype(np.float32)
    raise ValueError(case)


ROW_CASES = ["normal", "zero_rows", "extreme", "bf16_cast", "wide"]


@pytest.mark.parametrize("case", ROW_CASES)
def test_quantize_rows_bitwise_equal_to_jax(case):
    x = _rows(case)
    jq, js = JQ.quantize_rows(jnp.asarray(x))
    tq, ts = TQ.quantize_rows(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    np.testing.assert_array_equal(
        _bits(TQ.dequantize_rows(tq, ts).numpy()),
        _bits(JQ.dequantize_rows(jq, js)))
    np.testing.assert_array_equal(
        _bits(TQ.fake_quant_rows(torch.from_numpy(x)).numpy()),
        _bits(JQ.fake_quant_rows(jnp.asarray(x))))
    if case == "zero_rows":
        assert np.all(np.isfinite(ts.numpy()))
        assert not TQ.dequantize_rows(tq, ts)[[1, 4]].any()


@pytest.mark.parametrize("case", ROW_CASES)
def test_per_tensor_fake_quant_bitwise_equal_to_jax(case):
    x = _rows(case)
    for qmax in (127.0, 15.0):
        np.testing.assert_array_equal(
            _bits(TQ.fake_quant_symmetric(torch.from_numpy(x), qmax)),
            _bits(JQ.fake_quant_symmetric(jnp.asarray(x), qmax)))
    for qmax in (255.0, 3.0):
        np.testing.assert_array_equal(
            _bits(TQ.fake_quant_affine(torch.from_numpy(x), qmax)),
            _bits(JQ.fake_quant_affine(jnp.asarray(x), qmax)))


def _flat(tree, prefix=""):
    """A JAX parameter tree as ``{path: numpy leaf}``, paths joined the
    way the JAX package's PTQ-D pass reads them."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf) for path, leaf in leaves}


def test_ptqd_matches_jax():
    """The PTQ-D weight pass over a decoder's parameter tree: the same
    leaves snapped, bit for bit, the embedding and 1-D leaves left alone,
    and the same error report."""
    rng = np.random.default_rng(4)

    def w(*shape):
        return (rng.normal(size=shape) * 0.1).astype(np.float32)

    tree = {"embed": {"table": w(128, 64)},
            "periods": [{"mixer": {"wq": w(2, 64, 64), "bq": w(2, 64),
                                   "q_norm": {"scale": w(2, 16)}},
                         "ffn": {"w_up": w(2, 64, 96),
                                 "w_down": w(2, 96, 64)}}],
            "final_norm": {"scale": w(64)},
            "head": {"w": w(64, 128)}}
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jq = JQ.quantize_params_ptqd(jp)
    flat = _flat(jp)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in flat.items()}
    tq = TQ.quantize_params_ptqd(tparams)
    jflat = _flat(jq)
    assert list(tq) == list(jflat)
    for path, t in tq.items():
        np.testing.assert_array_equal(_bits(t.numpy()), _bits(jflat[path]),
                                      err_msg=path)
    # every float leaf of ndim ≥ 2 but the embedding is snapped — the
    # period-stacked biases and norm scales too, as in the JAX package
    changed = {p for p in tq if not torch.equal(tq[p], tparams[p])}
    assert changed == {p for p, t in tparams.items()
                       if t.dim() >= 2 and not p.startswith("embed")}
    jrep = JQ.quantization_error_report(jp, jq)
    trep = TQ.quantization_error_report(tparams, tq)
    assert trep["n_quantized_tensors"] == jrep["n_quantized_tensors"] == 7
    assert trep["max_rel_err"] == pytest.approx(jrep["max_rel_err"],
                                                rel=1e-6)
    assert trep["mean_rel_err"] == pytest.approx(jrep["mean_rel_err"],
                                                 rel=1e-6)


# ---------------------------------------------------------------------------
# int8 paged attention: plain versions against the JAX Pallas kernels
# ---------------------------------------------------------------------------


def _quantized_problem(rng, *, b=3, kvh=2, g=2, dh=16, ps=4, mp=5,
                       kv_lens=(20, 17, 9), lq=1):
    """The JAX suite's int8 paged problem (``tests/test_kv_quant.py``): a
    dense f32 pool quantized with the shared convention, slot i owning
    ceil(kv_lens[i]/ps) pages of a permuted pool.  Then junk: finite
    codes and huge scales in the null page (read by every block table
    past its length), NaN scales and extreme codes in the pages no
    table names.  Returns numpy arrays and the JAX pool."""
    h = kvh * g
    n_pages = 1 + b * mp
    q = rng.normal(size=(b, h, lq, dh)).astype(np.float32)
    kq, ks = JQ.quantize_rows(jnp.asarray(
        rng.normal(size=(n_pages, ps, kvh, dh)).astype(np.float32)))
    vq, vs = JQ.quantize_rows(jnp.asarray(
        rng.normal(size=(n_pages, ps, kvh, dh)).astype(np.float32)))
    phys = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((b, mp), np.int32)
    for i, kl in enumerate(kv_lens):
        n_owned = -(-int(kl) // ps)
        bt[i, :n_owned] = phys[i * mp:i * mp + n_owned]
    unused = np.setdiff1d(np.arange(1, n_pages), bt)
    assert unused.size
    kq, vq = kq.at[0].set(127).at[unused].set(-127), vq.at[0].set(-127)
    ks, vs = ks.at[0].set(1e9).at[unused].set(jnp.nan), \
        vs.at[0].set(1e9).at[unused].set(jnp.nan)
    pool = dict(k_pages=kq, v_pages=vq, k_scales=ks, v_scales=vs)
    return q, bt, np.asarray(kv_lens, np.int32), pool


@pytest.mark.parametrize("impl,g", [("exact", 4), ("rexp", 1),
                                    ("lut2d", 4)])
def test_int8_decode_plain_matches_jax_kernel(impl, g):
    rng = np.random.default_rng(g)
    q, bt, kl, pool = _quantized_problem(rng, g=g, kv_lens=(20, 17, 2))
    jpol = JAX_POLICIES[impl]
    kernel = jops.lut_attention_paged_decode(
        jnp.asarray(q), pool["k_pages"], pool["v_pages"], jnp.asarray(bt),
        jnp.asarray(kl), jpol, backend="pallas", k_scales=pool["k_scales"],
        v_scales=pool["v_scales"])
    tp = pool_from_jax(pool, device="cpu")
    before = paged_decode_attention.int8_launches
    out = tops.lut_attention_paged_decode(
        torch.from_numpy(q), tp["k_pages"], tp["v_pages"],
        torch.from_numpy(bt), torch.from_numpy(kl), TORCH_POLICIES[impl],
        k_scales=tp["k_scales"], v_scales=tp["v_scales"])
    assert paged_decode_attention.int8_launches == before  # the CPU: plain
    assert out.shape == q.shape and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(kernel), **TOL)


@pytest.mark.parametrize("impl,kv_lens", [("exact", (16, 16, 16)),
                                          ("rexp", (19, 3, 7)),
                                          ("lut2d", (19, 3, 7))])
def test_int8_prefill_plain_matches_jax_kernel(impl, kv_lens):
    rng = np.random.default_rng(len(impl) + kv_lens[1])
    c = 4
    q, bt, kl, pool = _quantized_problem(rng, kv_lens=kv_lens, lq=c, g=4)
    qs = np.maximum(kl - c, 0).astype(np.int32)
    kernel = jops.lut_attention_paged_prefill(
        jnp.asarray(q), pool["k_pages"], pool["v_pages"], jnp.asarray(bt),
        jnp.asarray(qs), jnp.asarray(kl), JAX_POLICIES[impl],
        backend="pallas", k_scales=pool["k_scales"],
        v_scales=pool["v_scales"])
    tp = pool_from_jax(pool, device="cpu")
    out = paged_prefill_attention(
        torch.from_numpy(q), tp["k_pages"], tp["v_pages"],
        torch.from_numpy(bt), torch.from_numpy(qs), torch.from_numpy(kl),
        TORCH_POLICIES[impl], k_scales=tp["k_scales"],
        v_scales=tp["v_scales"])
    assert out.shape == q.shape and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(kernel), **TOL)


def test_int8_plain_ignores_nan_junk_and_page_placement():
    """NaN and inf scales (and extreme codes) in the null page — which
    every block table reads past its length — change no output bit of
    either plain version, and relabelling the physical pages, scales
    moving with their pages, changes none either: the masked rows never
    reach σ·V, where 0 · NaN would poison them."""
    rng = np.random.default_rng(5)
    pol = TORCH_POLICIES["lut2d"]
    q, bt, kl, pool = _quantized_problem(rng, kv_lens=(9, 13, 5), lq=3)
    tp = pool_from_jax(pool, device="cpu")
    qs = torch.from_numpy(np.maximum(kl - 3, 0).astype(np.int32))
    args = (torch.from_numpy(q), torch.from_numpy(bt))

    def both(p, bt_):
        dec = paged_decode_plain(args[0][:, :, :1], p["k_pages"],
                                 p["v_pages"], bt_, torch.from_numpy(kl),
                                 pol, k_scales=p["k_scales"],
                                 v_scales=p["v_scales"])
        pre = paged_prefill_plain(args[0], p["k_pages"], p["v_pages"], bt_,
                                  qs, torch.from_numpy(kl), pol,
                                  k_scales=p["k_scales"],
                                  v_scales=p["v_scales"])
        return dec, pre

    base = both(tp, args[1])
    assert all(torch.isfinite(t).all() for t in base)
    poisoned = {k: v.clone() for k, v in tp.items()}
    poisoned["k_scales"][0] = float("nan")
    poisoned["v_scales"][0] = float("inf")
    poisoned["v_scales"][0, 1] = float("nan")
    poisoned["k_pages"][0], poisoned["v_pages"][0] = -128, 127
    for a, b in zip(both(poisoned, args[1]), base):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    perm, inv = strategies.pool_permutation(rng, tp["k_pages"].shape[0])
    inv = torch.from_numpy(inv)
    moved = {k: v[inv] for k, v in tp.items()}
    relabelled = torch.from_numpy(perm.astype(np.int32)[bt])
    for a, b in zip(both(moved, relabelled), base):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_scales_are_required_together_and_checked():
    rng = np.random.default_rng(0)
    q, bt, kl, pool = _quantized_problem(rng)
    tp = pool_from_jax(pool, device="cpu")
    args = (torch.from_numpy(q), tp["k_pages"], tp["v_pages"],
            torch.from_numpy(bt), torch.from_numpy(kl),
            TORCH_POLICIES["exact"])
    with pytest.raises(ValueError, match="both k_scales and v_scales"):
        paged_decode_plain(*args, k_scales=tp["k_scales"])
    with pytest.raises(ValueError, match="both k_scales and v_scales"):
        tops.lut_attention_paged_decode(*args, v_scales=tp["v_scales"])


def test_gather_page_scales_matches_jax():
    rng = np.random.default_rng(3)
    _, bt, _, pool = _quantized_problem(rng)
    ks = np.asarray(pool["k_scales"])
    ks = np.where(np.isnan(ks), -1.0, ks).astype(np.float32)
    ref = np.asarray(jops.gather_page_scales(jnp.asarray(ks),
                                             jnp.asarray(bt)))
    out = tops.gather_page_scales(torch.from_numpy(ks), torch.from_numpy(bt))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_int8_pool_contract_and_allocation_match_jax():
    """The int8 pool's leaves, their shapes and their dtypes: the same
    contract as the JAX package, and ``init_paged_pools`` allocates
    each leaf with its own dtype (int8 pages, f32 scales) whatever the
    run dtype, with the pool bytes per layer of that contract."""
    args = dict(n_pages=16, page_size=8, n_kv_heads=4, head_dim=32)
    assert pool_leaf_specs(**args, kv_dtype="int8") == \
        jax_leaf_specs(**args, kv_dtype="int8")
    arch = TARCHS["qwen3-32b"].scaled_down(d_model=64, n_heads=4,
                                          n_kv_heads=2, vocab=128,
                                          n_periods=2)
    model = torch_build(arch)
    for dtype in ("float32", "bfloat16"):
        pools = model.init_paged_pools(
            8, 4, TRun(dtype=dtype, kv_dtype="int8"), "cpu")
        (pool,) = pools
        assert {k: v.dtype for k, v in pool.items()} == {
            "k_pages": torch.int8, "v_pages": torch.int8,
            "k_scales": torch.float32, "v_scales": torch.float32}
        assert pool["k_pages"].shape == (2, 8, 4, 2, 16)
        assert pool["k_scales"].shape == (2, 8, 4, 2)
        assert not any(v.any() for v in pool.values())
        (f32,) = model.init_paged_pools(8, 4, TRun(dtype=dtype), "cpu")
        assert set(f32) == {"k_pages", "v_pages"}
        assert f32["k_pages"].dtype == getattr(torch, dtype)


def test_cuda_backend_on_cpu_int8_pool_raises():
    """``paged_backend='cuda'`` with an int8 pool on CPU tensors raises in
    both phases — it never falls back to the plain version — and no
    launch counter moves."""
    rng = np.random.default_rng(8)
    q, bt, kl, pool = _quantized_problem(rng, lq=2)
    tp = pool_from_jax(pool, device="cpu")
    qs = torch.from_numpy(np.maximum(kl - 2, 0).astype(np.int32))
    sc = dict(k_scales=tp["k_scales"], v_scales=tp["v_scales"])
    before = (paged_decode_attention.int8_launches,
              paged_prefill_attention.int8_launches)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.lut_attention_paged_decode(
            torch.from_numpy(q[:, :, :1]), tp["k_pages"], tp["v_pages"],
            torch.from_numpy(bt), torch.from_numpy(kl),
            TORCH_POLICIES["rexp"], backend="cuda", **sc)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.lut_attention_paged_prefill(
            torch.from_numpy(q), tp["k_pages"], tp["v_pages"],
            torch.from_numpy(bt), qs, torch.from_numpy(kl),
            TORCH_POLICIES["rexp"], backend="cuda", **sc)
    assert (paged_decode_attention.int8_launches,
            paged_prefill_attention.int8_launches) == before
