"""The paged kernels' split of the keys across a cluster, in plain torch.

``csrc/paged_attn.cuh`` splits each slot's live pages into ``n_split``
contiguous ranges, one a CTA: each CTA takes its range's partial row max
and, given the cluster's max, its partial Σ, then its partial σ·V; the
cluster combines them in rank order.  :func:`split_attention` evaluates
a paged problem that way here — the partial m, Σ and σ·V of each range,
combined rank by rank — with the port's own per-element pipeline
(``kernels.common``), and the tests hold it to:

* the whole row: m and, for the LUT policies, the integer Σ
  ``torch.equal`` to the values over all keys at once (an f32 sum of
  integers below 2^24 is exact in any order);
* the JAX package's ``paged_decode_attention`` / ``paged_prefill_attention``
  (Pallas interpret mode) within the parity suites' tolerance, for n ∈
  {1, 2, 3, 8} page ranges (ranges crossing page boundaries; with 8,
  short slots leave some ranks without keys) and for cuts inside pages,
  on float and int8 pools, every policy, GQA 3 (not a power of two).

The kernels' launcher picks the split on the host from the shapes and
``max_kv_len``, the caller's bound on the live lengths (the gpu tests
hold every config's launch within Hopper's 227 KB a CTA).  Here: the
engine hands every paged call the tightest such bound it knows on the
host (the largest kv_len of the call, never below it), the dispatchers
and wrappers take it, and on CPU tensors it changes nothing.
"""

import functools

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
from repro_torch.configs import ARCHS
from repro_torch.core.lut_softmax import inv_scale
from repro_torch.core.policies import SoftmaxPolicy
from repro_torch.kernels import common
from repro_torch.kernels.lut_attention import ops as tops
from repro_torch.kernels.lut_attention.paged_decode import (
    max_len_arg, paged_decode_attention)
from repro_torch.kernels.lut_attention.paged_prefill import (
    paged_prefill_attention)
from repro_torch.models import build_model
from repro_torch.models import layers as LAYERS
from repro_torch.models import transformer as TF
from repro_torch.runtime.engine import EngineConfig, ServingEngine
from repro_torch.runtime.paged_cache import PagedCacheConfig
from repro_torch.configs import RunConfig

torch.set_num_threads(1)

JAX_POLICIES = strategies.make_policies()
TORCH_POLICIES = {
    "exact": SoftmaxPolicy(),
    "rexp": SoftmaxPolicy(impl="rexp", precision="uint8"),
    "lut2d": SoftmaxPolicy(impl="lut2d", precision="uint8"),
}
TOL = dict(rtol=2e-6, atol=2e-6)
KVH, G, DH, PS, MP, C = 2, 3, 16, 8, 8, 5
KV_LENS = (61, 33, 17, 8, 1)        # partial, whole and single pages
Q_START = (56, 30, 12, 3, 0)        # prefill: chunks of 5, 3, 5, 5, 1


@functools.lru_cache(maxsize=None)
def _problem(pool: str):
    """numpy q, pools (f32, or int8 codes with f32 row scales), permuted
    block tables; junk in the null page and past every live length.  q
    and k are small integers × 2^-2 (int8: codes in [−4, 4] and
    power-of-two scales), so the logits are exact in any order."""
    rng = np.random.default_rng(16)
    b = len(KV_LENS)
    n_pages = 1 + b * MP
    q = rng.integers(-4, 5, size=(b, KVH * G, C, DH)) * 0.25
    if pool == "int8":
        kp, vp = (rng.integers(-4, 5, size=(n_pages, PS, KVH, DH))
                  .astype(np.int8) for _ in range(2))
        ks, vs = (2.0 ** rng.integers(-3, 0, size=(n_pages, PS, KVH))
                  for _ in range(2))
        scales = (ks.astype(np.float32), vs.astype(np.float32))
    else:
        kp = rng.integers(-4, 5, size=(n_pages, PS, KVH, DH)) * 0.25
        vp = rng.normal(size=(n_pages, PS, KVH, DH))
        kp, vp = kp.astype(np.float32), vp.astype(np.float32)
        scales = None
    phys = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((b, MP), np.int32)
    for i, kl in enumerate(KV_LENS):
        bt[i, :-(-kl // PS)] = phys[i * MP:i * MP + -(-kl // PS)]
    return q.astype(np.float32), kp, vp, scales, bt


def _args(phase, pool, lib):
    """(q, k_pages, v_pages, block_tables, q_start, kv_lens, scales kw)
    as torch or jax arrays; decode takes row 0 of each slot's chunk at
    q_start = kv_len − 1."""
    q, kp, vp, scales, bt = _problem(pool)
    kl = np.asarray(KV_LENS, np.int32)
    qs = np.asarray(Q_START, np.int32) if phase == "prefill" else kl - 1
    if phase == "decode":
        q = q[:, :, :1]
    conv = torch.from_numpy if lib == "torch" else jnp.asarray
    kw = ({} if scales is None else
          dict(k_scales=conv(scales[0]), v_scales=conv(scales[1])))
    return (*(conv(np.ascontiguousarray(a)) for a in (q, kp, vp, bt, qs, kl)),
            kw)


@functools.lru_cache(maxsize=None)
def _jax_out(phase, pool, impl):
    q, kp, vp, bt, qs, kl, kw = _args(phase, pool, "jax")
    jpol = JAX_POLICIES[impl]
    common_kw = dict(method=jpol.impl, index_mode=jpol.index_mode,
                     interpret=True, **kw)
    tables = jops._tables_for(jpol)
    if phase == "decode":
        return np.asarray(jax_paged_decode(q, kp, vp, bt, kl, tables,
                                           **common_kw))
    return np.asarray(jax_paged_prefill(q, kp, vp, bt, qs, kl, tables,
                                        **common_kw))


def page_cuts(jmax: int, n: int) -> list[int]:
    """The kernel's ranges: rank r takes pages [r·np/n, (r+1)·np/n) of the
    np = ceil(jmax/ps) live pages, keys clipped to jmax."""
    np_ = -(-jmax // PS)
    return [min(r * np_ // n * PS, jmax) for r in range(n + 1)]


def split_attention(q, kp, vp, bt, q_start, kv_lens, policy, cuts_of, *,
                    k_scales=None, v_scales=None):
    """The kernel's algorithm in plain torch: per slot, the live keys
    [0, jmax) cut at ``cuts_of(jmax)`` into ranges; each range's partial
    max, Σ and σ·V; combined in rank order.  Returns (out, m, Σ) and the
    whole-row (m, Σ)."""
    b, h, c, dh = q.shape
    k, v = tops.gather_kv(kp, vp, bt, kv_lens, k_scales, v_scales)
    kvh = k.shape[1]
    s = tops._logits(q, k, dh ** -0.5)                       # (B,H,C,L)
    ki = torch.arange(k.shape[2])[None, None, None, :]
    qi = (q_start[:, None] + torch.arange(c)[None, :])[:, None, :, None]
    s = s.masked_fill(~((ki <= qi) & (ki < kv_lens[:, None, None, None])),
                      float("-inf"))
    main, aux, _, floats = common.kernel_tables(
        policy.impl, tops._tables_for(policy), policy.index_mode,
        torch.device("cpu"))
    qmax = round(1 / floats[1])
    out = torch.zeros(q.shape)
    m_all, s_all, m_whole, s_whole = [], [], [], []
    for i in range(b):
        kv = int(kv_lens[i])
        jmax = max(min(kv, int(q_start[i]) + c), 0)
        rows = s[i].reshape(h * c, -1)[:, :jmax]               # (R, jmax)
        vi = v[i].repeat_interleave(h // kvh, dim=0)            # (H, L, D)
        cuts = cuts_of(jmax)
        ranges = [(a, z) for a, z in zip(cuts, cuts[1:])]
        m = torch.full((h * c,), float("-inf"))
        for a, z in ranges:                       # partial maxes, in order
            if z > a:
                m = torch.maximum(m, rows[:, a:z].amax(-1))
        m = torch.where(torch.isfinite(m), m, torch.zeros(()))
        whole = rows.amax(-1) if jmax else torch.full((h * c,), -np.inf)
        m_whole.append(torch.where(torch.isfinite(whole), whole,
                                   torch.zeros(())))

        def e_of(x):
            return common.policy_e_terms(x, m, main, policy.impl,
                                         1 / floats[0], policy.index_mode)

        total = torch.zeros(h * c)
        for a, z in ranges:                       # partial Σ, in order
            total = total + e_of(rows[:, a:z]).float().sum(-1)
        s_whole.append(e_of(rows).float().sum(-1))
        acc = torch.zeros(h * c, dh)
        for a, z in ranges:                       # partial σ·V, in order
            e = e_of(rows[:, a:z])
            if policy.impl == "exact":
                w = e / torch.clamp(total, min=1.17549435e-38)[:, None]
            elif policy.impl == "rexp":
                w = common.rexp_sigma(e, total, aux[0], qmax,
                                      policy.index_mode) * inv_scale(qmax)
            else:
                tables = tops._tables_for(policy)
                w = common.lut2d_sigma_int(
                    e, total, aux, qmax, tables.scale_ex, tables.scale_sum,
                    policy.index_mode).float() * inv_scale(qmax)
            vr = vi[:, a:z].repeat_interleave(c, dim=0)         # (R, n, D)
            acc = acc + torch.einsum("rn,rnd->rd", w.float(), vr)
        out[i] = acc.reshape(h, c, dh)
        m_all.append(m)
        s_all.append(total)
    return out, (m_all, s_all), (m_whole, s_whole)


def _check(phase, pool, impl, cuts_of):
    q, kp, vp, bt, qs, kl, kw = _args(phase, pool, "torch")
    pol = TORCH_POLICIES[impl]
    out, (m, S), (m_w, S_w) = split_attention(q, kp, vp, bt, qs, kl, pol,
                                              cuts_of, **kw)
    for a, b_ in zip(m, m_w):
        assert torch.equal(a, b_)
    if impl != "exact":
        for a, b_ in zip(S, S_w):
            assert torch.equal(a, b_)
    np.testing.assert_allclose(out.numpy(), _jax_out(phase, pool, impl),
                               **TOL)


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("impl", sorted(TORCH_POLICIES))
@pytest.mark.parametrize("pool", ["float", "int8"])
@pytest.mark.parametrize("phase", ["decode", "prefill"])
def test_page_ranges_combine_to_the_whole_row(phase, pool, impl, n):
    _check(phase, pool, impl, lambda jmax: page_cuts(jmax, n))


@pytest.mark.parametrize("impl", sorted(TORCH_POLICIES))
@pytest.mark.parametrize("phase", ["decode", "prefill"])
def test_cuts_inside_pages_combine_to_the_whole_row(phase, impl):
    """Ranges that start and end inside pages, some empty."""
    def cuts_of(jmax):
        inner = sorted({min(x, jmax) for x in (3, 3, 13, 29, 40)})
        return [0, *inner, jmax]
    _check(phase, "float", impl, cuts_of)


def test_plain_version_is_the_one_range_split():
    """One range is the plain version itself (the wrappers' CPU path)."""
    q, kp, vp, bt, qs, kl, kw = _args("prefill", "float", "torch")
    pol = TORCH_POLICIES["rexp"]
    out = split_attention(q, kp, vp, bt, qs, kl, pol,
                          lambda jmax: [0, jmax])[0]
    from repro_torch.kernels.lut_attention.paged_prefill import (
        paged_prefill_attention)
    torch.testing.assert_close(out, paged_prefill_attention(
        q, kp, vp, bt, qs, kl, pol), rtol=2e-6, atol=2e-6)


# ---------------------------------------------------------------------------
# The bound on the live lengths that steers the split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("given,passed", [(None, 0), (0, 0), (7, 7),
                                          (8192, 8192)])
def test_max_len_arg(given, passed):
    """None (no bound known) goes to the launcher as 0: split for the
    block table's whole width."""
    assert max_len_arg(given) == passed


def test_negative_max_len_raises():
    with pytest.raises(ValueError):
        max_len_arg(-1)


@pytest.mark.parametrize("bound", [None, 1, 61, 10_000])
@pytest.mark.parametrize("phase", ["decode", "prefill"])
def test_bound_leaves_cpu_results_alone(phase, bound):
    """On CPU tensors the wrappers and dispatchers run the plain version
    whatever the bound, even one below the live lengths."""
    q, kp, vp, bt, qs, kl, _ = _args(phase, "float", "torch")
    pol = TORCH_POLICIES["rexp"]
    if phase == "decode":
        base = paged_decode_attention(q, kp, vp, bt, kl, pol)
        outs = [paged_decode_attention(q, kp, vp, bt, kl, pol,
                                       max_kv_len=bound),
                tops.lut_attention_paged_decode(q, kp, vp, bt, kl, pol,
                                                max_kv_len=bound)]
    else:
        base = paged_prefill_attention(q, kp, vp, bt, qs, kl, pol)
        outs = [paged_prefill_attention(q, kp, vp, bt, qs, kl, pol,
                                        max_kv_len=bound),
                tops.lut_attention_paged_prefill(q, kp, vp, bt, qs, kl, pol,
                                                 max_kv_len=bound)]
    for out in outs:
        assert torch.equal(out, base)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
@pytest.mark.parametrize("prompts", [(3, 19, 40), (9, 9, 33, 2, 17)])
def test_engine_passes_the_tightest_host_bound(monkeypatch, kv_dtype,
                                               prompts):
    """Every paged call of a served drive gets ``max_kv_len`` equal to the
    largest kv_len of that call, which the engine knows on the host: the
    kernel then splits for the live keys, not the block table's width."""
    cfg = ARCHS["qwen3-32b"].scaled_down(d_model=64, n_heads=4,
                                         n_kv_heads=2, vocab=64, n_periods=1)
    model = build_model(cfg)
    params = TF.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    seen = []

    def spy(dispatch, kv_of):
        def call(*args, **kw):
            seen.append((dispatch.__name__, kw["max_kv_len"],
                         int(kv_of(args, kw).max())))
            return dispatch(*args, **kw)
        return call

    monkeypatch.setattr(LAYERS, "lut_attention_paged_decode", spy(
        tops.lut_attention_paged_decode, lambda a, kw: kw["kv_lens"]))
    monkeypatch.setattr(LAYERS, "lut_attention_paged_prefill", spy(
        tops.lut_attention_paged_prefill, lambda a, kw: kw["kv_lens"]))
    run = RunConfig(dtype="float32", kv_dtype=kv_dtype,
                    softmax_policy=TORCH_POLICIES["rexp"])
    eng = ServingEngine(model, params, run, EngineConfig(
        n_slots=3, prefill_chunk=8, cache=PagedCacheConfig(
            n_pages=40, page_size=4, max_pages_per_seq=16)), device="cpu")
    rng = np.random.default_rng(len(prompts))
    for n in prompts:
        eng.add_request(rng.integers(0, 64, size=n).tolist(), 6)
    eng.run()
    kinds = {name for name, _, _ in seen}
    assert kinds == {"lut_attention_paged_decode",
                     "lut_attention_paged_prefill"}
    for name, bound, longest in seen:
        assert bound == longest, (name, bound, longest)
