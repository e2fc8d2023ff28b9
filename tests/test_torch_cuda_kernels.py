"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: without a CUDA device every test skips (a CUDA kernel
has no CPU mode; its plain version is what the CPU suites hold to the
JAX package).  On the card: ``pytest -m gpu tests/test_torch_cuda_kernels.py``.

Inputs are exact-logit (q, k small integers × 2^-2), so every dot order
gives the same logits and the integer LUT pipeline must agree exactly:
outputs within 2e-6 at every precision, both bin modes, GQA 1/4, odd
head dims, ragged lengths and partial chunks.  The int8-pool kernels get
exact-dequant inputs: codes in [−4, 4] and power-of-two scales, so every
dequantized value and every dot is exact too.  The dense LUT-attention
kernel gets exact-logit inputs in every mode (REXP fused and faithful,
2D-LUT), with and without a cache's ``kv_len``, on every route (the row
engine, the split route, and the tensor-core tile engine for bf16 with
qmax ≤ 255), and the encoder's shape on normal rows, held to one LUT
step.  The split route is also held at the main path's few-row shapes,
at 8192 keys and Dh 256, to the f64 referee within 2e-6 (exact-logit
inputs) and to the plain version within one LUT step (normal rows);
an empty cache gives exact zeros, and every config's widths plan within
227 KB a CTA.  The tile
route is also held, over a grid of Lq ∈ {1, 5, 17, 300}, Lk ∈ {1, 63,
64, 1500}, causal masks with and without ``kv_len`` (0 too), GQA 1 and
8, Dh 64 and 128, uint8 and uint4, to an f64 evaluation of the plain
version's own bins within 2e-6 (at 1500 keys the plain version's f32
σ·V roundoff alone comes near that).

The paged kernels group each KV head's query heads (G = 1 … 12, not
only powers of two) and split the live pages across a thread-block
cluster: they are also held at G 6 and 12, at kv_lens up to 8192 that
cross the split ranges and page boundaries with rows past the logits
cache (recomputed), slots of 0 and 1 keys, and with NaN / inf junk in
the null page and past the live rows of a partial last page, which must
never reach an output (the plain version is given a copy without the
junk: masked keys weigh an exact 0 there, but 0 · NaN is NaN).

The row-wise LUT-softmax kernels take logits as their input, so no dot
order enters: they must be ``torch.equal`` to their plain versions at
every precision (int16 up to 512 columns, where its Σ stays below 2^24),
both bin modes and f32 / bf16 / f16 inputs, with masked, fully masked
and ``+inf`` / ``NaN`` rows, on both routes and every vector width:
the warp route (a row in one warp's registers, 1–2048 columns), the cta
route staged in shared memory in one or two buffers or re-read past
227 KB (4097–65 536 columns), inputs whose rows start off a 16-byte
boundary, a single row and more rows than the persistent grid's CTAs
hold in one pass (cols · qmax < 2^24 throughout: bitwise needs it).
The exact flash-attention kernel holds its plain version's
``(out, m, l)`` within 2e-5 (out) and 1e-5 relative (m, l), and rows that see no key exactly (out 0, m = −inf, l = 0), on
both routes for bf16 and f16 (tiles: the tensor cores, p in three
16-bit pieces) and on the CUDA-core route for f32, also with a cache's
``kv_len`` (one for all sequences, or one each).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.core.policies import SoftmaxPolicy
from repro_torch.core.precision import get_precision
from repro_torch.core.quantization import quantize_rows
from repro_torch.kernels.common import kernel_tables
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda, flash_attention_plain, flash_route)
from repro_torch.kernels.lut_attention import ops
from repro_torch.kernels.lut_softmax import ops as sops
from repro_torch.kernels.lut_softmax.lut_softmax import (
    lut2d_softmax_cuda, lut2d_softmax_plain, plan_for, rexp_softmax_cuda,
    rexp_softmax_plain)
from repro_torch.kernels.lut_attention import ref as dref
from repro_torch.kernels.lut_attention.lut_attention import (
    ROUTES, dense_route, lut_attention_cuda, lut_attention_plain, mode_of)
from repro_torch.core import lut_softmax as lsm
from repro_torch.kernels.lut_attention.paged_decode import (
    paged_decode_attention, paged_decode_plain)
from repro_torch.kernels.lut_attention.paged_prefill import (
    paged_prefill_attention, paged_prefill_plain)

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu

TOL = 2e-6
#: the configs with attention layers (xLSTM has none)
ATTN_ARCHS = sorted(name for name, cfg in ARCHS.items()
                    if any(s.mixer == "attn" for s in cfg.period))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(seed, *, kv_lens, g, c, q_start, dtype, kvh=2, dh=128, ps=16,
             mp=6):
    rng = np.random.default_rng(seed)
    b = len(kv_lens)
    n_pages = 1 + b * mp
    q = rng.integers(-4, 5, size=(b, kvh * g, c, dh)) * 0.25
    kp = rng.integers(-4, 5, size=(n_pages, ps, kvh, dh)) * 0.25
    vp = rng.normal(size=(n_pages, ps, kvh, dh))
    phys = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((b, mp), np.int32)
    for i, kl in enumerate(kv_lens):
        n_owned = -(-int(kl) // ps)
        bt[i, :n_owned] = phys[i * mp:i * mp + n_owned]

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), device="cuda").to(dt)

    return (t(q), t(kp), t(vp), t(bt, torch.int32),
            t(np.asarray(q_start), torch.int32),
            t(np.asarray(kv_lens), torch.int32))


POLICIES = [SoftmaxPolicy()] + [
    SoftmaxPolicy(impl=impl, precision=prec, index_mode=mode)
    for impl in ("rexp", "lut2d") for prec in ("int16", "uint8", "uint4",
                                                "uint2")
    for mode in ("round", "floor")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,dh", [(1, 128), (4, 64), (2, 40), (6, 128),
                                  (12, 128)])
def test_decode_kernel_matches_plain(cuda, dtype, g, dh):
    kv = (96, 33, 1, 0)
    q, kp, vp, bt, _, kl = _problem(g, kv_lens=kv, g=g, c=1, dh=dh,
                                    q_start=[k - 1 for k in kv], dtype=dtype)
    for pol in POLICIES:
        before = paged_decode_attention.launches
        out = paged_decode_attention(q, kp, vp, bt, kl, pol)
        assert paged_decode_attention.launches == before + 1
        ref = paged_decode_plain(q, kp, vp, bt, kl, pol)
        err = float((out - ref).abs().max())
        assert err <= TOL, (pol, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,c", [(1, 16), (4, 5), (2, 1), (6, 16), (12, 16)])
def test_prefill_kernel_matches_plain(cuda, dtype, g, c):
    q_start = (0, 17, 80)
    chunk = (c, max(1, c - 3), c)
    kv = tuple(s + n for s, n in zip(q_start, chunk))
    q, kp, vp, bt, qs, kl = _problem(10 + g, kv_lens=kv, g=g, c=c,
                                     q_start=q_start, dtype=dtype)
    for pol in POLICIES:
        before = paged_prefill_attention.launches
        out = paged_prefill_attention(q, kp, vp, bt, qs, kl, pol)
        assert paged_prefill_attention.launches == before + 1
        ref = paged_prefill_plain(q, kp, vp, bt, qs, kl, pol)
        err = float((out - ref).abs().max())
        assert err <= TOL, (pol, err)


def test_long_rows_recompute_path(cuda):
    """Rows past the shared-memory budget recompute q·k in every pass."""
    kv = (24000, 9000)
    pol = SoftmaxPolicy(impl="rexp", precision="uint8")
    q, kp, vp, bt, _, kl = _problem(3, kv_lens=kv, g=2, c=1, mp=1500,
                                    q_start=[k - 1 for k in kv],
                                    dtype=torch.bfloat16)
    out = paged_decode_attention(q, kp, vp, bt, kl, pol)
    ref = paged_decode_plain(q, kp, vp, bt, kl, pol)
    assert float((out - ref).abs().max()) <= TOL
    qs = kl - 5
    q5 = q.repeat(1, 1, 5, 1)
    out = paged_prefill_attention(q5, kp, vp, bt, qs, kl, pol)
    ref = paged_prefill_plain(q5, kp, vp, bt, qs, kl, pol)
    assert float((out - ref).abs().max()) <= TOL


LONG_KV = (8192, 4111, 1000, 33, 1, 0)


def _plain_f64(q, kp, vp, bt, q_start, kv_lens, pol, **scales):
    """The plain version's own weights (its f32 logits, masks and policy
    softmax) carried through σ·V in f64: over thousands of keys the f32
    σ·V sum's roundoff alone, in any order, comes near 2e-6."""
    k, v = ops.gather_kv(kp, vp, bt, kv_lens, scales.get("k_scales"),
                         scales.get("v_scales"))
    b, h, c, dh = q.shape
    s = ops._logits(q, k, dh ** -0.5)
    ki = torch.arange(k.shape[2], device="cuda")[None, None, None, :]
    qi = (q_start[:, None] + torch.arange(c, device="cuda")[None, :]
          )[:, None, :, None]
    s = s.masked_fill(~((ki <= qi) & (ki < kv_lens[:, None, None, None])),
                      float("-inf"))
    sigma = ops._policy_softmax(s, pol).double()
    kvh = v.shape[1]
    return torch.matmul(sigma.reshape(b, kvh, h // kvh, c, -1),
                        v.double().unsqueeze(2)).reshape(b, h, c, dh)


@pytest.mark.parametrize("pool", ["float", "int8"])
@pytest.mark.parametrize("phase", ["decode", "prefill"])
@pytest.mark.parametrize("g", [6, 12])
def test_split_ranges_and_junk(cuda, g, phase, pool):
    """Block tables 512 pages wide and kv_lens up to 8192 whose live pages
    split across the cluster into ranges that cross page boundaries (and
    prefill rows past the logits cache, which recompute), slots of 0 and
    1 keys, every policy; NaN / inf junk in the null page and in the rows
    past each slot's live length must leave every output finite.  Held to
    the plain version's weights carried in f64: within 2e-6, or twice the
    plain version's own distance from them where that is larger."""
    mp, c = 512, (1 if phase == "decode" else 16)
    kv = LONG_KV if phase == "decode" else (8192, 2040, 16, 3)
    q_start = [max(k - c, 0) for k in kv] if phase == "prefill" else \
        [k - 1 for k in kv]
    if pool == "int8":
        q, kp, vp, bt, qs, kl, sc = _int8_problem(
            50 + g, kv_lens=kv, g=g, c=c, q_start=q_start, mp=mp,
            dtype=torch.bfloat16)
    else:
        q, kp, vp, bt, qs, kl = _problem(50 + g, kv_lens=kv, g=g, c=c,
                                         q_start=q_start, mp=mp,
                                         dtype=torch.bfloat16)
        sc = {}
    ckp, cvp, clean = kp, vp, {}
    if pool == "int8":
        # NaN / inf scales in the null page, and past each live length
        for i, n in enumerate(kv):
            if n % 16:
                page = int(bt[i, n // 16])
                sc["k_scales"][page, n % 16:] = float("nan")
                sc["v_scales"][page, n % 16:] = float("inf")
        clean = {n: t.nan_to_num(0, 0, 0) for n, t in sc.items()}
    else:
        # junk in the null page and past each live length in its page
        ckp, cvp = kp.clone(), vp.clone()
        for t in (kp, vp):
            t[0] = float("nan")
            t[0, 0] = float("inf")
        for i, n in enumerate(kv):
            if n % 16:
                page = int(bt[i, n // 16])
                kp[page, n % 16:] = float("nan")
                vp[page, n % 16:] = float("inf")
                ckp[page, n % 16:] = vp.new_zeros(())
                cvp[page, n % 16:] = vp.new_zeros(())
        for t in (ckp, cvp):
            t[0] = 0
    if phase == "decode":
        kernel, plain = paged_decode_attention, paged_decode_plain
        args, cargs = (q, kp, vp, bt, kl), (q, ckp, cvp, bt, kl)
    else:
        kernel, plain = paged_prefill_attention, paged_prefill_plain
        args, cargs = (q, kp, vp, bt, qs, kl), (q, ckp, cvp, bt, qs, kl)
    # uint8 keeps Σ ≤ 8192 · 255 below 2^24, where it is exact in f32
    for pol in [SoftmaxPolicy()] + [
            SoftmaxPolicy(impl=impl, precision="uint8", index_mode=mode)
            for impl, mode in (("rexp", "round"), ("rexp", "floor"),
                               ("lut2d", "round"))]:
        out = kernel(*args, pol, **sc)
        assert torch.isfinite(out).all(), pol
        ref = plain(*cargs, pol, **clean)
        qs_all = qs if phase == "prefill" else kl - 1
        f64 = _plain_f64(q, ckp, cvp, bt, qs_all, kl, pol, **clean)
        k_err = float((out.double() - f64).abs().max())
        p_err = float((ref.double() - f64).abs().max())
        assert k_err <= max(TOL, 2 * p_err), (pol, k_err, p_err)


@pytest.mark.parametrize("phase", ["decode", "prefill"])
@pytest.mark.parametrize("bound", [None, "tight", 1, 100_000])
def test_max_kv_len_steers_only_the_split(cuda, bound, phase):
    """The caller's bound on the live lengths picks the split (``None``:
    the table's whole width; "tight": the longest kv_len; 1: below most
    slots, which are then walked unsplit; past the table): every choice
    gives the plain version's result."""
    mp, c = 512, (1 if phase == "decode" else 16)
    kv = (4111, 1000, 33, 1, 0)
    q_start = [k - 1 for k in kv] if phase == "decode" else \
        [max(k - c, 0) for k in kv]
    q, kp, vp, bt, qs, kl = _problem(70, kv_lens=kv, g=6, c=c, mp=mp,
                                     q_start=q_start, dtype=torch.bfloat16)
    max_kv_len = max(kv) if bound == "tight" else bound
    pol = SoftmaxPolicy(impl="rexp", precision="uint8")
    if phase == "decode":
        out = paged_decode_attention(q, kp, vp, bt, kl, pol,
                                     max_kv_len=max_kv_len)
        ref = paged_decode_plain(q, kp, vp, bt, kl, pol)
    else:
        out = paged_prefill_attention(q, kp, vp, bt, qs, kl, pol,
                                      max_kv_len=max_kv_len)
        ref = paged_prefill_plain(q, kp, vp, bt, qs, kl, pol)
    assert float((out - ref).abs().max()) <= TOL


@pytest.mark.parametrize("impl", ["exact", "rexp"])
@pytest.mark.parametrize("pool", ["float", "int8"])
@pytest.mark.parametrize("phase", ["decode", "prefill"])
def test_plan_kv_heads_gives_the_whole_models_arithmetic(cuda, phase, pool,
                                                         impl):
    """A tensor-parallel 'heads' rank's call — 4 of the model's 8 KV
    heads, planned with ``plan_kv_heads=8`` — is ``torch.equal`` to those
    heads of the 8-head call on random rows (whose sums depend on the
    split): each head's keys split, and sum, as in the whole launch."""
    c = 1 if phase == "decode" else 16
    kv = (2000, 1500, 700, 33)
    q_start = [k - 1 for k in kv] if phase == "decode" else \
        [k - c for k in kv]
    g, kvh, half = 8, 8, 4
    pol = SoftmaxPolicy(impl=impl, precision="uint8") if impl != "exact" \
        else SoftmaxPolicy()
    if pool == "int8":
        q, kp, vp, bt, qs, kl, sc = _int8_problem(
            90, kv_lens=kv, g=g, c=c, q_start=q_start, kvh=kvh, mp=128,
            dtype=torch.bfloat16, exact=False)
    else:
        q, kp, vp, bt, qs, kl = _problem(90, kv_lens=kv, g=g, c=c, mp=128,
                                         q_start=q_start, kvh=kvh,
                                         dtype=torch.bfloat16)
        q = torch.randn(q.shape, generator=torch.Generator(
            device="cuda").manual_seed(5), device="cuda").to(q.dtype)
        kp = torch.randn(kp.shape, generator=torch.Generator(
            device="cuda").manual_seed(6), device="cuda").to(kp.dtype)
        sc = {}

    def call(q, kp, vp, sc, **kw):
        if phase == "decode":
            return paged_decode_attention(q, kp, vp, bt, kl, pol,
                                          max_kv_len=max(kv), **sc, **kw)
        return paged_prefill_attention(q, kp, vp, bt, qs, kl, pol,
                                       max_kv_len=max(kv), **sc, **kw)

    whole = call(q, kp, vp, sc)
    heads = slice(half, kvh)
    part = call(q[:, half * g:].contiguous(), kp[:, :, heads].contiguous(),
                vp[:, :, heads].contiguous(),
                {k: v[:, :, heads].contiguous() for k, v in sc.items()},
                plan_kv_heads=kvh)
    assert torch.equal(part, whole[:, half * g:])
    with pytest.raises(ValueError, match="plan_kv_heads"):
        call(q[:, half * g:].contiguous(), kp[:, :, heads].contiguous(),
             vp[:, :, heads].contiguous(),
             {k: v[:, :, heads].contiguous() for k, v in sc.items()},
             plan_kv_heads=half - 1)


@pytest.mark.parametrize("phase", ["decode", "prefill"])
@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_every_config_fits_a_cta(cuda, arch, phase):
    """Every config's attention widths, on f32, bf16 and int8 pools with
    block tables 2048 pages wide (the launcher sizes the logits cache for
    that width): the launch stays within Hopper's 227 KB a CTA (it
    refuses a plan that does not) and matches the plain version."""
    cfg = ARCHS[arch]
    g, kvh, dh = cfg.n_heads // cfg.n_kv_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    c = 1 if phase == "decode" else 16
    kv = (40,)
    q_start = [39] if phase == "decode" else [24]
    pol = SoftmaxPolicy(impl="lut2d", precision="uint8")
    for pool, dtype in (("float", torch.float32), ("float", torch.bfloat16),
                        ("int8", torch.float32), ("int8", torch.bfloat16)):
        if pool == "int8":
            q, kp, vp, bt, qs, kl, sc = _int8_problem(
                80, kv_lens=kv, g=g, c=c, q_start=q_start, kvh=kvh, dh=dh,
                mp=3, dtype=dtype)
        else:
            q, kp, vp, bt, qs, kl = _problem(80, kv_lens=kv, g=g, c=c,
                                             q_start=q_start, kvh=kvh,
                                             dh=dh, mp=3, dtype=dtype)
            sc = {}
        wide = torch.zeros((1, 2048), dtype=torch.int32, device="cuda")
        wide[:, :3] = bt
        if phase == "decode":
            out = paged_decode_attention(q, kp, vp, wide, kl, pol, **sc)
            ref = paged_decode_plain(q, kp, vp, bt, kl, pol, **sc)
        else:
            out = paged_prefill_attention(q, kp, vp, wide, qs, kl, pol, **sc)
            ref = paged_prefill_plain(q, kp, vp, bt, qs, kl, pol, **sc)
        assert float((out - ref).abs().max()) <= TOL, (pool, dtype)


def test_dispatch_on_cuda(cuda):
    """``auto``/``cuda`` launch the kernel, ``dense`` never does; bad
    inputs raise instead of launching."""
    pol = SoftmaxPolicy(impl="lut2d", precision="uint8")
    q, kp, vp, bt, _, kl = _problem(4, kv_lens=(20, 3), g=2, c=1,
                                    q_start=(19, 2), dtype=torch.bfloat16)
    n = paged_decode_attention.launches
    ops.lut_attention_paged_decode(q, kp, vp, bt, kl, pol, backend="auto")
    ops.lut_attention_paged_decode(q, kp, vp, bt, kl, pol, backend="cuda")
    ops.lut_attention_paged_decode(q, kp, vp, bt, kl, pol, backend="dense")
    assert paged_decode_attention.launches == n + 2
    with pytest.raises(ValueError):
        paged_decode_attention(q, kp.float(), vp, bt, kl, pol)
    with pytest.raises(ValueError):
        paged_decode_attention(q, kp, vp, bt[:1], kl, pol)
    with pytest.raises(TypeError):
        paged_decode_attention(q.half(), kp.half(), vp.half(), bt, kl, pol)
    assert paged_decode_attention.launches == n + 2


def _int8_problem(seed, *, kv_lens, g, c, q_start, dtype, kvh=2, dh=128,
                  ps=16, mp=6, exact=True, scale_exps=(-3, -1)):
    """An int8 pool with f32 row scales: exact-dequant or quantized normal
    rows; junk codes and NaN / inf scales in the null page, which every
    block table reads past its length.

    Exact-dequant: codes in [−4, 4] and power-of-two scales 2^e for e in
    ``scale_exps`` (inclusive), by default 2^−3 … 2^−1, so |k|, |v| ≤ 2
    and the problem is conditioned like the float pools' exact-logit one
    (wider scales pile the exact policy's weights onto few large |v| and
    its f32 σ·V roundoff grows in any summation order: see
    :func:`test_int8_kernels_on_wide_scale_exact_dequant`).
    """
    rng = np.random.default_rng(seed)
    b = len(kv_lens)
    n_pages = 1 + b * mp
    q = rng.integers(-4, 5, size=(b, kvh * g, c, dh)) * 0.25
    pools = []
    for _ in range(2):
        if exact:
            codes = torch.from_numpy(rng.integers(
                -4, 5, size=(n_pages, ps, kvh, dh)).astype(np.int8))
            scales = torch.from_numpy(2.0 ** rng.integers(
                scale_exps[0], scale_exps[1] + 1,
                size=(n_pages, ps, kvh)).astype(np.float32))
        else:
            codes, scales = quantize_rows(torch.from_numpy(
                rng.normal(size=(n_pages, ps, kvh, dh)).astype(np.float32)))
        codes[0], scales[0] = 127, float("nan")
        scales[0, 0] = float("inf")
        pools += [codes.cuda(), scales.cuda()]
    phys = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((b, mp), np.int32)
    for i, kl in enumerate(kv_lens):
        n_owned = -(-int(kl) // ps)
        bt[i, :n_owned] = phys[i * mp:i * mp + n_owned]

    def t(x, dt):
        return torch.as_tensor(np.asarray(x), device="cuda").to(dt)

    kp, ks, vp, vs = pools
    return (t(q, dtype), kp, vp, t(bt, torch.int32),
            t(q_start, torch.int32), t(kv_lens, torch.int32),
            dict(k_scales=ks, v_scales=vs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,dh", [(1, 128), (4, 64), (2, 40), (6, 128),
                                  (12, 128)])
def test_int8_decode_kernel_matches_plain(cuda, dtype, g, dh):
    kv = (96, 33, 1, 0)
    q, kp, vp, bt, _, kl, sc = _int8_problem(
        20 + g, kv_lens=kv, g=g, c=1, dh=dh, q_start=[k - 1 for k in kv],
        dtype=dtype)
    args = (q, kp, vp, bt, kl)
    errs = {}
    for pol in POLICIES:
        before = (paged_decode_attention.launches,
                  paged_decode_attention.int8_launches)
        out = paged_decode_attention(*args, pol, **sc)
        assert (paged_decode_attention.launches,
                paged_decode_attention.int8_launches) == (before[0],
                                                          before[1] + 1)
        ref = paged_decode_plain(*args, pol, **sc)
        assert torch.isfinite(out).all()
        errs[pol] = float((out - ref).abs().max())
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,c,dh", [(1, 16, 128), (4, 5, 64), (2, 1, 40),
                                    (6, 16, 128), (12, 16, 128)])
def test_int8_prefill_kernel_matches_plain(cuda, dtype, g, c, dh):
    q_start = (0, 17, 80)
    chunk = (c, max(1, c - 3), c)
    kv = tuple(s + n for s, n in zip(q_start, chunk))
    q, kp, vp, bt, qs, kl, sc = _int8_problem(
        30 + g, kv_lens=kv, g=g, c=c, dh=dh, q_start=q_start, dtype=dtype)
    args = (q, kp, vp, bt, qs, kl)
    errs = {}
    for pol in POLICIES:
        before = paged_prefill_attention.int8_launches
        out = paged_prefill_attention(*args, pol, **sc)
        assert paged_prefill_attention.int8_launches == before + 1
        ref = paged_prefill_plain(*args, pol, **sc)
        assert torch.isfinite(out).all()
        errs[pol] = float((out - ref).abs().max())
    assert max(errs.values()) <= TOL, errs


def _exact_f64(q, kp, vp, bt, q_start, kv_lens, k_scales, v_scales):
    """Exact-softmax paged attention on the host, for the valid rows (row
    r of slot b below kv_len − q_start; others 0): the f32 logits both
    versions form (dots exact on these inputs, times the scale in f32),
    then the softmax and σ·V in f64."""
    q, bt = q.double().cpu(), bt.long().cpu()
    k = (kp.double() * k_scales.double()[..., None]).cpu()
    v = (vp.double() * v_scales.double()[..., None]).cpu()
    b, h, _, dh = q.shape
    ps, kvh = k.shape[1], k.shape[2]
    out = torch.zeros(q.shape, dtype=torch.float64)
    for i in range(b):
        n, s = int(kv_lens[i]), int(q_start[i])
        pages = bt[i, :-(-n // ps)]
        ki, vi = (x[pages].reshape(-1, kvh, dh)[:n].repeat_interleave(
            h // kvh, dim=1) for x in (k, v))
        logits = (torch.einsum("hrd,nhd->hrn", q[i, :, :n - s], ki)
                  .float() * dh ** -0.5).double()
        later = (torch.arange(n)[None, :]
                 > s + torch.arange(n - s)[:, None])
        out[i, :, :n - s] = torch.einsum(
            "hrn,nhd->hrd", logits.masked_fill(later, float("-inf"))
            .softmax(-1), vi)
    return out


@pytest.mark.parametrize("phase", ["decode", "prefill"])
def test_int8_kernels_on_wide_scale_exact_dequant(cuda, phase):
    """Exact-dequant inputs with K/V scales up to 2^1 (|k|, |v| ≤ 8) at
    Qwen3-32B width (64/8 heads, Dh 128).  The logits span about ±14 and
    the exact policy's weights pile onto few keys of large |v|: its f32
    σ·V sum sits near max|v| while hundreds of small terms are added,
    each rounding by up to half an ulp of it, in any order.  The kernel
    and the plain version are each within 16 ulp of max|v| of the same
    f32 logits carried on in f64, and of each other: twice the 8.4 ulp
    that 2e-6 is at the narrow range's max|v| = 2, as the plain version
    itself comes to 8.2 ulp here on an H100.  The LUT policies pile
    their weights alike and are held to the same limit against the plain
    version (their bins are held at 2e-6 on the narrow range)."""
    if phase == "decode":
        kv, c, mp = (512, 301, 77, 1), 1, 32
        q_start = [k - 1 for k in kv]
    else:
        kv, c, mp, q_start = (300,), 16, 19, (288,)
    q, kp, vp, bt, qs, kl, sc = _int8_problem(
        40, kv_lens=kv, g=8, kvh=8, c=c, q_start=q_start, mp=mp,
        dtype=torch.bfloat16, scale_exps=(-3, 1))
    args = (q, kp, vp, bt, kl) if phase == "decode" else \
        (q, kp, vp, bt, qs, kl)
    kernel, plain = ((paged_decode_attention, paged_decode_plain)
                     if phase == "decode" else
                     (paged_prefill_attention, paged_prefill_plain))
    rows = min(k - s for k, s in zip(kv, q_start))   # valid in every slot
    out = kernel(*args, SoftmaxPolicy(), **sc)[:, :, :rows].double().cpu()
    ref = plain(*args, SoftmaxPolicy(), **sc)[:, :, :rows].double().cpu()
    f64 = _exact_f64(q, kp, vp, bt, qs, kl, **sc)[:, :, :rows]
    vmax = max(float((vp[p].double() * sc["v_scales"][p].double()[..., None]
                      ).abs().max()) for p in bt[bt > 0].unique().tolist())
    limit = 16 * torch.finfo(torch.float32).eps * vmax
    dist = {"kernel-f64": float((out - f64).abs().max()),
            "plain-f64": float((ref - f64).abs().max()),
            "kernel-plain": float((out - ref).abs().max())}
    print(f"{phase}: max|v| {vmax}, limit {limit:.3e}, " + ", ".join(
        f"{k} {v:.3e}" for k, v in dist.items()))
    assert max(dist.values()) <= limit, dist
    errs = {pol: float((kernel(*args, pol, **sc) - plain(*args, pol, **sc))
                       .abs().max()) for pol in POLICIES[1:]}
    print(f"{phase}: LUT policies kernel-plain {max(errs.values()):.3e}")
    assert max(errs.values()) <= limit, errs


@pytest.mark.parametrize("impl", ["exact", "rexp", "lut2d"])
def test_int8_kernels_on_quantized_random_rows(cuda, impl):
    """Random rows through ``quantize_rows``: within one LUT step of the
    plain version (the dot orders differ, so a logit on a bin edge may
    land in the neighbouring bin); 1e-4 · max|v| for exact."""
    pol = (SoftmaxPolicy(impl=impl, precision="uint8") if impl != "exact"
           else SoftmaxPolicy())
    kv = (200, 77, 16)
    q, kp, vp, bt, qs, kl, sc = _int8_problem(
        7, kv_lens=kv, g=4, c=8, q_start=[k - 8 for k in kv],
        dtype=torch.bfloat16, mp=14, exact=False)
    q = torch.randn(q.shape, generator=torch.Generator("cuda").manual_seed(0),
                    device="cuda").to(torch.bfloat16)
    vmax = float((vp.float() * sc["v_scales"][..., None]).nan_to_num(
        0, 0, 0)[1:].abs().max())
    limit = (2.0 / get_precision("uint8").qmax if impl != "exact"
             else 1e-4) * vmax
    for kernel, plain, args in (
            (paged_decode_attention, paged_decode_plain,
             (q[:, :, :1], kp, vp, bt, kl)),
            (paged_prefill_attention, paged_prefill_plain,
             (q, kp, vp, bt, qs, kl))):
        out = kernel(*args, pol, **sc)
        ref = plain(*args, pol, **sc)
        assert float((out - ref).abs().max()) <= limit


def test_int8_inputs_the_kernels_do_not_take_raise(cuda):
    """Head dims off the kernels' grid, scales of the wrong type, shape or
    device, a lone scale pool and a float pool with scales all raise
    before any launch."""
    pol = SoftmaxPolicy(impl="rexp", precision="uint8")
    for dh in (36, 264):
        q, kp, vp, bt, _, kl, sc = _int8_problem(
            1, kv_lens=(20, 3), g=2, c=1, dh=dh, q_start=(19, 2),
            dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="Dh"):
            paged_decode_attention(q, kp, vp, bt, kl, pol, **sc)
    q, kp, vp, bt, qs, kl, sc = _int8_problem(
        2, kv_lens=(20, 3), g=2, c=4, q_start=(16, 0), dtype=torch.float32)
    n = (paged_decode_attention.int8_launches,
         paged_prefill_attention.int8_launches)
    bad = [dict(sc, k_scales=sc["k_scales"].double()),
           dict(sc, v_scales=sc["v_scales"][:, :, :1]),
           dict(sc, k_scales=sc["k_scales"].cpu()),
           dict(k_scales=sc["k_scales"])]
    for kw in bad:
        with pytest.raises(ValueError):
            paged_prefill_attention(q, kp, vp, bt, qs, kl, pol, **kw)
    with pytest.raises(ValueError):
        paged_prefill_attention(q, kp.float(), vp.float(), bt, qs, kl, pol,
                                **sc)
    with pytest.raises(ValueError):
        paged_decode_attention(q[:, :, :1], kp, vp, bt, kl, pol)
    assert (paged_decode_attention.int8_launches,
            paged_prefill_attention.int8_launches) == n


# ---------------------------------------------------------------------------
# Dense LUT attention (csrc/lut_attention.cu)
# ---------------------------------------------------------------------------


def _dense_problem(seed, *, b, h, kvh, lq, lk, dh, dtype, exact=True):
    """Contiguous q (B, H, Lq, Dh), k / v (B, KVH, Lk, Dh) on the card:
    exact-logit q, k (small integers × 2^-2) or normal rows."""
    rng = np.random.default_rng(seed)
    if exact:
        q = rng.integers(-4, 5, size=(b, h, lq, dh)) * 0.25
        k = rng.integers(-4, 5, size=(b, kvh, lk, dh)) * 0.25
    else:
        q = rng.normal(size=(b, h, lq, dh))
        k = rng.normal(size=(b, kvh, lk, dh))
    v = rng.normal(size=(b, kvh, lk, dh))
    return [torch.as_tensor(x, device="cuda").to(dtype) for x in (q, k, v)]


#: (B, H, KVH, Lq, Lk, Dh, causal, kv_len)
DENSE_CASES = [
    (2, 12, 12, 40, 40, 64, False, None),   # encoder self-attention
    (2, 12, 12, 1, 300, 64, False, None),   # cross-attention, a decode step
    (2, 12, 12, 8, 300, 64, False, None),   # cross-attention, a prefill
    (2, 12, 12, 1, 64, 64, True, 40),       # cached self-attention, decode
    (2, 12, 12, 8, 64, 64, True, 40),       # cached self-attention, prefill
    (1, 8, 2, 13, 200, 128, True, None),    # GQA 4, Lk not a multiple of 8
    (1, 4, 2, 5, 48, 40, True, 33),         # odd head dim, GQA 2
    (1, 64, 8, 20, 52, 128, True, 20),      # Qwen3-32B lockstep prefill
    (2, 64, 8, 1, 52, 128, True, 21),       # Qwen3-32B lockstep decode
]

DENSE_POLICIES = [
    SoftmaxPolicy(impl=impl, precision=prec, index_mode=mode)
    for impl in ("rexp", "lut2d") for prec in ("int16", "uint8", "uint4",
                                                "uint2")
    for mode in ("round", "floor")]


def _dense_call(fn, q, k, v, pol, causal, kv_len, fused, **kw):
    return fn(q, k, v, ops._tables_for(pol), method=pol.impl, causal=causal,
              index_mode=pol.index_mode, fused_requant=fused, kv_len=kv_len,
              **kw)


@pytest.mark.parametrize("dtype,route", [(torch.float32, "simt"),
                                         (torch.bfloat16, "simt"),
                                         (torch.bfloat16, "tiles"),
                                         (torch.float32, "split"),
                                         (torch.bfloat16, "split")])
@pytest.mark.parametrize("case", DENSE_CASES, ids=str)
def test_dense_kernel_matches_plain(cuda, dtype, route, case):
    """Every mode (REXP fused and faithful, 2D-LUT) at every precision
    (int16's numerators go through the tile route in two pieces) and both
    bin modes, one launch counted per call in its mode and its route."""
    b, h, kvh, lq, lk, dh, causal, kv_len = case
    q, k, v = _dense_problem(lq * 7 + lk, b=b, h=h, kvh=kvh, lq=lq, lk=lk,
                             dh=dh, dtype=dtype)
    for pol in DENSE_POLICIES:
        for fused in ((False, True) if pol.impl == "rexp" else (False,)):
            mode = mode_of(pol.impl, fused)
            before = (lut_attention_cuda.launches[mode],
                      lut_attention_cuda.route_launches[route])
            out = _dense_call(lut_attention_cuda, q, k, v, pol, causal,
                              kv_len, fused, route=route)
            assert (lut_attention_cuda.launches[mode],
                    lut_attention_cuda.route_launches[route]) == (
                        before[0] + 1, before[1] + 1)
            ref = _dense_call(lut_attention_plain, q, k, v, pol, causal,
                              kv_len, fused)
            err = float((out - ref).abs().max())
            assert err <= TOL, (pol, fused, err)


def _dense_f64(q, k, v, pol, causal, kv_len, fused):
    """The plain version's own f32 logits and integer LUT pipeline, with
    the final σ·V (REXP fused: Σ e·v, then the f32 α factor) carried in
    f64: the referee that tells a kernel's f32 σ·V roundoff from the
    plain version's."""
    tables = ops._tables_for(pol)
    s = dref._logits(q, k, q.shape[-1] ** -0.5, causal, kv_len)
    vx = v.double().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    if fused:
        inv = lsm.inv_scale(tables.precision.qmax)
        e = lsm.rexp_exp_int(s, tables, axis=-1, index_mode=pol.index_mode)
        ja = lsm.rexp_alpha_index(e.float().sum(-1, keepdim=True), tables,
                                  pol.index_mode)
        alpha = torch.as_tensor(tables.lut_alpha, dtype=torch.int32,
                                device=q.device)[ja]
        return (torch.matmul(e.double(), vx)
                * (alpha.float() * inv * inv).double())
    soft = lsm.softmax_rexp if pol.impl == "rexp" else lsm.softmax_lut2d
    return torch.matmul(soft(s, tables, axis=-1,
                             index_mode=pol.index_mode).double(), vx)


#: (causal, kv_len as a function of Lk): no mask, a cache's valid length,
#: causal over every key, causal over a valid length, and an empty cache
TILE_MASKS = [(False, None), (False, lambda lk: lk // 2 + 1),
              (True, None), (True, lambda lk: max(lk - 7, 1)),
              (True, lambda lk: 0)]


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("lk", [1, 63, 64, 1500])
@pytest.mark.parametrize("lq", [1, 5, 17, 300])
def test_dense_tile_route_matches_f64(cuda, lq, lk, dh):
    """The tile route on exact-logit inputs — ragged Lq and Lk around the
    64-row and 64-key tiles, every mask, GQA 1 and 8, uint8 and uint4,
    every mode — within 2e-6 of the plain version's bins carried on in
    f64; masked rows (an empty cache) exactly 0."""
    for g in (1, 8):
        q, k, v = _dense_problem(lq + 3 * lk + g + dh, b=2, h=2 * g, kvh=2,
                                 lq=lq, lk=lk, dh=dh, dtype=torch.bfloat16)
        for causal, kv_of in TILE_MASKS:
            kv_len = kv_of(lk) if kv_of else None
            for prec in ("uint8", "uint4"):
                for impl, fused in (("rexp", True), ("rexp", False),
                                    ("lut2d", False)):
                    pol = SoftmaxPolicy(impl=impl, precision=prec)
                    out = _dense_call(lut_attention_cuda, q, k, v, pol,
                                      causal, kv_len, fused, route="tiles")
                    ref = _dense_f64(q, k, v, pol, causal, kv_len, fused)
                    err = float((out.double() - ref).abs().max())
                    assert err <= TOL, (g, causal, kv_len, prec, impl,
                                        fused, err)
                    if kv_len == 0:
                        assert not out.any()


def test_dense_kernel_on_random_inputs_at_the_encoder_shape(cuda):
    """Whisper's encoder shape (Lq = Lk = 1500, Dh 64) on normal rows:
    within one LUT step of the plain version in every mode on both routes
    (the dot orders differ; a logit on a bin edge may move one bin)."""
    pol_r = SoftmaxPolicy(impl="rexp", precision="uint8")
    pol_l = SoftmaxPolicy(impl="lut2d", precision="uint8")
    q, k, v = _dense_problem(21, b=1, h=12, kvh=12, lq=1500, lk=1500, dh=64,
                             dtype=torch.bfloat16, exact=False)
    limit = 2.0 / get_precision("uint8").qmax * float(v.float().abs().max())
    for pol, fused in ((pol_r, True), (pol_r, False), (pol_l, False)):
        ref = _dense_call(lut_attention_plain, q, k, v, pol, False, None,
                          fused)
        for route in ROUTES:
            out = _dense_call(lut_attention_cuda, q, k, v, pol, False, None,
                              fused, route=route)
            assert float((out - ref).abs().max()) <= limit, (pol, fused,
                                                              route)


#: the few-row calls of the main path (chip_smoke.DENSE_CASES: Whisper's
#: decode steps and a short prefill chunk, Qwen3-32B's lockstep decode),
#: long caches and the wide head dims — (B, H, KVH, Lq, Lk, Dh, causal,
#: kv_len)
SPLIT_CASES = [
    (4, 12, 12, 1, 1500, 64, False, None),   # Whisper cross decode
    (4, 12, 12, 7, 1500, 64, False, None),   # Whisper cross prefill
    (4, 12, 12, 1, 64, 64, True, 40),        # Whisper self decode
    (4, 12, 12, 5, 64, 64, True, 40),        # Whisper self prefill
    (4, 64, 8, 1, 332, 128, True, 301),      # Qwen3-32B lockstep decode
    (1, 8, 2, 3, 8192, 128, True, 8000),     # a long cache, GQA 4
    (2, 4, 4, 1, 8192, 64, False, None),     # long, one row a block
    (2, 4, 2, 2, 700, 256, True, 650),       # Dh 256, GQA 2
    (1, 6, 2, 7, 300, 128, True, 5),         # causal rows that see nothing
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_dense_split_route_matches_f64(cuda, case, dtype):
    """The split route in every mode on exact-logit inputs within 2e-6 of
    the plain version's bins carried on in f64, and on normal rows within
    one LUT step of the plain version; each call counted on its route."""
    b, h, kvh, lq, lk, dh, causal, kv_len = case
    pol_r = SoftmaxPolicy(impl="rexp", precision="uint8")
    pol_l = SoftmaxPolicy(impl="lut2d", precision="uint8")
    for exact in (True, False):
        q, k, v = _dense_problem(lq + lk + dh + exact, b=b, h=h, kvh=kvh,
                                 lq=lq, lk=lk, dh=dh, dtype=dtype,
                                 exact=exact)
        limit = 2.0 / get_precision("uint8").qmax * float(
            v.float().abs().max())
        for pol, fused in ((pol_r, True), (pol_r, False), (pol_l, False)):
            n = lut_attention_cuda.route_launches["split"]
            out = _dense_call(lut_attention_cuda, q, k, v, pol, causal,
                              kv_len, fused, route="split")
            assert lut_attention_cuda.route_launches["split"] == n + 1
            if exact:
                ref = _dense_f64(q, k, v, pol, causal, kv_len, fused)
                err = float((out.double() - ref).abs().max())
                assert err <= TOL, (pol, fused, err)
            else:
                ref = _dense_call(lut_attention_plain, q, k, v, pol, causal,
                                  kv_len, fused)
                err = float((out - ref).abs().max())
                assert err <= limit, (pol, fused, err, limit)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_dense_split_route_on_an_empty_cache(cuda, dtype):
    """kv_len 0: every row exactly 0, in every mode and precision."""
    q, k, v = _dense_problem(31, b=2, h=8, kvh=2, lq=3, lk=64, dh=128,
                             dtype=dtype)
    for pol in DENSE_POLICIES:
        for fused in ((False, True) if pol.impl == "rexp" else (False,)):
            for causal in (False, True):
                out = _dense_call(lut_attention_cuda, q, k, v, pol, causal, 0,
                                  fused, route="split")
                assert not out.any(), (pol, fused, causal)


def test_dense_op_on_real_and_fake_cuda_tensors(cuda):
    """In one process: the dense wrapper on real CUDA tensors launches
    the kernel directly (one launch counted; no dispatcher, so
    ``FlopCounterMode`` sees nothing) and matches the plain version; on
    fake CUDA tensors (``FakeTensorMode``) the operator gives the
    kernel's shape and dtype, counts its ``dense_flops`` and launches
    nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    pol = SoftmaxPolicy(impl="rexp", precision="uint8")
    q, k, v = _dense_problem(41, b=2, h=8, kvh=2, lq=1, lk=300, dh=128,
                             dtype=torch.bfloat16)
    before = sum(lut_attention_cuda.launches.values())
    with FlopCounterMode(display=False) as fc:
        out = ops.lut_attention(q, k, v, pol, causal=True, kv_len=250)
    torch.cuda.synchronize()
    assert sum(lut_attention_cuda.launches.values()) == before + 1
    assert fc.get_total_flops() == 0
    flops = 4 * 2 * 8 * 1 * 300 * 128
    ref = ops.lut_attention(q, k, v, pol, causal=True, kv_len=250,
                            backend="naive")
    assert float((out - ref).abs().max()) <= 2.0 / 255 * float(
        v.float().abs().max())
    with FakeTensorMode() as mode:
        fq, fk, fv = (mode.from_tensor(t) for t in (q, k, v))
        with FlopCounterMode(display=False) as fc:
            fout = ops.lut_attention(fq, fk, fv, pol, causal=True,
                                     kv_len=250)
    assert fout.device.type == "cuda" and fout.dtype == torch.float32
    assert tuple(fout.shape) == tuple(out.shape)
    assert fc.get_total_flops() == flops
    assert sum(lut_attention_cuda.launches.values()) == before + 1


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_dense_split_plans_fit_a_cta(cuda, arch):
    """Every config's attention widths on the split route, f32 and bf16,
    one and seven query rows against 1 to 8192 keys, int16 and uint8
    tables: the launcher plans within Hopper's 227 KB a CTA (it refuses a
    plan that does not, and the wrapper raises) and matches the f64
    referee."""
    cfg = ARCHS[arch]
    g, kvh, dh = cfg.n_heads // cfg.n_kv_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    kvh = min(kvh, 2)
    for dtype in (torch.float32, torch.bfloat16):
        for lq, lk in ((1, 1), (1, 8192), (7, 1500)):
            q, k, v = _dense_problem(lk + lq, b=1, h=g * kvh, kvh=kvh,
                                     lq=lq, lk=lk, dh=dh, dtype=dtype)
            for prec in ("int16", "uint8"):
                pol = SoftmaxPolicy(impl="lut2d", precision=prec)
                if prec == "int16" and lk > 2 ** 24 // 32767:
                    continue      # Σ past 2^24: not exact in any order
                out = _dense_call(lut_attention_cuda, q, k, v, pol, True,
                                  None, False, route="split")
                ref = _dense_f64(q, k, v, pol, True, None, False)
                err = float((out.double() - ref).abs().max())
                assert err <= TOL, (dtype, lq, lk, prec, err)


@pytest.mark.parametrize("impl", ["rexp", "lut2d"])
def test_dense_kernel_at_jambas_attention_shape(cuda, impl):
    """Jamba-v0.1-52B's lockstep attention (GQA 4: 32 heads over 8 KV
    heads of 128, causal, no RoPE) into a cache of 96 positions: the
    64-row prompt call on the tile route and a decode step at kv_len 95
    on the split route, each as the dispatcher picks it, on normal rows
    in bf16 — within one LUT step of the plain version, one launch on
    its route."""
    pol = SoftmaxPolicy(impl=impl, precision="uint8")
    qmax = get_precision("uint8").qmax
    for lq, kv_len, route in ((64, 64, "tiles"), (1, 95, "split")):
        q, k, v = _dense_problem(lq + kv_len, b=4, h=32, kvh=8, lq=lq,
                                 lk=96, dh=128, dtype=torch.bfloat16,
                                 exact=False)
        assert dense_route(q.dtype, 128, lq, impl) == route
        before = lut_attention_cuda.route_launches[route]
        out = ops.lut_attention(q, k, v, pol, causal=True, kv_len=kv_len,
                                backend="cuda")
        assert lut_attention_cuda.route_launches[route] == before + 1
        ref = _dense_call(lut_attention_plain, q, k, v, pol, True, kv_len,
                          False)
        limit = 2.0 / qmax * float(v.float().abs().max())
        err = float((out - ref).abs().max())
        assert err <= limit, (lq, kv_len, err, limit)


@pytest.mark.parametrize("impl", ["rexp", "lut2d"])
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tiles"),
                                         (torch.float32, "simt")])
def test_dense_kernel_at_qwen3_eval_shape(cuda, impl, dtype, route):
    """The eval step's call at Qwen3-32B width (``make_eval_step``: the
    prefill of a 512-token sequence's 511 inputs into a cache of 511
    positions): B 4, GQA 8 (64 heads over 8 KV heads of 128), 511 rows
    over 511 keys at kv_len 511, causal, on normal rows — bf16 on the
    tile route and f32 on the simt route, each as the dispatcher picks
    it: within one LUT step of the plain version, one launch on its
    route."""
    pol = SoftmaxPolicy(impl=impl, precision="uint8")
    qmax = get_precision("uint8").qmax
    q, k, v = _dense_problem(511, b=4, h=64, kvh=8, lq=511, lk=511, dh=128,
                             dtype=dtype, exact=False)
    assert dense_route(dtype, 128, 511, impl) == route
    before = lut_attention_cuda.route_launches[route]
    out = ops.lut_attention(q, k, v, pol, causal=True, kv_len=511,
                            backend="cuda")
    assert lut_attention_cuda.route_launches[route] == before + 1
    ref = _dense_call(lut_attention_plain, q, k, v, pol, True, 511, False)
    limit = 2.0 / qmax * float(v.float().abs().max())
    err = float((out - ref).abs().max())
    assert err <= limit, (err, limit)


def test_dense_long_rows_recompute_path(cuda):
    """Rows past the shared-memory budget recompute q·k in every pass."""
    q, k, v = _dense_problem(22, b=1, h=2, kvh=1, lq=9, lk=12000, dh=64,
                             dtype=torch.bfloat16)
    pol = SoftmaxPolicy(impl="rexp", precision="uint8")
    for fused in (False, True):
        out = _dense_call(lut_attention_cuda, q, k, v, pol, True, 11000,
                          fused)
        ref = _dense_call(lut_attention_plain, q, k, v, pol, True, 11000,
                          fused)
        assert float((out - ref).abs().max()) <= TOL


def test_dense_dispatch_on_cuda(cuda):
    """``auto``/``cuda`` launch the dense kernel (fused without a kv_len,
    faithful with one), ``naive`` never does, nor does the exact policy
    under any knob."""
    q, k, v = _dense_problem(23, b=2, h=4, kvh=2, lq=3, lk=24, dh=64,
                             dtype=torch.bfloat16)
    rexp = SoftmaxPolicy(impl="rexp", precision="uint8")
    n = dict(lut_attention_cuda.launches)
    n_routes = dict(lut_attention_cuda.route_launches)
    for backend in ("auto", "cuda", "naive"):
        ops.lut_attention(q, k, v, rexp, backend=backend)
        ops.lut_attention(q, k, v, rexp, causal=True, kv_len=17,
                          backend=backend)
        ops.lut_attention(q, k, v, SoftmaxPolicy(), backend=backend)
    got = lut_attention_cuda.launches
    assert got["rexp_fused"] == n["rexp_fused"] + 2
    assert got["rexp"] == n["rexp"] + 2 and got["lut2d"] == n["lut2d"]
    # three query rows: the split route
    assert lut_attention_cuda.route_launches == dict(
        n_routes, split=n_routes["split"] + 4)
    # a non-contiguous query (a transposed projection) is made contiguous
    # by the dispatcher, never by the kernel wrapper
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    out = ops.lut_attention(qt, k, v, rexp, backend="cuda")
    ref = ops.lut_attention(q, k, v, rexp, backend="naive")
    assert float((out - ref).abs().max()) <= TOL


def test_dense_inputs_the_kernel_does_not_take_raise(cuda):
    """H % KVH ≠ 0, kv_len > Lk, non-contiguous or misaligned tensors,
    mixed dtypes, head dims off the grid and float16 raise before any
    launch."""
    pol = SoftmaxPolicy(impl="lut2d", precision="uint8")
    q, k, v = _dense_problem(24, b=2, h=4, kvh=2, lq=3, lk=24, dh=64,
                             dtype=torch.bfloat16)
    n = dict(lut_attention_cuda.launches)
    q6, k6, v6 = _dense_problem(25, b=2, h=6, kvh=4, lq=3, lk=24, dh=64,
                                dtype=torch.bfloat16)
    q36, k36, v36 = _dense_problem(26, b=2, h=4, kvh=2, lq=3, lk=24, dh=36,
                                   dtype=torch.bfloat16)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    bad = [((q6, k6, v6), {}, "multiple of KV heads"),
           ((q, k, v), dict(kv_len=25), "kv_len"),
           ((q.transpose(2, 3), k, v), {}, "contiguous"),
           ((q, k.transpose(2, 3).contiguous().transpose(2, 3), v), {},
            "contiguous"),
           ((q, k.float(), v), {}, "kernel takes"),
           ((q36, k36, v36), {}, "Dh"),
           ((q, k[:, :, :20].contiguous(), v), {}, "both be"),
           ((shifted, k, v), {}, "aligned")]
    for args, kw, match in bad:
        with pytest.raises(ValueError, match=match):
            _dense_call(lut_attention_cuda, *args, pol, False,
                        kw.get("kv_len"), False)
    with pytest.raises(TypeError):
        _dense_call(lut_attention_cuda, q.half(), k.half(), v.half(), pol,
                    False, None, False)
    with pytest.raises(ValueError, match="rexp"):
        lut_attention_cuda(q, k, v, None, method="exact")
    assert lut_attention_cuda.launches == n


# ---------------------------------------------------------------------------
# Row-wise LUT softmax and exact flash attention
# ---------------------------------------------------------------------------

ROW_KERNELS = {"rexp": (rexp_softmax_cuda, rexp_softmax_plain),
               "lut2d": (lut2d_softmax_cuda, lut2d_softmax_plain)}
ROW_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _row_logits(seed, rows, cols, dtype):
    """Normal logits (σ = 3) with a quarter of the entries −inf, row 0
    fully masked, row 1 with a +inf and row 2 with a NaN."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 3, (rows, cols)).astype(np.float32)
    x[rng.random(x.shape) < 0.25] = -np.inf
    x[0] = -np.inf
    x[1, cols // 2] = np.inf
    x[2, cols // 3] = np.nan
    return torch.as_tensor(x, device="cuda").to(dtype)


PRECISIONS = ("int16", "uint8", "uint4", "uint2")
#: (rows, cols) of the warp route (one warp a row, in registers; 512 is
#: int16's last column count inside the Σ bound) and column counts of the
#: cta route (a CTA a row: staged in shared memory by a bulk copy in one
#: or two buffers, or re-read from L2 — 65 536 f32 columns are past
#: 227 KB)
WARP_SHAPES = ((5, 1), (5, 7), (5, 8), (33, 200), (9, 300), (16, 512),
               (7, 1500), (7, 1501), (7, 2048))
CTA_COLS = (4097, 16384, 20000, 65536)


def _row_cases(impl, cols):
    """(tables, index_mode) for every precision × bin mode whose integer
    Σ stays exact (cols · qmax < 2**24, where the kernel is bitwise the
    plain version)."""
    for prec in PRECISIONS:
        if cols * get_precision(prec).qmax >= 1 << 24:
            continue
        tables = ops._tables_for(SoftmaxPolicy(impl=impl, precision=prec))
        for mode in ("round", "floor"):
            yield tables, mode


def _row_plan(x, impl, tables):
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    return plan_for(x, out, *kernel_tables(impl, tables, "round",
                                           x.device)[:2])


def _check_rows(kernel, plain, x, tables, mode, label):
    n = kernel.launches
    out = kernel(x, tables, mode)
    assert kernel.launches == n + 1
    assert out.dtype == torch.float32 and out.shape == x.shape
    assert torch.equal(out, plain(x, tables, mode)), label
    return out


@pytest.mark.parametrize("dtype", ROW_DTYPES, ids=str)
@pytest.mark.parametrize("impl", ["rexp", "lut2d"])
def test_row_softmax_kernel_equals_plain(cuda, impl, dtype):
    """The warp route at every column count up to 2048 (vectors of 8, 4
    and 1 elements), every precision × bin mode; bitwise, with a fully
    masked row, a +inf row and a NaN row."""
    kernel, plain = ROW_KERNELS[impl]
    for rows, cols in WARP_SHAPES:
        x = _row_logits(rows + cols, rows, cols, dtype)
        for tables, mode in _row_cases(impl, cols):
            assert _row_plan(x, impl, tables).route == "warp"
            out = _check_rows(kernel, plain, x, tables, mode, (cols, mode))
            assert not out[0].any()


@pytest.mark.parametrize("cols", CTA_COLS)
def test_row_softmax_long_rows(cuda, cols):
    """The cta route: staged in two buffers (16 384, 20 000), one (65 536
    in 16-bit) or none (65 536 f32, past 227 KB; 4097, whose vectors are
    one element), every precision × bin mode inside the Σ bound × f32 /
    bf16 / f16; bitwise."""
    stages = set()
    for impl, (kernel, plain) in ROW_KERNELS.items():
        for dtype in ROW_DTYPES:
            x = _row_logits(cols, 5, cols, dtype)
            for tables, mode in _row_cases(impl, cols):
                plan = _row_plan(x, impl, tables)
                assert plan.route == "cta" and plan.smem <= 232448
                stages.add(plan.stages)
                out = _check_rows(kernel, plain, x, tables, mode,
                                  (impl, dtype, mode))
                assert not out[0].any()
    if cols in (16384, 65536):
        assert stages == {16384: {2}, 65536: {0, 1}}[cols]


@pytest.mark.parametrize("impl", ["rexp", "lut2d"])
def test_row_softmax_misaligned_inputs(cuda, impl):
    """Views whose rows start off a 16-byte boundary: ``x[1:]`` of a bf16
    (rows, 1500) tensor (8-byte aligned: vectors of 4) and flat views
    shifted by one element (vectors of 1), on both routes; bitwise."""
    kernel, plain = ROW_KERNELS[impl]
    tables = ops._tables_for(SoftmaxPolicy(impl=impl, precision="uint8"))
    x = _row_logits(11, 9, 1500, torch.bfloat16)[1:]
    assert x.is_contiguous() and x.data_ptr() % 16 == 8
    assert _row_plan(x, impl, tables).vec == 4
    _check_rows(kernel, plain, x, tables, "round", "x[1:]")
    for dtype in ROW_DTYPES:
        for rows, cols in ((6, 1500), (6, 2048), (3, 16384)):
            flat = _row_logits(cols, rows + 1, cols, dtype).reshape(-1)
            x = flat[1:1 + rows * cols].view(rows, cols)
            plan = _row_plan(x, impl, tables)
            assert plan.vec == 1 and plan.stages == 0
            _check_rows(kernel, plain, x, tables, "round", (dtype, cols))


@pytest.mark.parametrize("impl", ["rexp", "lut2d"])
def test_row_softmax_row_counts(cuda, impl):
    """A single row, and more rows than the persistent grid holds in one
    pass (each CTA walks several rows), on both routes; bitwise."""
    kernel, plain = ROW_KERNELS[impl]
    tables = ops._tables_for(SoftmaxPolicy(impl=impl, precision="uint8"))
    for dtype in (torch.float32, torch.bfloat16):
        for rows, cols in ((1, 300), (1, 1500), (1, 16384), (9000, 300),
                           (5000, 1500), (700, 16384)):
            x = _row_logits(rows, rows + 3, cols, dtype)[3:]  # finite rows
            plan = _row_plan(x, impl, tables)
            per_cta = plan.threads // 32 if plan.route == "warp" else 1
            if rows > 1:
                assert rows > plan.grid * per_cta
            _check_rows(kernel, plain, x, tables, "round", (rows, cols))


def test_row_softmax_op_on_cuda(cuda):
    """``lut_softmax(use_kernel=True)`` launches the kernel along any
    axis and leading shape; ``use_kernel=False`` and the impls without a
    kernel never do; a dtype the kernel does not take raises."""
    x = _row_logits(3, 24, 40, torch.float32).reshape(2, 3, 4, 40)
    n = (rexp_softmax_cuda.launches, lut2d_softmax_cuda.launches)
    for impl in ("rexp", "lut2d"):
        pol = SoftmaxPolicy(impl=impl, use_kernel=True)
        kernel, plain = ROW_KERNELS[impl]
        tables = ops._tables_for(pol)
        assert torch.equal(sops.lut_softmax(x, pol), plain(x, tables))
        out = sops.lut_softmax(x, pol, axis=1)
        assert torch.equal(out, plain(x.movedim(1, -1), tables).movedim(
            -1, 1))
        for other in (SoftmaxPolicy(impl=impl),
                      SoftmaxPolicy(impl="rexp_unnorm", use_kernel=True),
                      SoftmaxPolicy(impl="exact", use_kernel=True)):
            sops.lut_softmax(x, other)
    assert (rexp_softmax_cuda.launches,
            lut2d_softmax_cuda.launches) == (n[0] + 2, n[1] + 2)
    with pytest.raises(TypeError):
        sops.lut_softmax(x.double(), SoftmaxPolicy(impl="rexp",
                                                   use_kernel=True))


FLASH_CASES = [  # (B, H, KVH, Lq, Lk, D, causal)
    (2, 4, 4, 100, 100, 64, False),
    (2, 8, 2, 70, 300, 128, True),       # GQA 4, Lk not a multiple of 32
    (1, 4, 1, 16, 333, 40, True),        # a tail chunk, odd head dim
    (1, 4, 2, 96, 40, 256, True),        # Lq > Lk: 56 rows see no key
    (1, 4, 2, 96, 40, 64, True),         # the same on the tile route
    (1, 2, 2, 5, 7, 8, False),
    (1, 8, 1, 130, 1500, 128, True),     # GQA 8, a long causal chunk
]


@pytest.mark.parametrize("dtype", ROW_DTYPES, ids=str)
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_kernel_matches_plain(cuda, case, dtype):
    """The route :func:`flash_route` picks and, for inputs the tile engine
    takes, the CUDA-core route too, each counted on its own."""
    b, h, kvh, lq, lk, d, causal = case
    rng = np.random.default_rng(lq + lk)
    q, k, v = (torch.as_tensor(rng.normal(size=s), device="cuda").to(dtype)
               for s in ((b, h, lq, d), (b, kvh, lk, d), (b, kvh, lk, d)))
    ro, rm, rl = flash_attention_plain(q, k, v, causal=causal)
    blind = torch.isneginf(rm)
    assert int(blind.sum()) == (b * h * (lq - lk) if causal and lq > lk
                                else 0)
    routes = ["simt"] + (["tiles"] if flash_route(dtype, d) == "tiles"
                         else [])
    for route in routes:
        n = dict(flash_attention_cuda.launches)
        out, m, l = flash_attention_cuda(
            q, k, v, causal=causal,
            route=None if route == flash_route(dtype, d) else route)
        assert flash_attention_cuda.launches == dict(n, **{route:
                                                           n[route] + 1})
        torch.testing.assert_close(out, ro, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(m, rm, rtol=1e-5, atol=0)
        torch.testing.assert_close(l, rl, rtol=1e-5, atol=0)
        assert torch.equal(torch.isneginf(m), blind)
        assert not out[blind].any() and not l[blind].any()


def test_flash_dispatch_on_cuda(cuda):
    """``auto`` and ``cuda`` launch the kernel; ``naive`` and ``blocked``
    never do and agree with it, also given a ``kv_len``."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.as_tensor(rng.normal(size=s), device="cuda",
                               dtype=torch.float32)
               for s in ((2, 4, 50, 64), (2, 2, 90, 64), (2, 2, 90, 64)))
    n = dict(flash_attention_cuda.launches)
    outs = {be: fops.flash_attention(q, k, v, causal=True, backend=be,
                                     q_chunk=16, k_chunk=32)
            for be in ("auto", "cuda", "naive", "blocked")}
    assert flash_attention_cuda.launches == dict(n, simt=n["simt"] + 2)
    for be, out in outs.items():
        torch.testing.assert_close(out, outs["naive"], rtol=2e-5, atol=2e-5)
    outs = {be: fops.flash_attention(q, k, v, causal=True, backend=be,
                                     kv_len=60, q_chunk=16, k_chunk=32)
            for be in ("auto", "cuda", "naive", "blocked")}
    assert flash_attention_cuda.launches == dict(n, simt=n["simt"] + 4)
    for be, out in outs.items():
        torch.testing.assert_close(out, outs["naive"], rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="multiple of KV heads"):
        k3 = k[:, :1].expand(2, 3, 90, 64)
        flash_attention_cuda(q, k3, k3)
    with pytest.raises(ValueError, match="tile route"):
        flash_attention_cuda(q, k, v, route="tiles")      # f32
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention_cuda(q, k, v, kv_len=torch.tensor([1, 2, 3]))
    assert flash_attention_cuda.launches == dict(n, simt=n["simt"] + 4)


FLASH_KV_CASES = [  # (B, H, KVH, Lq, Lk, D, kv_len)
    (2, 8, 2, 16, 300, 128, 200),        # one length for all
    (2, 8, 2, 16, 300, 128, (250, 9)),   # one each: 7 rows see no key
    (1, 4, 4, 40, 64, 64, 0),            # no valid key at all
    (3, 4, 1, 5, 333, 40, (333, 100, 1)),
]


@pytest.mark.parametrize("dtype", ROW_DTYPES, ids=str)
@pytest.mark.parametrize("case", FLASH_KV_CASES, ids=str)
def test_flash_kernel_with_kv_len(cuda, case, dtype):
    """A cache's ``kv_len`` on every route the inputs take: keys at or
    past it masked (never read), causal rows right-aligned to it; rows
    that see no key exactly 0 / −inf / 0."""
    b, h, kvh, lq, lk, d, kv_len = case
    rng = np.random.default_rng(lq + lk + 1)
    q, k, v = (torch.as_tensor(rng.normal(size=s), device="cuda").to(dtype)
               for s in ((b, h, lq, d), (b, kvh, lk, d), (b, kvh, lk, d)))
    if isinstance(kv_len, tuple):
        kv_len = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    ro, rm, rl = flash_attention_plain(q, k, v, causal=True, kv_len=kv_len)
    blind = torch.isneginf(rm)
    routes = ["simt"] + (["tiles"] if flash_route(dtype, d) == "tiles"
                         else [])
    for route in routes:
        out, m, l = flash_attention_cuda(q, k, v, causal=True, route=route,
                                         kv_len=kv_len)
        torch.testing.assert_close(out, ro, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(m, rm, rtol=1e-5, atol=0)
        torch.testing.assert_close(l, rl, rtol=1e-5, atol=0)
        assert torch.equal(torch.isneginf(m), blind)
        assert not out[blind].any() and not l[blind].any()


def test_flash_tile_route_on_a_misaligned_view(cuda):
    """A bf16 view whose storage starts off a 16-byte boundary is copied
    for the tile route's 16-byte loads, not refused."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.as_tensor(rng.normal(size=(1, 2, 40, 64)),
                               device="cuda").to(torch.bfloat16)
               for _ in range(3))
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.data_ptr() % 16
    n = dict(flash_attention_cuda.launches)
    out = flash_attention_cuda(shifted, k, v, causal=True)
    assert flash_attention_cuda.launches == dict(n, tiles=n["tiles"] + 1)
    torch.testing.assert_close(out[0], flash_attention_plain(
        q, k, v, causal=True)[0], rtol=2e-5, atol=2e-5)
