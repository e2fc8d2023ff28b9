"""The port's CUDA paged kernels against their plain versions, on the card.

Marked ``gpu``: without a CUDA device every test skips (a CUDA kernel
has no CPU mode; its plain version is what the CPU suites hold to the
JAX package).  On the card: ``pytest -m gpu tests/test_torch_cuda_kernels.py``.

Inputs are exact-logit (q, k small integers × 2^-2), so every dot order
gives the same logits and the integer LUT pipeline must agree exactly:
outputs within 2e-6 at every precision, both bin modes, GQA 1/4, odd
head dims, ragged lengths and partial chunks.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.policies import SoftmaxPolicy
from repro_torch.kernels.lut_attention import ops
from repro_torch.kernels.lut_attention.paged_decode import (
    paged_decode_attention, paged_decode_plain)
from repro_torch.kernels.lut_attention.paged_prefill import (
    paged_prefill_attention, paged_prefill_plain)

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu

TOL = 2e-6


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
@pytest.mark.parametrize("g,dh", [(1, 128), (4, 64), (2, 40)])
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
@pytest.mark.parametrize("g,c", [(1, 16), (4, 5), (2, 1)])
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
