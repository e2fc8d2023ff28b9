"""The dense kernel's split route, its arithmetic in plain torch.

The ``"split"`` route of ``csrc/lut_attention.cu`` (the body of
``csrc/paged_attn.cuh`` over contiguous keys) serves the few-row calls —
decode steps, short prefill chunks.  A cluster takes one (sequence, KV
head, block of at most 16 of the KV head's G·Lq query rows); it cuts
the block's live keys [0, jmax) into 32-key tiles, rank r of n takes
tiles [r·nu/n, (r+1)·nu/n) of the nu live tiles, and inside a rank, with
``ws`` key slices, warp slice s takes the s-th tile of every stage of
ws tiles.  Each (rank, slice) keeps a partial row max, Σ and σ·V (the
fused α form: U = Σ e·v); they combine in rank, then slice order, and
the fused form's output is U · α(Σ)·(1/qmax)².
:func:`split_attention` evaluates a dense problem that way here, with
the port's own per-element pipeline (``kernels.common``), and the tests
hold it to:

* the whole row: m and the integer Σ ``torch.equal`` to the values over
  all keys at once (an f32 sum of integers below 2^24 is exact in any
  order);
* the JAX package's ``lut_attention_pallas`` (interpret mode) within
  the parity suites' 2e-6 on exact-logit inputs (q, k small integers ×
  2^-2, v rounded to bf16), for fused REXP, faithful REXP and
  2D-LUT, f32 and bf16 inputs, Lq ∈ {1, 3, 7}, GQA 1 and 4, causal with
  a cache's kv_len below Lk (the JAX kernel is given the valid keys),
  for n ∈ {1, 2, 3, 8} ranks with 1, 2, 3 or 8 key slices (ranks and
  slices left without keys) and for cuts inside a tile;
* an empty cache (kv_len 0): rows of exact 0, as the plain version's.

The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py`` phase 6).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policies import SoftmaxPolicy as JPol
from repro.kernels.lut_attention import ops as jops
from repro.kernels.lut_attention.lut_attention import lut_attention_pallas
from repro_torch.core.lut_softmax import inv_scale
from repro_torch.core.policies import SoftmaxPolicy as TPol
from repro_torch.kernels import common
from repro_torch.kernels.lut_attention import ops as tops
from repro_torch.kernels.lut_attention import ref as dref
from repro_torch.kernels.lut_attention.lut_attention import (
    lut_attention_cuda, lut_attention_plain)

torch.set_num_threads(1)

TOL = 2e-6
TILE = 32
#: the largest block of query rows a cluster serves
BLOCK_ROWS = 16
#: mode → (method, fused_requant)
MODES = {"rexp_fused": ("rexp", True), "rexp": ("rexp", False),
         "lut2d": ("lut2d", False)}
KVH, LK, DH = 2, 200, 16
#: (Lq, GQA group, kv_len): decode steps, a 3-row and a 7-row chunk;
#: kv_len below Lk, and 200 (no tail)
SHAPES = [(1, 1, 150), (1, 4, 200), (3, 1, 97), (3, 4, 150), (7, 4, 65)]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@functools.lru_cache(maxsize=None)
def _problem(lq: int, g: int):
    """numpy q (1, KVH·G, Lq, Dh), k, v (1, KVH, Lk, Dh): exact-logit q
    and k, normal v rounded to bf16, so that f32 and bf16 inputs hold the
    same values (and one JAX run serves both)."""
    rng = np.random.default_rng(lq * 10 + g)
    q = rng.integers(-4, 5, size=(1, KVH * g, lq, DH)) * 0.25
    k = rng.integers(-4, 5, size=(1, KVH, LK, DH)) * 0.25
    v = rng.normal(size=(1, KVH, LK, DH))
    v = torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16).float()
    return q.astype(np.float32), k.astype(np.float32), v.numpy()


@functools.lru_cache(maxsize=None)
def _jax_out(lq, g, kv_len, mode):
    """The JAX kernel on the valid keys (the dense kernel masks the tail
    and right-aligns causal rows to kv_len, the JAX kernel to Lk)."""
    q, k, v = _problem(lq, g)
    method, fused = MODES[mode]
    pol = JPol(impl=method, precision="uint8")
    return np.asarray(lut_attention_pallas(
        jnp.asarray(q), jnp.asarray(k[:, :, :kv_len]),
        jnp.asarray(v[:, :, :kv_len]), jops._tables_for(pol),
        method=method, causal=True, fused_requant=fused, interpret=True))


def tile_cuts(jmax: int, n: int) -> list[int]:
    """The split's ranges: rank r takes tiles [r·nu/n, (r+1)·nu/n) of the
    nu = ceil(jmax/32) live tiles, keys clipped to jmax."""
    nu = -(-jmax // TILE)
    return [min(r * nu // n * TILE, jmax) for r in range(n + 1)]


def slice_keys(a: int, z: int, ws: int) -> list[torch.Tensor]:
    """Keys of range [a, z) that each of ``ws`` warp slices takes: slice
    s the s-th 32-key tile of every stage of ws tiles."""
    j = torch.arange(a, z)
    return [j[((j - a) // TILE) % ws == s] for s in range(ws)]


def split_attention(q, k, v, mode, causal, kv_len, cuts_of, ws):
    """The split route's algorithm in plain torch: per (sequence, KV
    head, block of rows) the live keys cut at ``cuts_of(jmax)`` into
    ranks, each rank's keys into ``ws`` slices; each (rank, slice)'s
    partial max, Σ and σ·V; combined in rank, then slice order.
    Returns (out, per-block (m, Σ), per-block whole-row (m, Σ))."""
    method, fused = MODES[mode]
    policy = TPol(impl=method, precision="uint8")
    b, h, lq, dh = q.shape
    kvh, g = k.shape[1], h // k.shape[1]
    s = dref._logits(q, k, dh ** -0.5, causal, kv_len)       # (B,H,Lq,Lk)
    tables = tops._tables_for(policy)
    main, aux, _, floats = common.kernel_tables(
        method, tables, policy.index_mode, torch.device("cpu"))
    qmax = round(1 / floats[1])
    inv = inv_scale(qmax)
    q0 = kv_len - lq if causal else kv_len
    rows = g * lq
    blocks = -(-rows // BLOCK_ROWS)
    rpb = -(-rows // blocks)
    out = torch.zeros(q.shape)
    stats, whole = [], []
    for bi in range(b):
        for kh in range(kvh):
            srows = s[bi, kh * g:(kh + 1) * g].reshape(rows, -1)
            vk = v[bi, kh].float()
            for r0 in range(0, rows, rpb):
                sub = srows[r0:r0 + rpb]
                c_first = r0 % lq
                c_last = min(c_first + len(sub) - 1, lq - 1)
                jmax = max(min(kv_len, q0 + c_last + 1), 0)
                cuts = cuts_of(jmax)
                parts = [keys for a, z in zip(cuts, cuts[1:])
                         for keys in slice_keys(a, z, ws)]
                m = torch.full((len(sub),), float("-inf"))
                for keys in parts:                # partial maxes, in order
                    if len(keys):
                        m = torch.maximum(m, sub[:, keys].amax(-1))
                m = torch.where(torch.isfinite(m), m, torch.zeros(()))

                def e_of(x):
                    return common.policy_e_terms(
                        x, m, main, method, getattr(tables, "exp_step", 1.0),
                        policy.index_mode)

                total = torch.zeros(len(sub))
                for keys in parts:                # partial Σ, in order
                    total = total + e_of(sub[:, keys]).float().sum(-1)
                full = sub[:, :jmax]
                wm = (full.amax(-1) if jmax else
                      torch.full((len(sub),), float("-inf")))
                whole.append((torch.where(torch.isfinite(wm), wm,
                                          torch.zeros(())),
                              e_of(full).float().sum(-1)))
                stats.append((m, total))
                acc = torch.zeros(len(sub), dh)
                for keys in parts:                # partial σ·V, in order
                    e = e_of(sub[:, keys])
                    if fused:
                        w = e.float()
                    elif method == "rexp":
                        w = common.rexp_sigma(e, total, aux[0], qmax,
                                              policy.index_mode) * inv
                    else:
                        w = common.lut2d_sigma_int(
                            e, total, aux, qmax, tables.scale_ex,
                            tables.scale_sum, policy.index_mode).float() * inv
                    acc = acc + w.float() @ vk[keys]
                if fused:
                    col = common._bin_index(total * inv, policy.index_mode,
                                            0, aux.shape[1] - 1)
                    alpha = aux[0][col].float()
                    acc = acc * ((alpha * inv) * inv)[:, None]
                flat = torch.arange(r0, r0 + len(sub))
                out[bi, kh * g + flat // lq, flat % lq] = acc
    return out, stats, whole


def _check(lq, g, kv_len, dtype, mode, cuts_of, ws):
    q, k, v = (torch.from_numpy(x).to(DTYPES[dtype])
               for x in _problem(lq, g))
    out, stats, whole = split_attention(q, k, v, mode, True, kv_len, cuts_of,
                                        ws)
    for (m, total), (m_w, total_w) in zip(stats, whole):
        assert torch.equal(m, m_w)
        assert torch.equal(total, total_w)
    np.testing.assert_allclose(out.numpy(), _jax_out(lq, g, kv_len, mode),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("n,ws", [(1, 1), (1, 8), (2, 3), (3, 2), (8, 1),
                                  (8, 8)])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_tile_ranges_and_slices_combine_to_the_whole_row(shape, dtype, mode,
                                                         n, ws):
    lq, g, kv_len = shape
    _check(lq, g, kv_len, dtype, mode, lambda jmax: tile_cuts(jmax, n), ws)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("shape", SHAPES[::2], ids=str)
def test_cuts_inside_tiles_combine_to_the_whole_row(shape, mode):
    """Ranges that start and end inside 32-key tiles, some empty."""
    def cuts_of(jmax):
        inner = sorted({min(x, jmax) for x in (5, 5, 40, 41, 130)})
        return [0, *inner, jmax]
    lq, g, kv_len = shape
    _check(lq, g, kv_len, "f32", mode, cuts_of, 2)


def test_slices_take_every_key_once():
    """Every key of a rank's range goes to exactly one slice, tile by
    tile: the slices' union is the range."""
    for a, z in ((0, 0), (0, 31), (32, 200), (64, 97)):
        for ws in (1, 2, 3, 6, 8):
            keys = torch.cat(slice_keys(a, z, ws))
            assert torch.equal(keys.sort().values, torch.arange(a, z))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("lq,g", [(1, 1), (3, 4), (7, 1)])
def test_empty_cache_gives_exact_zeros(lq, g, mode):
    """kv_len 0: no key is visible, every row is exactly 0 — in the split
    evaluation, the plain version and the wrapper's CPU path (a forced
    ``route="split"`` on CPU tensors runs the plain version)."""
    q, k, v = (torch.from_numpy(x) for x in _problem(lq, g))
    method, fused = MODES[mode]
    for n, ws in ((1, 1), (8, 8)):
        out = split_attention(q, k, v, mode, True, 0,
                              lambda jmax: tile_cuts(jmax, n), ws)[0]
        assert not out.any()
    tables = tops._tables_for(TPol(impl=method, precision="uint8"))
    for fn, kw in ((lut_attention_plain, {}),
                   (lut_attention_cuda, dict(route="split"))):
        out = fn(q, k, v, tables, method=method, causal=True,
                 fused_requant=fused, kv_len=0, **kw)
        assert not out.any()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_plain_version_is_the_one_range_split(mode):
    """One rank, one slice is the plain version itself (the wrapper's CPU
    path), non-causal too."""
    q, k, v = (torch.from_numpy(x) for x in _problem(3, 4))
    method, fused = MODES[mode]
    tables = tops._tables_for(TPol(impl=method, precision="uint8"))
    for causal in (False, True):
        out = split_attention(q, k, v, mode, causal, 150,
                              lambda jmax: [0, jmax], 1)[0]
        torch.testing.assert_close(out, lut_attention_plain(
            q, k, v, tables, method=method, causal=causal,
            fused_requant=fused, kv_len=150), rtol=TOL, atol=TOL)
