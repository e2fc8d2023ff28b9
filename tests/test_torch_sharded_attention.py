"""The port's sharded attention against the JAX package's shard_map code.

``kernels/lut_attention/sharded_paged.py`` (the mesh rows of the paged
dispatch) and ``sharded_decode.py`` (length-sharded lockstep decode) run
on 4 spawned gloo ranks over a ``file://`` store in ``tmp_path``
(``torch_tp_ranks``; no network) while the JAX package's
``paged_attention_sharded`` / ``lut_decode_sharded`` run on a forced
4-device host mesh in a subprocess, as ``tests/test_engine_tp.py`` and
``tests/test_multidevice.py`` run them; the same numpy inputs feed both.

* ``sharded_paged``: decode and prefill chunks, f32 and int8 pools, in
  the ``'heads'`` (KVH 4, G 1 and 2) and ``'pages'`` (KVH 1) regimes,
  within 2e-6 of the JAX package; in ``'pages'`` each rank's σ over its
  slab, summed over the ranks, is bitwise the JAX dense path's σ for
  REXP and 2D-LUT (exact-logit inputs: small integers × 2^-2, so every
  dot order gives the same logits).  Relabelling the physical pages
  changes nothing: bitwise in ``'heads'``, within 2e-6 in ``'pages'``
  (keys move between slabs, so the σ·V sum reassociates).  Each call
  puts only its allowed partials on the wire.
* ``sharded_decode``: within 2e-5 of ``lut_decode_sharded`` at
  ``tests/test_multidevice.py``'s shapes (KVH 3 on 4 ranks), exact and
  REXP; ``layers.apply_attention`` takes it for a one-token step
  against an ``AttnCache`` under the mesh.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import strategies
from repro.core.policies import SoftmaxPolicy as JPol
from repro.kernels.lut_attention import ops as JOPS
from repro.kernels.lut_attention import ref as JREF
from repro_torch.kernels.lut_attention import ops as TOPS
from repro_torch.launch.mesh import start_ranks

import torch_tp_ranks as R

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TP, PS, MP, DH = 4, 4, 5, 16
#: (kvh, G): 'heads' MHA, 'heads' GQA, 'pages'
LAYOUTS = [(4, 1), (4, 2), (1, 4)]
IMPLS = ("exact", "rexp", "lut2d")


def _problem(seed, impl, kvh, g, kv_lens, chunk=None, int8=False):
    """A paged problem with exact-logit q and k, slot i owning pages
    1 + i·MP onwards, n_pages a multiple of TP; ``chunk`` makes it a
    prefill problem whose chunk ends at each slot's kv_len."""
    rng = np.random.default_rng(seed)
    b, h = len(kv_lens), kvh * g
    n_pages = -(-(1 + b * MP) // TP) * TP
    c = chunk or 1
    q = (rng.integers(-4, 5, size=(b, h, c, DH)) * 0.25).astype(np.float32)
    shape = (n_pages, PS, kvh, DH)
    p = dict(impl=impl, kvh=kvh, q=q, kv_lens=np.asarray(kv_lens, np.int32))
    if int8:
        for name in ("k", "v"):
            p[f"{name}_pages"] = rng.integers(-4, 5, size=shape
                                              ).astype(np.int8)
            p[f"{name}_scales"] = (2.0 ** rng.integers(-3, 1, size=shape[:3])
                                   ).astype(np.float32)
    else:
        p["k_pages"] = (rng.integers(-4, 5, size=shape) * 0.25
                        ).astype(np.float32)
        p["v_pages"] = rng.normal(size=shape).astype(np.float32)
    bt = np.zeros((b, MP), np.int32)
    for i, kl in enumerate(kv_lens):
        n = -(-int(kl) // PS)
        bt[i, :n] = np.arange(1 + i * MP, 1 + i * MP + n)
    p["bt"] = bt
    if chunk:
        p["q_start"] = np.maximum(p["kv_lens"] - chunk, 0).astype(np.int32)
    return p


def _permuted(p, seed):
    """The same problem with its physical pages relabelled (null page
    fixed)."""
    perm, inv = strategies.pool_permutation(np.random.default_rng(seed),
                                            p["k_pages"].shape[0])
    out = dict(p, bt=perm[p["bt"]].astype(np.int32))
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        if name in p:
            out[name] = p[name][inv]
    return out


def _problems():
    probs = {}
    for kvh, g in LAYOUTS:
        for seed, impl, kv_lens in strategies.FALLBACK_PERMUTATION_CASES:
            key = f"{kvh}x{g}-{impl}"
            probs[f"decode-{key}"] = _problem(seed, impl, kvh, g, kv_lens)
            probs[f"perm-{key}"] = _permuted(probs[f"decode-{key}"], seed)
            probs[f"prefill-{key}"] = _problem(seed + 10, impl, kvh, g,
                                               kv_lens, chunk=3)
        for impl in ("exact", "rexp"):
            probs[f"int8-{kvh}x{g}-{impl}"] = _problem(
                7, impl, kvh, g, (13, 4, 18), int8=True)
    return probs


PROBLEMS = _problems()
#: the problems the JAX package's shard_map code also runs (each of its
#: calls compiles for seconds): both regimes and phases, every policy,
#: an int8 pool; every problem is held to the single-device path too
JAX_SHARDED = ("decode-4x2-lut2d", "decode-1x4-rexp", "prefill-4x2-rexp",
               "prefill-1x4-rexp", "int8-1x4-rexp")


def _decode_problems():
    rng = np.random.default_rng(0)
    b, h, kvh, L = 4, 6, 3, 64    # kvh = 3 does not divide tp = 4
    q = np.round(rng.normal(0, 2, (b, h, 1, DH))).astype(np.float32)
    k = np.round(rng.normal(0, 2, (b, kvh, L, DH))).astype(np.float32)
    v = rng.normal(0, 1, (b, kvh, L, DH)).astype(np.float32)
    return {impl: dict(impl=impl, q=q, k=k, v=v, kv_len=50)
            for impl in ("exact", "rexp")}


DECODE = _decode_problems()

_JAX = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.compat import make_mesh
from repro.core.policies import SoftmaxPolicy
from repro.kernels.lut_attention.ops import (lut_attention_paged_decode,
                                             lut_attention_paged_prefill)
from repro.kernels.lut_attention.sharded_decode import lut_decode_sharded
from repro.launch.mesh import make_serving_mesh
src, dst = sys.argv[1], sys.argv[2]
data = np.load(src, allow_pickle=False)
mesh = make_serving_mesh(4)
out = {}
def pol(impl):
    return (SoftmaxPolicy(impl=impl, precision='uint8') if impl != 'exact'
            else SoftmaxPolicy())
names = sorted({k.split('/')[0] for k in data.files})
for name in names:
    g = lambda f: jnp.asarray(data[f'{name}/{f}'])
    impl = str(data[f'{name}/impl'])
    if name.startswith('ld-'):
        dmesh = make_mesh((1, 4), ('data', 'model'))
        out[name] = jax.jit(lambda a, b, c: lut_decode_sharded(
            a, b, c, pol(impl), kv_len=jnp.int32(int(data[f'{name}/kv_len'])),
            mesh=dmesh, batch_axes=None))(g('q'), g('k'), g('v'))
        continue
    kw = dict(mesh=mesh)
    if f'{name}/k_scales' in data.files:
        kw.update(k_scales=g('k_scales'), v_scales=g('v_scales'))
    if f'{name}/q_start' in data.files:
        out[name] = lut_attention_paged_prefill(
            g('q'), g('k_pages'), g('v_pages'), g('bt'), g('q_start'),
            g('kv_lens'), pol(impl), **kw)
    else:
        out[name] = lut_attention_paged_decode(
            g('q'), g('k_pages'), g('v_pages'), g('bt'), g('kv_lens'),
            pol(impl), **kw)
np.savez(dst, **{k: np.asarray(v) for k, v in out.items()})
print('JAX-SHARDED-OK')
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's 4 ranks and the JAX package's 4-device mesh on the same
    problems, side by side; returns (port paged outputs, port decode
    outputs, JAX outputs)."""
    tmp = tmp_path_factory.mktemp("sharded")
    flat = {f"{name}/{k}": np.asarray(v) for name in JAX_SHARDED
            for k, v in PROBLEMS[name].items()}
    flat.update({f"ld-{name}/{k}": np.asarray(v)
                 for name, p in DECODE.items() for k, v in p.items()})
    np.savez(tmp / "in.npz", **flat)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_run = subprocess.Popen(
        [sys.executable, "-c", _JAX, str(tmp / "in.npz"),
         str(tmp / "out.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    paged, decode = start_ranks(
        R.sharded_problems, TP, backend="gloo", device="cpu",
        args=(list(PROBLEMS.values()), list(DECODE.values())),
        store_dir=str(tmp / "ranks")).join()
    out, err = jax_run.communicate(timeout=600)
    assert jax_run.returncode == 0 and "JAX-SHARDED-OK" in out, err
    ref = dict(np.load(tmp / "out.npz"))
    return (dict(zip(PROBLEMS, paged)), dict(zip(DECODE, decode)), ref)


def _regime(name):
    return "pages" if name.split("-")[1].startswith("1x") else "heads"


@pytest.mark.parametrize("name", JAX_SHARDED)
def test_sharded_paged_matches_jax(runs, name):
    """Decode and prefill, f32 and int8, both regimes: the port's 4-rank
    output within 2e-6 of the JAX package's ``paged_attention_sharded``."""
    paged, _, ref = runs
    np.testing.assert_allclose(paged[name]["out"], ref[name], rtol=2e-6,
                               atol=2e-6, err_msg=name)


@pytest.mark.parametrize("name", [n for n in PROBLEMS
                                  if not n.startswith("perm")])
def test_sharded_paged_matches_single_device(runs, name):
    """Every problem: the port's 4-rank output within 2e-6 of its
    single-device paged path on the whole pool (which
    ``tests/test_torch_paged_attention.py`` holds to the JAX package)."""
    paged, _, _ = runs
    p = PROBLEMS[name]
    t = {k: torch.as_tensor(v) for k, v in p.items()
         if k not in ("impl", "kvh")}
    kw = dict(backend="dense", k_scales=t.get("k_scales"),
              v_scales=t.get("v_scales"))
    pol = R.policy_of(p["impl"])
    if "q_start" in t:
        want = TOPS.lut_attention_paged_prefill(
            t["q"], t["k_pages"], t["v_pages"], t["bt"], t["q_start"],
            t["kv_lens"], pol, **kw)
    else:
        want = TOPS.lut_attention_paged_decode(
            t["q"], t["k_pages"], t["v_pages"], t["bt"], t["kv_lens"], pol,
            **kw)
    np.testing.assert_allclose(paged[name]["out"], want.numpy(), rtol=2e-6,
                               atol=2e-6, err_msg=name)


def _dense_sigma(p):
    """The JAX dense path's σ on the whole block-table view."""
    pol = (JPol(impl=p["impl"], precision="uint8") if p["impl"] != "exact"
           else JPol())
    import jax.numpy as jnp
    q = jnp.asarray(p["q"])
    k = JOPS.gather_pages(jnp.asarray(p["k_pages"]), jnp.asarray(p["bt"]))
    if "k_scales" in p:
        k = k.astype(jnp.float32) * JOPS.gather_page_scales(
            jnp.asarray(p["k_scales"]), jnp.asarray(p["bt"]))[..., None]
    s = JREF._logits(q, k, DH ** -0.5, causal=False)
    lk, lq = k.shape[2], q.shape[2]
    ki = jnp.arange(lk)
    mask = (ki[None, :] < jnp.asarray(p["kv_lens"])[:, None])[:, None,
                                                               None, :]
    if "q_start" in p:
        qi = jnp.asarray(p["q_start"])[:, None] + jnp.arange(lq)[None, :]
        mask = mask & (ki[None, None, None, :] <= qi[:, None, :, None])
    return np.asarray(JOPS._policy_softmax(jnp.where(mask, s, -jnp.inf),
                                           pol))


@pytest.mark.parametrize("name", [n for n in PROBLEMS if _regime(n) == "pages"
                                  and not n.startswith("perm")])
def test_pages_regime_sigma_is_the_dense_sigma(runs, name):
    """Each rank's σ over its slab after the max and Σ all-reduces,
    summed over the ranks, is bitwise the JAX dense path's σ for REXP
    and 2D-LUT (ulp-close for exact, whose Σ reassociates)."""
    paged, _, _ = runs
    p = PROBLEMS[name]
    got, want = paged[name]["sigma"], _dense_sigma(p)
    if p["impl"] == "exact":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("name", [n for n in PROBLEMS
                                  if n.startswith("perm")])
def test_sharded_dispatch_permutation_invariance(runs, name):
    """Relabelled physical pages give the same output: bitwise in
    'heads' (pages never change rank), within 2e-6 in 'pages'."""
    paged, _, _ = runs
    base = paged[name.replace("perm", "decode", 1)]["out"]
    out = paged[name]["out"]
    if _regime(name) == "heads":
        np.testing.assert_array_equal(out, base, err_msg=name)
    else:
        np.testing.assert_allclose(out, base, rtol=2e-6, atol=2e-6,
                                   err_msg=name)


@pytest.mark.parametrize("name", [n for n in PROBLEMS
                                  if n.startswith("decode")
                                  or n.startswith("prefill")])
def test_sharded_paged_wire(runs, name):
    """The call's collectives: the (B, H, Lq, D) output gather in
    'heads'; max and Σ (B, H, Lq, 1) and σ·V (B, H, Lq, D) all-reduces
    in 'pages' — in that order, nothing KV-sized."""
    paged, _, _ = runs
    p = PROBLEMS[name]
    b, h, lq, d = p["q"].shape
    got = [(site, kind, shape) for site, kind, shape, _, _
           in paged[name]["records"]]
    if _regime(name) == "heads":
        assert got == [("attn_out", "all_gather", (b, h, lq, d))]
    else:
        assert got == [("pages_max", "all_reduce_max", (b, h, lq, 1)),
                       ("pages_sum", "all_reduce_sum", (b, h, lq, 1)),
                       ("pages_pv", "all_reduce_sum", (b, h, lq, d))]


@pytest.mark.parametrize("impl", ["exact", "rexp"])
def test_sharded_decode_matches_jax(runs, impl):
    """Length-sharded lockstep decode (KVH 3 on 4 ranks, kv_len 50):
    within 2e-5 of the JAX package's ``lut_decode_sharded``."""
    _, decode, ref = runs
    np.testing.assert_allclose(decode[impl]["out"], ref[f"ld-{impl}"],
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("impl", ["exact", "rexp"])
def test_lockstep_attention_takes_the_sharded_decode(runs, impl):
    """A one-token step of ``layers.apply_attention`` against an
    ``AttnCache`` under the mesh (KVH does not divide tp) runs the
    length-sharded decode — its three partial rounds on the wire — and
    returns its output."""
    _, decode, _ = runs
    res = decode[impl]
    assert res["sites"] == ["decode_max", "decode_sum", "decode_u"]
    np.testing.assert_array_equal(res["hook"], res["direct"])


def test_sharded_decode_rejects_lut2d():
    from repro_torch.kernels.lut_attention.sharded_decode import (
        lut_decode_sharded)
    from repro_torch.runtime.partitioning import Mesh
    mesh = Mesh(tp=4, rank=0, device=torch.device("cpu"), backend="gloo")
    x = torch.zeros((1, 2, 1, 4))
    with pytest.raises(ValueError, match="exact and rexp"):
        lut_decode_sharded(x, x, x, R.policy_of("lut2d"), kv_len=1,
                           mesh=mesh)
