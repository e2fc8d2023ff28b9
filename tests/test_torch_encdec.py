"""The port's Whisper encoder-decoder against the JAX package's.

Weights come from the JAX package (``model.init``) through
``params_from_jax``: Whisper-small scaled down to d_model 64, 4 heads,
vocab 128, 4 encoder and 2 decoder layers, 32 frames, f32.  Every
attention, LayerNorm and projection bias is set to a seeded non-zero
value first — the JAX package initializes them to zero, and a parity
test on zero biases would never test the bias path.

* ``params_from_jax`` converts every leaf of the list-valued
  ``encoder`` / ``decoder`` trees once.
* ``encode`` agrees with the JAX ``encode`` under its ``pallas``
  backend (``lut_attention_pallas`` in interpret mode) and its
  ``naive`` one, within 1e-4: XLA and torch order the f32 matmul sums
  differently, and the LUT policies' bins ride on those logits.
* Teacher-forced ``prefill`` and ``decode_step`` logits agree within
  1e-4 (the decoder-only suites' tolerance), and greedy ``generate``
  gives the JAX package's tokens under exact, REXP and 2D-LUT.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import RunConfig as JRun
from repro.core.policies import SoftmaxPolicy as JPol
from repro.models import build_model as jax_build
from repro.models import encdec as JED
from repro.runtime import serve_loop as JSL
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import RunConfig as TRun
from repro_torch.core.policies import SoftmaxPolicy as TPol
from repro_torch.launch import serve
from repro_torch.models import build_model as torch_build
from repro_torch.models import encdec as TED
from repro_torch.models import layers as TL
from repro_torch.models.convert import cast_params, params_from_jax, tree_map
from repro_torch.runtime import serve_loop as TSL

torch.set_num_threads(1)

IMPLS = ("exact", "rexp", "lut2d")
VOCAB = 128
TOL = dict(rtol=1e-4, atol=1e-4)
BIASES = ("bq", "bk", "bv", "bo", "bias")


def _arch(archs):
    return archs["whisper-small"].scaled_down(d_model=64, n_heads=4,
                                              vocab=VOCAB, n_periods=2)


def _with_biases(tree, rng):
    """Every bias leaf (attention and LayerNorm) seeded non-zero."""
    if isinstance(tree, dict):
        return {k: (rng.normal(scale=0.2, size=np.shape(v)).astype(np.float32)
                    if k in BIASES else _with_biases(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_biases(v, rng) for v in tree]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def models():
    jm, tm = jax_build(_arch(JARCHS)), torch_build(_arch(TARCHS))
    jp = _with_biases(jm.init(jax.random.PRNGKey(0)),
                      np.random.default_rng(11))
    tp = params_from_jax(jp, device="cpu")
    frames = np.random.default_rng(12).normal(
        size=(3, tm.cfg.encoder_seq, tm.cfg.d_model)).astype(np.float32)
    return jm, jax.tree_util.tree_map(jnp.asarray, jp), tm, tp, frames


def _kw(impl):
    return dict(impl=impl, precision="uint8") if impl != "exact" else {}


def _runs(impl, jax_backend="naive"):
    return (JRun(dtype="float32", attention_backend=jax_backend,
                 softmax_policy=JPol(**_kw(impl))),
            TRun(dtype="float32", softmax_policy=TPol(**_kw(impl))))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def test_arch_and_model_shape():
    """The config is a copy of the JAX package's, field for field."""
    arch = TARCHS["whisper-small"]
    assert dataclasses.asdict(arch) == dataclasses.asdict(
        JARCHS["whisper-small"])
    assert (arch.n_layers, arch.encoder_layers, arch.n_heads,
            arch.resolved_head_dim, arch.encoder_seq) == (12, 12, 12, 64, 1500)
    assert torch_build(arch).is_encdec
    small = _arch(TARCHS)
    assert (small.encoder_layers, small.n_layers, small.encoder_seq) \
        == (4, 2, 32)


def test_params_from_jax_covers_every_whisper_leaf_once(models):
    jm, jp, tm, tp, _ = models
    jl = dict(_leaves(jax.tree_util.tree_map(np.asarray, jp)))
    tl = dict(_leaves(tp))
    assert set(jl) == set(tl)
    assert len(tp["encoder"]) == 4 and len(tp["decoder"]) == 2
    assert {p[-1] for p in tl} >= {"bq", "bk", "bv", "bo", "bias", "scale"}
    ptrs = [t.data_ptr() for t in tl.values()]
    assert len(set(ptrs)) == len(ptrs)            # each leaf its own tensor
    for path, arr in jl.items():
        np.testing.assert_array_equal(tl[path].numpy(), arr, err_msg=path)
    n_bias = sum(p[-1] in BIASES for p in tl)
    assert n_bias == 4 * (4 + 2) + 2 * (8 + 3) + 2   # attn, LN, final LNs
    # the serving cast keeps the norms (scale and LayerNorm bias) in f32
    cast = cast_params(tp, torch.bfloat16)
    for path, t in _leaves(cast):
        norm = path[-1] in ("scale", "bias")
        assert t.dtype == (torch.float32 if norm else torch.bfloat16), path
    # and a fresh port init has the JAX package's tree
    fresh = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert {p: tuple(t.shape) for p, t in _leaves(fresh)} \
        == {p: tuple(np.shape(a)) for p, a in jl.items()}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("jax_backend", ["pallas", "naive"])
def test_encode_matches_jax(models, impl, jax_backend):
    jm, jp, tm, tp, frames = models
    jrun, trun = _runs(impl, jax_backend)
    ref = JED.encode(jp, jnp.asarray(frames), jm.cfg, jrun, jrun.softmax_policy)
    out = TED.encode(tp, torch.from_numpy(frames), tm.cfg, trun,
                     trun.softmax_policy)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_sinusoidal_positions_match_jax():
    for offset in (0, 7):
        np.testing.assert_allclose(
            TED.sinusoidal_positions(20, 64, offset, device="cpu").numpy(),
            np.asarray(JED.sinusoidal_positions(20, 64, offset)),
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("impl", IMPLS)
def test_teacher_forced_logits_match_jax(models, impl):
    """Prefill of a 6-token prompt (logits at every position), then five
    forced decode steps: cached causal self-attention with kv_len < the
    allocated 16 positions, cross-attention to the cached encoder K/V."""
    jm, jp, tm, tp, frames = models
    jrun, trun = _runs(impl)
    toks = np.random.default_rng(5).integers(0, VOCAB, size=(3, 11)) \
        .astype(np.int32)
    jl, jstate = jm.prefill(jp, jnp.asarray(toks[:, :6]), jrun, 16,
                            encoder_input=jnp.asarray(frames))
    tl, tstate = tm.prefill(tp, torch.from_numpy(toks[:, :6]), trun, 16,
                            encoder_input=torch.from_numpy(frames))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for i in range(6, 11):
        jl, jstate = jm.decode_step(jp, jnp.asarray(toks[:, i:i + 1]),
                                    jstate, jrun)
        tl, tstate = tm.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]),
                                    tstate, trun)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    caches, cross = tstate
    assert caches[0].length == 11 and caches[0].k.shape[2] == 16
    assert cross[0][0].shape == (3, 4, 32, 16) and cross[0][0].is_contiguous()


@pytest.mark.parametrize("impl", IMPLS)
def test_generate_matches_jax(models, impl):
    jm, jp, tm, tp, frames = models
    jrun, trun = _runs(impl)
    prompt = np.random.default_rng(3).integers(0, VOCAB, size=(3, 5)) \
        .astype(np.int32)
    ref = JSL.generate(jm, jp, jnp.asarray(prompt), jrun, max_new_tokens=12,
                       encoder_input=jnp.asarray(frames))
    out = TSL.generate(tm, tp, torch.from_numpy(prompt), trun,
                       max_new_tokens=12,
                       encoder_input=torch.from_numpy(frames))
    assert out.dtype == torch.int32 and out.shape == (3, 12)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_cross_attention_kv_x_equals_precomputed(models):
    """Projecting the source inside ``apply_attention`` (``kv_x``) is the
    once-projected ``cross_attention_kv`` path, and is never causal."""
    _, _, tm, tp, frames = models
    blk = tp["decoder"][0]["cross_attn"]
    cfg = tm.cfg
    src = torch.from_numpy(frames)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(3, 4, cfg.d_model)).astype(np.float32))
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.resolved_head_dim, rope_theta=None,
              policy=TPol(impl="rexp", precision="uint8"))
    kv = TL.cross_attention_kv(blk, src, n_kv_heads=cfg.n_kv_heads,
                               head_dim=cfg.resolved_head_dim)
    a = TL.apply_attention(blk, x, kv_x=src, **kw)
    b = TL.apply_attention(blk, x, precomputed_kv=kv, **kw)
    c = TL.apply_attention(blk, x, precomputed_kv=kv, causal=False, **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(b, c, rtol=0, atol=0)


def test_layer_norm_matches_jax():
    from repro.models import layers as JL
    rng = np.random.default_rng(8)
    x, s, b = (rng.normal(size=n).astype(np.float32)
               for n in ((4, 5, 32), (32,), (32,)))
    ref = JL.apply_norm({"scale": jnp.asarray(s), "bias": jnp.asarray(b)},
                        jnp.asarray(x), 1e-5)
    out = TL.apply_norm({"scale": torch.from_numpy(s),
                         "bias": torch.from_numpy(b)}, torch.from_numpy(x),
                        1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert TL.init_norm(32, "cpu", with_bias=True)["bias"].abs().sum() == 0


def test_paged_methods_raise_for_encdec(models):
    _, _, tm, tp, _ = models
    run = TRun(dtype="float32")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        tm.init_paged_pools(8, 4, run, "cpu")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        tm.decode_step_paged(tp, None, None, None, None, run)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        tm.prefill_chunk_paged(tp, None, None, None, None, None, run)


def test_launcher_serves_whisper_on_cpu(capsys):
    """``--arch whisper-small`` falls back from the engine to lockstep
    and serves seeded stub frames."""
    argv = ["--arch", "whisper-small", "--scale-down", "64,4,128",
            "--device", "cpu", "--batch", "2", "--prompt-len", "4",
            "--new-tokens", "3"]
    serve.main(argv)
    out = capsys.readouterr().out
    assert "falling back to lockstep" in out
    assert "whisper-small x4+2 layers on cpu" in out
    assert "[attention: naive]" in out
    first = out.splitlines()[-1]
    serve.main(argv + ["--attention-backend", "naive", "--engine",
                       "lockstep"])
    assert capsys.readouterr().out.splitlines()[-1] == first
    with pytest.raises(ValueError, match="CUDA tensors"):
        serve.main(argv + ["--attention-backend", "cuda"])


def test_tree_map_keeps_lists(models):
    _, _, _, tp, _ = models
    doubled = tree_map(lambda t, _: t * 2, tp)
    assert isinstance(doubled["encoder"], list)
    assert len(doubled["decoder"]) == len(tp["decoder"])
