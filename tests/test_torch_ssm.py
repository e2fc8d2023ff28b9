"""The port's recurrent mixers and hybrid/recurrent decoders against the
JAX package's.

* ``models.ssm.apply_mamba`` / ``apply_mlstm`` / ``apply_slstm`` against
  ``repro.models.ssm``'s on the same numpy weights and inputs, f32, in
  the three modes: the full sequence with no cache, a prefill into a
  cache (from a random state), then 4 decode steps from it; at S = 5, 20
  and 37 with the JAX package's ``chunk`` at 8 (several chunks, the last
  one partial) and 128 (one partial chunk).  The port loops over the
  steps; the JAX package scans in chunks (an associative scan within a
  Mamba chunk), so the f32 sums run in other orders: outputs and every
  cache leaf agree within ``TOL`` (1e-5) of their largest entry.
* Jamba-v0.1-52B and xLSTM-125M scaled down (d_model 64, 4 heads, vocab
  128, one period: Jamba's 8 layers with 4 experts, top-2; xLSTM's 4)
  through ``serve_loop.generate`` against the JAX ``generate``: equal
  greedy tokens under exact, REXP uint8 and 2D-LUT uint8 (router exact),
  Jamba also with ``kv_dtype="int8"``; the prefill's and every decode
  step's logits, teacher-forced on the JAX tokens, within ``TOL`` of
  their largest entry.
* ``params_from_jax`` carries every leaf once, the port's own init
  builds the same tree, and ``cast_params`` keeps exactly the leaves the
  JAX package reads in f32.
* Both engines and ``init_paged_pools`` refuse both archs with
  ``NotImplementedError``; the launcher falls back to lockstep and
  samples ``generate``'s tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import RunConfig as JRun
from repro.core.policies import SoftmaxPolicy as JPol
from repro.models import build_model as jax_build
from repro.models import ssm as JSSM
from repro.runtime import serve_loop as JSL
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import RunConfig as TRun
from repro_torch.core.policies import SoftmaxPolicy as TPol
from repro_torch.models import build_model as torch_build
from repro_torch.models import ssm as TSSM
from repro_torch.models import transformer as TF
from repro_torch.models.convert import (F32_LEAVES, cast_params,
                                        params_from_jax)
from repro_torch.runtime import serve_loop as TSL
from repro_torch.runtime.engine import EngineConfig as TEngineConfig
from repro_torch.runtime.engine import PipelinedEngine
from repro_torch.runtime.engine import ServingEngine as TEngine
from repro_torch.runtime.paged_cache import PagedCacheConfig as TCache

torch.set_num_threads(1)

TOL = 1e-5                     # of the largest entry
VOCAB = 128
D, HEADS, B = 32, 4, 2
ARCH_NAMES = ("jamba-v0.1-52b", "xlstm-125m")
IMPLS = ("exact", "rexp", "lut2d")


def _close(got: torch.Tensor, ref, what=""):
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=TOL * np.abs(ref).max(), err_msg=what)


# ---------------------------------------------------------------------------
# The three mixers
# ---------------------------------------------------------------------------

#: mixer → (JAX init, JAX apply kwargs, port apply, port cache class, the
#: cache's leaves)
MIXERS = {
    "mamba": (lambda k: JSSM.init_mamba(k, D), {}, TSSM.apply_mamba,
              TSSM.MambaCache, ("h", "conv")),
    "mlstm": (lambda k: JSSM.init_mlstm(k, D, HEADS), dict(n_heads=HEADS),
              TSSM.apply_mlstm, TSSM.MLSTMCache, ("c", "n", "m")),
    "slstm": (lambda k: JSSM.init_slstm(k, D, HEADS), dict(n_heads=HEADS),
              TSSM.apply_slstm, TSSM.SLSTMCache, ("c", "n", "h", "m")),
}
J_APPLY = {"mamba": JSSM.apply_mamba, "mlstm": JSSM.apply_mlstm,
           "slstm": JSSM.apply_slstm}


def _random_state(rng, mixer):
    """A non-zero starting state of the mixer's cache (numpy leaves), so
    a prefill that ignored it would show."""
    dh = D // HEADS
    shapes = {"mamba": {"h": (B, 2 * D, JSSM.D_STATE),
                        "conv": (B, JSSM.D_CONV - 1, 2 * D)},
              "mlstm": {"c": (B, HEADS, dh, dh), "n": (B, HEADS, dh),
                        "m": (B, HEADS)},
              "slstm": {k: (B, HEADS, dh) for k in ("c", "n", "h", "m")}}
    return {k: (0.5 * rng.normal(size=s)).astype(np.float32)
            for k, s in shapes[mixer].items()}


@pytest.mark.parametrize("chunk", [8, 128])
@pytest.mark.parametrize("s", [5, 20, 37])
@pytest.mark.parametrize("mixer", sorted(MIXERS))
def test_mixer_matches_jax(mixer, s, chunk):
    j_init, kw, t_apply, cache_cls, leaves = MIXERS[mixer]
    seed = 100 * sorted(MIXERS).index(mixer) + s
    rng = np.random.default_rng(seed)
    jp = jax.tree_util.tree_map(np.asarray, j_init(jax.random.PRNGKey(seed)))
    tp = params_from_jax(jp, device="cpu")
    j_apply = J_APPLY[mixer]
    x = rng.normal(size=(B, s, D)).astype(np.float32)

    # the full sequence, no cache
    ref, _ = j_apply(jp, jnp.asarray(x), chunk=chunk, **kw)
    _close(t_apply(tp, torch.from_numpy(x), **kw), ref, "full sequence")

    # a prefill into a cache, from a random state
    state = _random_state(rng, mixer)
    jcache = {k: jnp.asarray(v) for k, v in state.items()}
    tcache = cache_cls(**{k: torch.from_numpy(v.copy())
                          for k, v in state.items()})
    ref, jcache = j_apply(jp, jnp.asarray(x), chunk=chunk, cache=jcache,
                          **kw)
    _close(t_apply(tp, torch.from_numpy(x), cache=tcache, **kw), ref,
           "prefill")
    for leaf in leaves:
        _close(getattr(tcache, leaf), jcache[leaf], f"prefill {leaf}")

    # 4 decode steps from it
    for step in range(4):
        xd = rng.normal(size=(B, 1, D)).astype(np.float32)
        ref, jcache = j_apply(jp, jnp.asarray(xd), chunk=chunk,
                              cache=jcache, **kw)
        _close(t_apply(tp, torch.from_numpy(xd), cache=tcache, **kw), ref,
               f"decode {step}")
        for leaf in leaves:
            _close(getattr(tcache, leaf), jcache[leaf],
                   f"decode {step} {leaf}")


def test_cache_layouts():
    """The caches' shapes and dtypes: Mamba's conv tail in the
    activation dtype, every state leaf f32; sLSTM's stabiliser per
    element."""
    mc = TSSM.MambaCache.zeros(3, 64, torch.bfloat16, "cpu")
    assert mc.h.shape == (3, 128, 16) and mc.h.dtype == torch.float32
    assert mc.conv.shape == (3, 3, 128) and mc.conv.dtype == torch.bfloat16
    ml = TSSM.MLSTMCache.zeros(3, 64, 4, "cpu")
    assert (ml.c.shape, ml.n.shape, ml.m.shape) == (
        (3, 4, 16, 16), (3, 4, 16), (3, 4))
    sl = TSSM.SLSTMCache.zeros(3, 64, 4, "cpu")
    assert all(getattr(sl, k).shape == (3, 4, 16)
               and getattr(sl, k).dtype == torch.float32
               for k in ("c", "n", "h", "m"))


def test_slstm_recurrent_weights_take_the_input_index_first():
    """``r_*`` (H, dh, dh) contracts as ``einsum("bhj,hji->bhi")``: with
    one head's weight a non-symmetric matrix, a transposed contraction
    gives another output."""
    jp = jax.tree_util.tree_map(np.asarray, JSSM.init_slstm(
        jax.random.PRNGKey(7), D, HEADS))
    x = np.random.default_rng(7).normal(size=(B, 6, D)).astype(np.float32)
    ref, _ = JSSM.apply_slstm(jp, jnp.asarray(x), n_heads=HEADS)
    tp = params_from_jax(jp, device="cpu")
    _close(TSSM.apply_slstm(tp, torch.from_numpy(x), n_heads=HEADS), ref)
    flipped = {**tp, **{k: tp[k].transpose(1, 2).contiguous()
                        for k in ("r_z", "r_i", "r_f", "r_o")}}
    out = TSSM.apply_slstm(flipped, torch.from_numpy(x), n_heads=HEADS)
    assert np.abs(out.numpy() - np.asarray(ref)).max() > \
        100 * TOL * np.abs(np.asarray(ref)).max()


def test_mlstm_stabiliser_keeps_long_sequences_finite():
    """300 steps with the forget-gate bias of 3 and large input gates:
    the stabilised state stays finite and matches the JAX package."""
    jp = jax.tree_util.tree_map(np.asarray, JSSM.init_mlstm(
        jax.random.PRNGKey(3), D, HEADS))
    jp["w_igate"] = jp["w_igate"] * 20.0
    x = np.random.default_rng(3).normal(size=(1, 300, D)).astype(np.float32)
    ref, _ = JSSM.apply_mlstm(jp, jnp.asarray(x), n_heads=HEADS, chunk=64)
    out = TSSM.apply_mlstm(params_from_jax(jp, device="cpu"),
                           torch.from_numpy(x), n_heads=HEADS)
    assert torch.isfinite(out).all()
    _close(out, ref)


# ---------------------------------------------------------------------------
# The scaled-down decoders through the lockstep path
# ---------------------------------------------------------------------------


def _arch(archs, name):
    return archs[name].scaled_down(d_model=64, n_heads=4, vocab=VOCAB,
                                   n_periods=1)


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in ARCH_NAMES:
        jm, tm = jax_build(_arch(JARCHS, name)), torch_build(_arch(TARCHS,
                                                                  name))
        jp = jm.init(jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")
        out[name] = (jm, jp, tm, tp)
    return out


def _kw(impl):
    return dict(impl=impl, precision="uint8") if impl != "exact" else {}


def _runs(impl, kv_dtype="f32"):
    """The JAX run scans its recurrences in chunks of 8 (the 11-token
    prompt spans two, the second partial)."""
    return (JRun(dtype="float32", attention_backend="naive",
                 softmax_policy=JPol(**_kw(impl)), kv_dtype=kv_dtype,
                 ssm_chunk=8),
            TRun(dtype="float32", softmax_policy=TPol(**_kw(impl)),
                 kv_dtype=kv_dtype))


GEN_CASES = ([(arch, impl, "f32") for arch in ARCH_NAMES for impl in IMPLS]
             + [("jamba-v0.1-52b", "rexp", "int8")])
NEW_TOKENS = 8


@pytest.mark.parametrize("case", GEN_CASES, ids="-".join)
def test_generate_matches_jax(models, case):
    """Equal greedy tokens from ``generate``; then the prefill's and each
    decode step's logits, fed the JAX tokens, within ``TOL``."""
    arch, impl, kv = case
    jm, jp, tm, tp = models[arch]
    jrun, trun = _runs(impl, kv)
    prompt = np.random.default_rng(5).integers(0, VOCAB, size=(3, 11)) \
        .astype(np.int32)
    ref = np.asarray(JSL.generate(jm, jp, jnp.asarray(prompt), jrun,
                                  max_new_tokens=NEW_TOKENS))
    out = TSL.generate(tm, tp, torch.from_numpy(prompt), trun,
                       max_new_tokens=NEW_TOKENS)
    np.testing.assert_array_equal(out.numpy(), ref)

    max_len = prompt.shape[1] + NEW_TOKENS
    jl, jstate = jax.jit(lambda p, t: jm.prefill(p, t, jrun, max_len,
                                                 logits="last"))(
        jp, jnp.asarray(prompt))
    tl, tstate = tm.prefill(tp, torch.from_numpy(prompt), trun, max_len,
                            logits="last")
    _close(tl, jl, "prefill logits")
    j_step = jax.jit(lambda p, t, s: jm.decode_step(p, t, s, jrun))
    for i in range(NEW_TOKENS - 1):
        tok = ref[:, i:i + 1].copy()
        jl, jstate = j_step(jp, jnp.asarray(tok), jstate)
        tl, tstate = tm.decode_step(tp, torch.from_numpy(tok), tstate, trun)
        _close(tl, jl, f"decode step {i} logits")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _paths(tree):
    return sorted(((p, tuple(leaf.shape)) for p, leaf in _leaves(tree)),
                  key=str)


#: the leaves the JAX package reads in f32, by arch, besides norm scales
F32_BY_ARCH = {
    "jamba-v0.1-52b": {"router", "dt_proj", "dt_bias", "a_log", "d_skip"},
    "xlstm-125m": {"w_igate", "w_fgate", "fgate_bias", "r_z", "r_i", "r_f",
                   "r_o"},
}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_params_convert_and_cast(models, arch):
    """Every leaf once, shapes equal, values copied as they are; the
    port's own init builds the same tree; its bf16 init equals
    ``cast_params`` of its f32 init, which keeps exactly the leaves the
    JAX package reads in f32."""
    jm, jp, tm, tp = models[arch]
    jleaves = _paths(jax.tree_util.tree_map(np.asarray, jp))
    assert _paths(tp) == jleaves
    assert len({p for p, _ in jleaves}) == len(jleaves)
    for path, leaf in _leaves(tp):
        ref = jp
        for k in path:
            ref = ref[k]
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref))
    own = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert _paths(own) == jleaves
    bf = tm.init(torch.Generator().manual_seed(0), device="cpu",
                 dtype=torch.bfloat16)
    cast = dict(_leaves(cast_params(own, torch.bfloat16)))
    kept = set()
    for path, leaf in _leaves(bf):
        assert leaf.dtype == cast[path].dtype and torch.equal(leaf,
                                                              cast[path])
        if leaf.dtype == torch.float32:
            kept.add(path[-1])
        else:
            assert leaf.dtype == torch.bfloat16 and path[-1] not in \
                F32_LEAVES, path
    assert kept == F32_BY_ARCH[arch] | {"scale"}


# ---------------------------------------------------------------------------
# What refuses them, and the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_paged_paths_refuse_the_recurrent_mixers(models, arch):
    _, _, tm, tp = models[arch]
    mixer = "mamba" if arch.startswith("jamba") else "mlstm"
    trun = _runs("rexp")[1]
    cfg = TEngineConfig(cache=TCache(n_pages=8, page_size=4,
                                     max_pages_per_seq=4))
    for cls in (TEngine, PipelinedEngine):
        with pytest.raises(NotImplementedError, match=mixer):
            cls(tm, tp, trun, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=mixer):
        tm.init_paged_pools(8, 4, trun, "cpu")
    with pytest.raises(NotImplementedError, match=mixer):
        TF.init_paged_pools(tm.cfg, 8, 4, torch.float32, "cpu")
    assert not TF.paged_supported(tm.cfg)
    TF.check_supported(tm.cfg)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_launcher_falls_back_to_lockstep(capsys, arch):
    """``--engine continuous`` prints the fall-back line and serves
    lockstep; the sample tokens are ``generate``'s for the same seed."""
    from repro_torch.launch import serve as SERVE
    argv = ["--arch", arch, "--scale-down", "64,4,128", "--layers", "1",
            "--device", "cpu", "--batch", "2", "--prompt-len", "9",
            "--new-tokens", "5", "--seed", "4"]
    SERVE.main(argv + ["--engine", "continuous"])
    out = capsys.readouterr().out
    assert ("the continuous engine serves attention-only decoder LMs; "
            "falling back to lockstep") in out
    layers = 8 if arch.startswith("jamba") else 4
    assert f"{arch} x{layers} layers on cpu" in out and "lockstep" in out
    cfg = _arch(TARCHS, arch)
    model = torch_build(cfg)
    params = model.init(torch.Generator().manual_seed(4), "cpu")
    prompt = np.random.default_rng(4).integers(0, VOCAB, size=(2, 9))
    toks = TSL.generate(model, params, torch.as_tensor(prompt,
                                                       dtype=torch.int32),
                        TRun(dtype="float32",
                             softmax_policy=TPol(impl="rexp",
                                                 precision="uint8")),
                        max_new_tokens=5, seed=4)
    assert out.splitlines()[-1] == f"sample token ids: {toks[0].tolist()}"


@pytest.mark.parametrize("flags,match", [
    (["--tp", "2"], "--tp > 1 requires"),
    (["--serve"], "--serve requires"),
    (["--prefix-cache"], "--prefix-cache requires")])
def test_launcher_refuses_engine_flags_on_recurrent_archs(capsys, flags,
                                                          match):
    from repro_torch.launch import serve as SERVE
    for arch in ARCH_NAMES:
        with pytest.raises(SystemExit):
            SERVE.main(["--arch", arch, "--scale-down", "64,4,128",
                        "--layers", "1", "--device", "cpu", "--batch", "1",
                        "--prompt-len", "4", "--new-tokens", "2"] + flags)
        assert match in capsys.readouterr().err
