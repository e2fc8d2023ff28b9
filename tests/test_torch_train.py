"""The port's training side against the JAX package's.

* The synthetic data: ``SyntheticDataset`` batches and host slices
  byte-equal to the JAX package's for several seeds, steps and both
  kinds.
* The optimizer pieces on the same numpy inputs, f32: ``cross_entropy``
  with and without label smoothing, ``global_norm``,
  ``clip_by_global_norm`` (clipping and not; in place), the decay
  mask's leaf set over a whole model's tree, one ``adamw_update``
  (constant and scheduled learning rate), ``compress_grads`` with error
  feedback over
  two rounds (the int8 codes equal: the dequantized values within one
  f32 ulp of the scale), and the schedules at step 0, the warm-up's end
  and the total.
* ``make_train_step`` for 5 steps from ``params_from_jax`` on the same
  synthetic batches against the JAX step at the default learning rate
  (3e-4): losses within 1e-5 relative, parameters and moments within
  1e-5 of each leaf's largest entry, at microbatch 1 and 2; with grad
  compression the same but for the int8 codes that roundoff moves across
  a rounding edge (``test_compressed_train_steps_match_jax``), and the
  compressed update alone fed the JAX gradients within 1e-6.  Adam moves every element by about ``lr`` whatever its
  gradient's size, so an element whose gradient is at the f32 roundoff
  of the two packages' sums (1e-6 of the leaf's largest) may move by
  ``lr`` in one and not the other: the parameters' agreement scales
  with the learning rate (at 3e-3 it is 5e-5).  Microbatch 1 against 2
  as the JAX package's own test holds them (rtol 2e-4, atol 2e-5).
* ``make_eval_step`` under exact, REXP uint8 and 2D-LUT uint8 against
  the JAX eval step (loss within 1e-5 relative, accuracy equal).
* The dense kernel's wrapper refuses inputs that require grad.

The gradients of ``train_logits`` are held to ``jax.value_and_grad`` in
``test_torch_train_grads.py``.
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
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import SyntheticDataset as JDataset
from repro.models import build_model as jax_build
from repro.optim import adamw as JADAM
from repro.optim import grad_compress as JGC
from repro.optim import schedules as JSCHED
from repro.runtime import train_loop as JTL
from repro_torch.configs import RunConfig as TRun
from repro_torch.core.policies import SoftmaxPolicy as TPol
from repro_torch.data import DataConfig, SyntheticDataset
from repro_torch.kernels.lut_attention.lut_attention import lut_attention_cuda
from repro_torch.kernels.lut_attention.ops import _tables_for
from repro_torch.models.convert import (params_from_jax, tree_flatten,
                                        tree_unflatten)
from repro_torch.optim import adamw as TADAM
from repro_torch.optim import grad_compress as TGC
from repro_torch.optim import schedules as TSCHED
from repro_torch.runtime import train_loop as TTL
from torch_train_util import (VOCAB, close_by_path, jax_paths, make_batch,
                              pair, torch_batch)

torch.set_num_threads(1)

STEP_TOL = 1e-5       # losses (relative) and parameters over 5 steps


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["markov", "uniform"])
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_synthetic_batches_byte_equal(kind, seed):
    kw = dict(vocab_size=300, seq_len=33, global_batch=6, seed=seed,
              kind=kind)
    ours, theirs = SyntheticDataset(DataConfig(**kw)), JDataset(
        JDataConfig(**kw))
    for step in (0, 1, 17, 10_000):
        a, b = ours.batch(step), theirs.batch(step)
        assert a.dtype == b.dtype == np.int32
        assert a.tobytes() == b.tobytes()
        sl = slice(2, 5)
        assert (ours.batch(step, host_slice=sl).tobytes()
                == theirs.batch(step, host_slice=sl).tobytes())
    got = [s for s, _ in zip(ours.batches(3), range(3))]
    assert [s for s, _ in got] == [3, 4, 5]


# ---------------------------------------------------------------------------
# Optimizer pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy(smoothing):
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (3, 7, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    ref = float(JTL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                  smoothing))
    got = float(TTL.cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(labels), smoothing))
    assert got == pytest.approx(ref, rel=1e-6)


def _grad_tree(rng, scale):
    return {"a": {"w_up": rng.normal(0, scale, (8, 5)).astype(np.float32)},
            "norm": {"scale": rng.normal(0, scale, (5,)).astype(np.float32)},
            "periods": [{"w": rng.normal(0, scale, (2, 3, 4))
                         .astype(np.float32)}]}


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_global_norm_and_clip(scale):
    tree = _grad_tree(np.random.default_rng(1), scale)
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = tree_unflatten(tree, [torch.from_numpy(x.copy()) for _, x in
                               tree_flatten(tree)])
    assert float(TADAM.global_norm(tt)) == pytest.approx(
        float(JADAM.global_norm(jt)), rel=1e-6)
    jc, jn = JADAM.clip_by_global_norm(jt, 1.0)
    tc, tn = TADAM.clip_by_global_norm(tt, 1.0)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    assert tc is tt                                 # scaled in place
    close_by_path(tc, jc, 1e-6, "clipped")


def test_decay_mask_leaf_set():
    """The decayed leaves of every family's tree are the JAX rule's."""
    for name in ("qwen3-32b", "granite-moe-3b-a800m", "jamba-v0.1-52b",
                 "xlstm-125m", "whisper-small"):
        arch = JARCHS[name].scaled_down(d_model=32, n_heads=4, vocab=64)
        jp = jax.eval_shape(jax_build(arch).init, jax.random.PRNGKey(0))
        flat, _ = jax.tree_util.tree_flatten_with_path(jp)
        ref = {p for (p, _), (path, _) in zip(jax_paths(jp), flat)
               if JADAM._decay_mask(path)}
        got = {p for p, _ in jax_paths(jp) if TADAM.decay_mask(p)}
        assert got == ref, name
        assert got and got != {p for p, _ in jax_paths(jp)}, name


@pytest.mark.parametrize("scheduled", [False, True])
def test_adamw_update(scheduled):
    rng = np.random.default_rng(2)
    params = _grad_tree(rng, 1.0)
    grads = [_grad_tree(rng, 0.5) for _ in range(3)]
    lr = ((JSCHED.linear_warmup_cosine(0.1, 2, 5),
           TSCHED.linear_warmup_cosine(0.1, 2, 5)) if scheduled
          else (0.05, 0.05))
    jcfg = JADAM.AdamWConfig(learning_rate=lr[0], weight_decay=0.3,
                             grad_clip=2.0)
    tcfg = TADAM.AdamWConfig(learning_rate=lr[1], weight_decay=0.3,
                             grad_clip=2.0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = JADAM.init_adamw(jp)
    tp = tree_unflatten(params, [torch.from_numpy(x.copy()) for _, x in
                                 tree_flatten(params)])
    ts = TADAM.init_adamw(tp)
    for g in grads:
        jp, js, jst = JADAM.adamw_update(jcfg, jp, jax.tree_util.tree_map(
            jnp.asarray, g), js)
        tg = tree_unflatten(g, [torch.from_numpy(x.copy()) for _, x in
                                tree_flatten(g)])
        tp, ts, tst = TADAM.adamw_update(tcfg, tp, tg, ts)
        for k in ("grad_norm", "lr"):
            assert float(tst[k]) == pytest.approx(float(jst[k]), rel=1e-6)
    assert ts.step.dtype == torch.int32 and int(ts.step) == int(js.step)
    close_by_path(tp, jp, 1e-6, "params")
    close_by_path(ts.m, js.m, 1e-6, "m")
    close_by_path(ts.v, js.v, 1e-6, "v")


def test_compress_grads_error_feedback():
    rng = np.random.default_rng(3)
    g = _grad_tree(rng, 1.0)
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    tg = tree_unflatten(g, [torch.from_numpy(x.copy()) for _, x in
                            tree_flatten(g)])
    jef, tef = JGC.init_error_feedback(jg), TGC.init_error_feedback(tg)
    for _ in range(2):
        jd, jef, jst = JGC.compress_grads(jg, jef)
        td, tef, tst = TGC.compress_grads(tg, tef)
        for (path, d), (_, jdl) in zip(tree_flatten(td), jax_paths(jd)):
            scale = float(np.abs(jdl).max()) / 127
            # the int8 codes equal; the dequantized values within an ulp
            np.testing.assert_array_equal(np.rint(d.numpy() / scale),
                                          np.rint(jdl / scale), err_msg=path)
            np.testing.assert_allclose(d.numpy(), jdl, rtol=1e-6, atol=0)
        close_by_path(tef, jef, 1e-6, "error feedback")
        assert float(tst["compress_residual"]) == pytest.approx(
            float(jst["compress_residual"]), rel=1e-5)


def test_schedules():
    j = JSCHED.linear_warmup_cosine(2e-3, 10, 100)
    t = TSCHED.linear_warmup_cosine(2e-3, 10, 100)
    for step in (0, 5, 10, 55, 100, 150):
        got = t(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(j(jnp.asarray(step))),
                                           rel=1e-6, abs=0)
    assert float(t(torch.tensor(0))) == 0.0
    assert float(TSCHED.constant(0.25)(torch.tensor(3))) == float(
        JSCHED.constant(0.25)(jnp.asarray(3)))


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------

STEPS = 5


def _run_both(microbatch=1, grad_compression=False, name="qwen3-32b"):
    jm, tm, jp = pair(name, seed=3)
    kw = dict(microbatch=microbatch, grad_compression=grad_compression)
    jrun = JRun(dtype="float32", attention_backend="naive", remat=True, **kw)
    trun = TRun(dtype="float32", remat=True, **kw)
    jstate = JTL.TrainState(
        params=jax.tree_util.tree_map(jnp.asarray, jp),
        opt=JADAM.init_adamw(jp),
        ef=JGC.init_error_feedback(jp) if grad_compression else None)
    tstate = TTL.train_state(params_from_jax(jp, device="cpu"), trun)
    jstep = jax.jit(JTL.make_train_step(jm, jrun))
    tstep = TTL.make_train_step(tm, trun)
    ds = SyntheticDataset(DataConfig(VOCAB, 16, 4, seed=5))
    jl, tl = [], []
    for step in range(STEPS):
        b = ds.batch(step)
        jstate, jm_ = jstep(jstate, {"tokens": jnp.asarray(b)})
        tstate, tm_ = tstep(tstate, {"tokens": torch.from_numpy(b)})
        jl.append(float(jm_["loss"]))
        tl.append(float(tm_["loss"]))
        if grad_compression:
            assert float(tm_["compress_residual"]) == pytest.approx(
                float(jm_["compress_residual"]), rel=1e-3)
    return jstate, tstate, jl, tl


@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_steps_match_jax(microbatch):
    jstate, tstate, jl, tl = _run_both(microbatch)
    np.testing.assert_allclose(tl, jl, rtol=STEP_TOL)
    assert int(tstate.opt.step) == STEPS
    close_by_path(tstate.params, jstate.params, STEP_TOL, "params")
    close_by_path(tstate.opt.m, jstate.opt.m, STEP_TOL, "m")
    close_by_path(tstate.opt.v, jstate.opt.v, STEP_TOL, "v")
    for _, p in tree_flatten(tstate.params):
        assert p.requires_grad and p.grad is None and p.dtype == torch.float32


def test_compressed_train_steps_match_jax():
    """With grad compression the losses hold to ``STEP_TOL``.  An int8
    code rounds ``g / scale`` to the nearest integer, so a gradient
    element whose quotient lies within the two packages' f32 roundoff of
    a half-integer takes codes one apart (a quantum of max|g| / 127):
    every element of the parameters and moments but such flips within
    ``STEP_TOL`` of its leaf's largest entry, the flips (at most a 1e-3
    share of a leaf) within ``lr · STEPS``.  The residuals (at most half
    a quantum) carry the gradients' roundoff at 127× their own scale;
    :func:`test_compressed_update_matches_jax` holds them on equal
    gradients."""
    jstate, tstate, jl, tl = _run_both(grad_compression=True)
    np.testing.assert_allclose(tl, jl, rtol=STEP_TOL)
    lr = TRun().learning_rate
    for what, got, ref in (("params", tstate.params, jstate.params),
                           ("m", tstate.opt.m, jstate.opt.m),
                           ("v", tstate.opt.v, jstate.opt.v)):
        ref = dict(jax_paths(ref))
        for path, g in tree_flatten(got):
            r = ref[path]
            d = np.abs(g.detach().numpy() - r)
            off = d > STEP_TOL * np.abs(r).max()
            assert off.mean() <= 1e-3, (what, path, int(off.sum()))
            if what == "params":
                assert d.max() <= lr * STEPS, (what, path, d.max())


def test_compressed_update_matches_jax():
    """The compressed update alone, fed the same (JAX) gradients at every
    step: ``compress_grads`` then ``adamw_update`` hold the JAX package's
    within 1e-6 of each leaf's largest entry over ``STEPS`` steps."""
    jm, _, jp = pair("qwen3-32b", seed=3)
    jrun = JRun(dtype="float32", attention_backend="naive")
    grad_fn = jax.jit(jax.value_and_grad(JTL.make_loss_fn(jm, jrun),
                                         has_aux=True))
    cfg = dict(learning_rate=3e-3, weight_decay=0.1, grad_clip=1.0)
    jcfg, tcfg = JADAM.AdamWConfig(**cfg), TADAM.AdamWConfig(**cfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    jopt, jef = JADAM.init_adamw(jp), JGC.init_error_feedback(jp)
    tparams = params_from_jax(jp, device="cpu")
    topt, tef = TADAM.init_adamw(tparams), TGC.init_error_feedback(tparams)
    ds = SyntheticDataset(DataConfig(VOCAB, 16, 4, seed=5))
    for step in range(STEPS):
        _, jg = grad_fn(jparams, {"tokens": jnp.asarray(ds.batch(step))})
        tg = params_from_jax(jg, device="cpu")
        jg, jef, _ = JGC.compress_grads(jg, jef)
        jparams, jopt, _ = JADAM.adamw_update(jcfg, jparams, jg, jopt)
        tg, tef, _ = TGC.compress_grads(tg, tef)
        tparams, topt, _ = TADAM.adamw_update(tcfg, tparams, tg, topt)
        # the next step's gradients are the JAX package's at its params
    close_by_path(tparams, jparams, 1e-6, "params")
    close_by_path(topt.m, jopt.m, 1e-6, "m")
    close_by_path(tef, jef, 1e-6, "error feedback")


def test_microbatch_equivalence():
    """a = 2 accumulation against a = 1 on the same global batch, as the
    JAX package's own test holds them."""
    _, tm, jp = pair("qwen3-32b", seed=4)
    batch = {"tokens": torch.from_numpy(SyntheticDataset(
        DataConfig(VOCAB, 16, 8, seed=2)).batch(0))}
    out = []
    for a in (1, 2):
        run = TRun(dtype="float32", microbatch=a, learning_rate=3e-3)
        state = TTL.train_state(params_from_jax(jp, device="cpu"), run)
        state, m = TTL.make_train_step(tm, run)(state, batch)
        out.append((state, float(m["loss"])))
    assert out[0][1] == pytest.approx(out[1][1], rel=1e-5)
    for (_, a), (_, b) in zip(tree_flatten(out[0][0].params),
                              tree_flatten(out[1][0].params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-4, atol=2e-5)


def test_microbatch_must_divide_batch():
    tm, jp = pair("qwen3-32b")[1:]
    run = TRun(dtype="float32", microbatch=3)
    state = TTL.train_state(params_from_jax(jp, device="cpu"), run)
    with pytest.raises(ValueError, match="microbatches"):
        TTL.make_train_step(tm, run)(state, {"tokens": torch.zeros(
            (4, 9), dtype=torch.int32)})


def test_train_state_refuses_bf16_masters():
    tm, jp = pair("qwen3-32b")[1:]
    params = params_from_jax(jp, device="cpu", dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        TTL.train_state(params, TRun())


# ---------------------------------------------------------------------------
# Eval steps
# ---------------------------------------------------------------------------

POLICIES = {"exact": dict(), "rexp": dict(impl="rexp", precision="uint8"),
            "lut2d": dict(impl="lut2d", precision="uint8")}


@pytest.mark.parametrize("impl", sorted(POLICIES))
@pytest.mark.parametrize("name", ["qwen3-32b", "whisper-small"])
def test_eval_step_matches_jax(name, impl):
    jm, tm, jp = pair(name, seed=6)
    batch = make_batch(jm.cfg, 3, 20, seed=7)
    jrun = JRun(dtype="float32", attention_backend="naive",
                softmax_policy=JPol(**POLICIES[impl]))
    trun = TRun(dtype="float32", softmax_policy=TPol(**POLICIES[impl]))
    ref = jax.jit(JTL.make_eval_step(jm, jrun))(
        jp, jax.tree_util.tree_map(jnp.asarray, batch))
    state = TTL.train_state(params_from_jax(jp, device="cpu"), trun)
    got = TTL.make_eval_step(tm, trun)(state.params, torch_batch(batch))
    assert not got["eval_loss"].requires_grad
    assert float(got["eval_loss"]) == pytest.approx(float(ref["eval_loss"]),
                                                    rel=STEP_TOL)
    assert float(got["next_token_acc"]) == float(ref["next_token_acc"])


# ---------------------------------------------------------------------------
# The dense kernel refuses autograd
# ---------------------------------------------------------------------------


def test_dense_kernel_wrapper_refuses_grad():
    """A tensor that requires grad never reaches the kernel (which has
    no backward): the wrapper raises before any launch, on the CPU as on
    the card; without grad the same call runs."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 5, 16, generator=g) for _ in range(3))
    pol = TPol(impl="rexp", precision="uint8")
    kw = dict(method="rexp", causal=True)
    with pytest.raises(RuntimeError, match="no backward"):
        lut_attention_cuda(q.requires_grad_(True), k, v, _tables_for(pol),
                           **kw)
    with torch.no_grad():
        out = lut_attention_cuda(q, k, v, _tables_for(pol), **kw)
    assert out.shape == (1, 2, 5, 16)
    q.requires_grad_(False)
    assert lut_attention_cuda(q, k, v, _tables_for(pol),
                              **kw).shape == out.shape


def test_run_config_training_defaults_match_jax():
    fields = ("remat", "microbatch", "learning_rate", "weight_decay",
              "grad_clip", "label_smoothing", "moe_aux_weight",
              "grad_compression")
    for f in fields:
        assert getattr(TRun(), f) == getattr(JRun(), f), f
    assert not {"scan_layers", "ssm_chunk", "probe_unroll"} & {
        f.name for f in dataclasses.fields(TRun)}
