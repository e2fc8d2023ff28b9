"""Lockstep serving on a mesh, and the encoder-decoder's sharded train
step, against the JAX package.

The JAX package serves its cells (``launch/cells.py``) as
``make_prefill_step`` / ``make_decode_step`` jitted under its active mesh,
the weights under ``make_param_shardings(fsdp=True)`` and the caches
under ``make_cache_shardings``.  The port runs one process a rank
(spawned gloo ranks on the CPU, ``repro_torch.launch.mesh.start_ranks``;
no network): the weights cut by ``serve_loop.serving_layout`` (FSDP over
``'data'``, tensor and expert parallelism over ``'model'``), each rank's
rows of the batch, each rank's cut of the caches.  The JAX side runs in a
subprocess on a forced 4-device CPU mesh, on the same numpy inits and
prompts:

* five scaled-down archs at ``(data 2, model 2)``, batch 4, prompt 8,
  caches of 16: Qwen3 with 2 KV heads (they divide ``'model'``: the
  cache's heads are cut), Qwen3 with 1 KV head (they do not: the cache's
  length is cut and a decode step takes ``sharded_decode``), DeepSeek-MoE
  (expert parallelism), Jamba (one period: Mamba layers, an MoE, an
  attention layer of 1 KV head) and Whisper (its cross K/V cut by heads);
* Qwen3 with 1 KV head at ``(data 2, model 1)``, batch 1, under
  ``shard_kv_seq``: the cache's length cut over ``'data'``;

each under exact, REXP and 2D-LUT (uint8): the prompt's last logits and
4 greedy decode steps.  The greedy tokens equal the JAX package's, and
every step's logits lie within 1e-4 of the largest in f32.  No token
parts (:data:`PARTINGS` names none).

Whisper's train step on ``(data 2, model 2)`` (its encoder cut as its
decoder) is held to the JAX package's single-device step as
``test_torch_sharded_train.py`` holds the decoders': the loss within
1e-5 relative, every gradient within 1e-4 of its leaf's largest entry.
"""

import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import ARCHS as JARCHS
from repro.configs import RunConfig as JRun
from repro.models import build_model as jax_build
from repro.runtime.train_loop import make_loss_fn as j_loss_fn
from repro_torch.launch.mesh import start_ranks

import torch_lockstep_ranks as LR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, MAX_LEN, STEPS, VOCAB = 4, 8, 16, 4, 128
SMALL = dict(d_model=64, n_heads=4, vocab=VOCAB)
ARCH_SPECS = {
    "qwen3-kv2": dict(base="qwen3-32b",
                      scale=dict(SMALL, n_kv_heads=2, n_periods=2)),
    "qwen3-kv1": dict(base="qwen3-32b",
                      scale=dict(SMALL, n_kv_heads=1, n_periods=2)),
    "deepseek-moe": dict(base="deepseek-moe-16b",
                         scale=dict(SMALL, n_periods=2)),
    "jamba": dict(base="jamba-v0.1-52b", scale=dict(SMALL, n_periods=1)),
    "whisper": dict(base="whisper-small", scale=dict(SMALL, n_periods=1)),
}
IMPLS = ("exact", "rexp", "lut2d")
CASES = [dict(spec, name=f"{arch}/{impl}", tree=arch, impl=impl,
              max_len=MAX_LEN, steps=STEPS)
         for arch, spec in ARCH_SPECS.items() for impl in IMPLS]
SEQ_CASES = [dict(ARCH_SPECS["qwen3-kv1"], name=f"kv-seq/{impl}",
                  tree="kv-seq", impl=impl, max_len=MAX_LEN, steps=STEPS,
                  shard_kv_seq=True) for impl in IMPLS]
#: tokens that part from the JAX package's, by (case, step, row), with
#: their top-2 margin in the JAX logits: none
PARTINGS: dict = {}
ENCDEC = dict(base="whisper-small", scale=dict(SMALL, n_periods=1))

_JAX = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import ARCHS
from repro.configs.base import RunConfig
from repro.core.policies import SoftmaxPolicy
from repro.models import build_model
from repro.runtime import partitioning as PT
from repro.runtime.serve_loop import make_decode_step, make_prefill_step
src, dst = sys.argv[1], sys.argv[2]
with open(src, 'rb') as f:
    cases, trees, prompts, frames = pickle.load(f)
out = {}
for case in cases:
    shape = case['mesh']
    mesh = Mesh(np.asarray(jax.devices()[:shape[0] * shape[1]])
                .reshape(shape), ('data', 'model'))
    arch = ARCHS[case['base']].scaled_down(**case['scale'])
    model = build_model(arch)
    pol = (SoftmaxPolicy(impl=case['impl'], precision='uint8')
           if case['impl'] != 'exact' else SoftmaxPolicy())
    run = RunConfig(dtype='float32', softmax_policy=pol,
                    attention_backend='naive',
                    shard_kv_seq=case.get('shard_kv_seq', False))
    tokens = prompts[case['tree']]
    b = tokens.shape[0]
    PT.set_active_mesh(mesh)
    params = jax.device_put(
        trees[case['tree']],
        PT.make_param_shardings(trees[case['tree']], mesh))
    cache_sh = PT.make_cache_shardings(
        model.decode_state_struct(b, case['max_len'], run), mesh, b,
        arch.n_kv_heads, run.shard_kv_seq, stacked=not model.is_encdec)
    fn0 = make_prefill_step(model, run, max_len=case['max_len'])
    args = [params, jax.device_put(tokens, PT.tokens_sharding(mesh, b))]
    if model.is_encdec:
        args.append(jax.device_put(frames[case['tree']], NamedSharding(
            mesh, P(*PT.batch_pspec(mesh, b), None, None))))
        fn = lambda p, t, e: fn0(p, t, encoder_input=e)
    else:
        fn = fn0
    logits, state = jax.jit(fn, out_shardings=(None, cache_sh))(*args)
    steps = [np.asarray(logits[:, -1])]
    decode = jax.jit(make_decode_step(model, run),
                     out_shardings=(None, cache_sh))
    tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    for _ in range(case['steps']):
        logits, state = decode(params, tok, state)
        steps.append(np.asarray(logits[:, -1]))
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    PT.set_active_mesh(None)
    out[case['name']] = steps
with open(dst, 'wb') as f:
    pickle.dump(out, f)
print('JAX-LOCKSTEP-OK')
"""


def _inputs():
    """The JAX package's seeded inits (numpy trees), the prompts and
    Whisper's stub frames, by tree name."""
    rng = np.random.default_rng(0)
    trees, prompts, frames = {}, {}, {}
    for name, spec in {**ARCH_SPECS, "kv-seq": ARCH_SPECS["qwen3-kv1"]}.items():
        arch = JARCHS[spec["base"]].scaled_down(**spec["scale"])
        params = jax_build(arch).init(jax.random.PRNGKey(len(trees) + 1))
        trees[name] = jax.tree_util.tree_map(np.asarray, params)
        b = 1 if name == "kv-seq" else B
        prompts[name] = rng.integers(0, VOCAB, (b, S)).astype(np.int32)
        frames[name] = (rng.standard_normal(
            (b, arch.encoder_seq, arch.d_model)).astype(np.float32)
            if arch.encoder_layers else None)
    return trees, prompts, frames


def _encdec_inputs():
    arch = JARCHS[ENCDEC["base"]].scaled_down(**ENCDEC["scale"])
    model = jax_build(arch)
    params = jax.tree_util.tree_map(np.asarray,
                                    model.init(jax.random.PRNGKey(7)))
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, VOCAB, (8, 13)).astype(np.int32),
             "encoder_input": rng.standard_normal(
                 (8, arch.encoder_seq, arch.d_model)).astype(np.float32)}
    return model, params, batch


def _jax_encdec(model, params, batch):
    run = JRun(dtype="float32", attention_backend="naive",
               scan_layers=True, remat=True)
    loss_fn = j_loss_fn(model, run)
    jb = jax.tree_util.tree_map(np.asarray, batch)
    (loss, _), grads = jax.value_and_grad(
        lambda p: loss_fn(p, jb), has_aux=True)(params)
    flat, _ = jax.tree_util.tree_flatten_with_path(grads)
    return float(loss), {
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
        np.asarray(g) for p, g in flat}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's ranks — the (2, 2) serving cases, the (2, 1)
    ``shard_kv_seq`` cases and the enc-dec grad step — beside the JAX
    subprocess; returns (port serving, JAX serving, port grads, JAX
    grads)."""
    tmp = tmp_path_factory.mktemp("lockstep")
    trees, prompts, frames = _inputs()
    jax_cases = ([dict(c, mesh=(2, 2)) for c in CASES]
                 + [dict(c, mesh=(2, 1)) for c in SEQ_CASES])
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump((jax_cases, trees, prompts, frames), f)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_run = subprocess.Popen(
        [sys.executable, "-c", _JAX, str(tmp / "in.pkl"),
         str(tmp / "out.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    serve = start_ranks(LR.serve_cases, backend="gloo", device="cpu",
                        axes={"data": 2, "model": 2},
                        args=(CASES, trees, prompts, frames),
                        store_dir=str(tmp / "serve"))
    seq = start_ranks(LR.serve_cases, backend="gloo", device="cpu",
                      axes={"data": 2, "model": 1},
                      args=(SEQ_CASES, trees, prompts, frames),
                      store_dir=str(tmp / "seq"))
    model, params, batch = _encdec_inputs()
    train = start_ranks(LR.encdec_grads, backend="gloo", device="cpu",
                        axes={"data": 2, "model": 2},
                        args=(ENCDEC, params, batch),
                        store_dir=str(tmp / "train"))
    jax_grads = _jax_encdec(model, params, batch)
    port = {**serve.join(), **seq.join()}
    port_grads = train.join()
    out, err = jax_run.communicate(timeout=900)
    assert jax_run.returncode == 0 and "JAX-LOCKSTEP-OK" in out, err
    with open(tmp / "out.pkl", "rb") as f:
        ref = pickle.load(f)
    return port, ref, port_grads, jax_grads


@pytest.mark.parametrize("case", CASES + SEQ_CASES, ids=lambda c: c["name"])
def test_lockstep_on_mesh_matches_jax(runs, case):
    port, ref = runs[0][case["name"]], runs[1][case["name"]]
    assert len(port["logits"]) == len(ref) == STEPS + 1
    for i, (got, want) in enumerate(zip(port["logits"], ref)):
        assert got.shape == want.shape, (i, got.shape, want.shape)
        parted = np.flatnonzero(got.argmax(-1) != want.argmax(-1))
        for row in parted:
            top2 = np.sort(want[row])[-2:]
            assert (case["name"], i, int(row)) in PARTINGS, (
                f"{case['name']} step {i} row {row} parts from the JAX "
                f"package's token (top-2 margin {top2[1] - top2[0]:.3e})")
        if parted.size:
            break     # the streams differ from here on
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-4, (case["name"], i, err)


@pytest.mark.parametrize("arch", list(ARCH_SPECS))
def test_lockstep_cache_is_the_ranks_cut(runs, arch):
    """Each rank holds its rows (2 of 4) and, where the KV heads divide
    'model', its KV heads — else half the length; Jamba's Mamba state is
    whole over 'model' (the port cuts no Mamba weight there)."""
    got = runs[0][f"{arch}/exact"]["cache_shapes"]
    kvh = LR.arch_of(ARCH_SPECS[arch]).n_kv_heads
    dh = 64 // 4
    attn = ((2, kvh // 2, MAX_LEN, dh) if kvh % 2 == 0
            else (2, kvh, MAX_LEN // 2, dh))
    assert attn in got, got
    if arch == "jamba":
        assert (2, 128, 16) in got and (2, 3, 128) in got, got


def test_length_cut_decode_takes_the_sharded_decode(runs):
    """A cache whose length is cut over 'model' decodes through the
    partials of ``sharded_decode`` (exact, REXP) — 2D-LUT, which it does
    not serve, gathers the shards, as does a length cut over 'data'
    alone, where the JAX package takes its unsharded route too — and
    the heads-cut cache through neither."""
    port = runs[0]
    for impl in ("exact", "rexp"):
        assert "decode_u" in port[f"qwen3-kv1/{impl}"]["sites"]
    for impl in IMPLS:
        assert "kv_gather" in port[f"kv-seq/{impl}"]["sites"]
    assert "kv_gather" in port["qwen3-kv1/lut2d"]["sites"]
    assert not {"decode_u", "kv_gather"} & set(port["qwen3-kv2/rexp"]["sites"])


def test_encdec_sharded_grads_match_jax(runs):
    """The key biases' gradients are zero in exact arithmetic (a bias
    added to every key moves a query's logits by one constant, which the
    softmax cancels): both sides give roundoff there, held to 1e-6 of the
    tree's largest gradient entry instead of their own."""
    got, (loss, grads) = runs[2], runs[3]
    assert abs(got["loss"] - loss) <= 1e-5 * abs(loss)
    assert sorted(got["grads"]) == sorted(grads)
    largest = max(np.abs(g).max() for g in grads.values())
    for path, want in grads.items():
        err = np.abs(got["grads"][path] - want).max()
        if path.endswith("/bk"):
            assert err <= 1e-6 * largest, (path, err)
        else:
            assert err <= 1e-4 * np.abs(want).max(), (path, err)
