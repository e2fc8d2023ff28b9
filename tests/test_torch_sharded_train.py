"""The port's sharded train step and elastic restore against the JAX
package's single-device step.

The port's counterparts of ``test_sharded_train_step_matches_single_device``
and ``test_elastic_restore_across_mesh_sizes`` (``tests/test_multidevice.py``).
The JAX package runs its sharded step from one controller under
``make_param_shardings(fsdp=True)``; the port runs one process a rank over
``torch.distributed`` (spawned gloo ranks on the CPU,
``repro_torch.launch.mesh.start_ranks``; no network).  The JAX side
runs here, on one device, on the same numpy init and batches:

* scaled-down DeepSeek-MoE (d_model 64, 4 heads, vocab 128, 2 periods,
  4 experts top-2, 2 shared experts) on a ``(data 2, model 2)`` mesh,
  batch 8 × 16, 3 steps: the losses within rtol 1e-5, every parameter
  within rtol 3e-4 / atol 3e-5 (the JAX suite's tolerances), the first
  step's gradients within 1e-4 of each leaf's largest entry (the
  router's included) and the global norm within 1e-6 relative;
* the same at batch 8 × 96 with capacity factor 0.75, where a data
  rank's own 384 tokens would get a capacity of 256 against the global
  group's 288 and drop other assignments: the port must route over the
  global token groups;
* with int8 gradient compression, and with 2 microbatches;
* every leaf stored as the JAX package cuts it where the layer computes
  whole (:data:`CUT_CASES`: Qwen3 with one KV head, its ``wk`` cut
  mid-head; Jamba, channel-parallel Mamba): losses and first-step
  gradients held as above, 2 steps;
* ``Layout.gather ∘ cut`` bitwise the identity on every leaf of every
  arch, through a checkpoint save and restore;
* Qwen3 scaled down: 3 steps at ``(data 4, model 1)``, a save, a restore
  on ``(data 2, model 1)`` and 2 more steps, against 5 JAX steps; the
  JAX package's ``restore_pytree`` reads the port's save, whose
  ``index.json`` paths are the JAX package's.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import restore_pytree as j_restore
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import ARCHS as JARCHS
from repro.configs import RunConfig as JRun
from repro.data.synthetic import DataConfig, SyntheticDataset
from repro.models import build_model as jax_build
from repro.runtime.train_loop import init_train_state as j_init
from repro.runtime.train_loop import make_loss_fn as j_loss_fn
from repro.runtime.train_loop import make_train_step as j_train_step
from repro_torch.launch.mesh import start_ranks
from repro_torch.models import moe as TMOE

import torch_multirank_ranks as M

torch.set_num_threads(1)

SCALE = dict(d_model=64, n_heads=4, vocab=128, n_periods=2)
BASE = dict(base="deepseek-moe-16b", scale=SCALE, data=(128, 16, 8, 5),
            steps=3)
CASES = {c["name"]: c for c in [
    dict(BASE, name="fsdp-tp-ep"),
    dict(BASE, name="global-groups", data=(128, 96, 8, 7), steps=2,
         capacity_factor=0.75),
    dict(BASE, name="grad-compression", grad_compression=True),
    dict(BASE, name="microbatch-2", microbatch=2),
]}
#: the reference's cut where the layer computes whole: Qwen3 with one KV
#: head (its 16-wide ``wk`` stored cut mid-head at 'model' 2 and
#: gathered before use, its backward taking the rank's part unsummed),
#: and Jamba (one period: channel-parallel Mamba, an MoE, attention of
#: one KV head)
CUT_CASES = {c["name"]: c for c in [
    dict(BASE, name="straddled-heads", base="qwen3-32b",
         scale=dict(SCALE, n_kv_heads=1), steps=2),
    dict(BASE, name="jamba", base="jamba-v0.1-52b",
         scale=dict(SCALE, n_periods=1), steps=2),
]}
ROUNDTRIP_ARCHS = sorted(JARCHS)
ELASTIC = dict(name="elastic", base="qwen3-32b",
               scale=dict(d_model=32, n_heads=4, vocab=64, n_periods=1),
               data=(64, 16, 8, 9), steps=5, remat=False)


def _jax_case(spec):
    arch = JARCHS[spec["base"]].scaled_down(**spec["scale"])
    if "capacity_factor" in spec:
        arch = dataclasses.replace(arch, moe=dataclasses.replace(
            arch.moe, capacity_factor=spec["capacity_factor"]))
    model = jax_build(arch)
    run = JRun(dtype="float32", attention_backend="naive", scan_layers=True,
               remat=spec.get("remat", True),
               microbatch=spec.get("microbatch", 1),
               grad_compression=spec.get("grad_compression", False))
    vocab, seq, batch, seed = spec["data"]
    ds = SyntheticDataset(DataConfig(vocab, seq, batch, seed=seed))
    batches = [ds.batch(i) for i in range(spec["steps"])]
    return model, run, batches


def _paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf) for path, leaf in flat}


def _jax_init(spec):
    """The JAX case: model, run, seeded init state (and its numpy
    params) and batches."""
    model, run, batches = _jax_case(spec)
    state = j_init(model, jax.random.PRNGKey(0), run)
    return dict(model=model, run=run, state=state, batches=batches,
                init=jax.tree_util.tree_map(np.asarray, state.params))


def _jax_reference(case):
    """Losses, grad norms, first-step gradients and params after each
    step of the JAX single-device step."""
    model, run, state, batches = (case[k] for k in ("model", "run", "state",
                                                    "batches"))
    loss_fn = j_loss_fn(model, run)
    grads = jax.grad(lambda p: loss_fn(p, {"tokens": batches[0]})[0])(
        state.params)
    step = jax.jit(j_train_step(model, run))
    losses, norms, params = [], [], []
    for b in batches:
        state, m = step(state, {"tokens": b})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        params.append(_paths(state.params))
    return dict(losses=losses, norms=norms, grads=_paths(grads),
                params=params, state=state)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's ranks (the (2, 2) cases and the first elastic segment
    at once, then the second segment), with the JAX references computed
    while they run."""
    inits = {name: _jax_init(spec)
             for name, spec in {**CASES, **CUT_CASES}.items()}
    ranks = start_ranks(
        M.train_cases, backend="gloo", device="cpu",
        axes={"data": 2, "model": 2},
        args=(list(CASES.values()) + list(CUT_CASES.values()),
              {n: c["init"] for n, c in inits.items()},
              {n: c["batches"] for n, c in inits.items()},
              (ROUNDTRIP_ARCHS, str(tmp_path_factory.mktemp("roundtrip")))),
        store_dir=str(tmp_path_factory.mktemp("train")))
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    einit = _jax_init(ELASTIC)
    seg = start_ranks(M.elastic_segment, backend="gloo", device="cpu",
                      axes={"data": 4, "model": 1},
                      args=(ELASTIC, einit["init"], einit["batches"], ckpt,
                            0, 3),
                      store_dir=str(tmp_path_factory.mktemp("seg1")))
    eref = _jax_reference(einit)
    first = seg.join()
    seg = start_ranks(M.elastic_segment, backend="gloo", device="cpu",
                      axes={"data": 2, "model": 1},
                      args=(ELASTIC, einit["init"], einit["batches"], ckpt,
                            3, 5),
                      store_dir=str(tmp_path_factory.mktemp("seg2")))
    refs = {name: _jax_reference(c) for name, c in inits.items()}
    second = seg.join()
    port = ranks.join()
    return dict(port=port, refs=refs, eref=eref, ckpt=ckpt,
                elastic=(first, second))


def _close(got: dict, want: dict, rtol=3e-4, atol=3e-5, what=""):
    assert sorted(got) == sorted(want), what
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {path}")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_train_step_matches_jax(runs, name):
    got, ref = runs["port"][name], runs["refs"][name]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    _close(got["params"], ref["params"][-1], what=name)


@pytest.mark.parametrize("name", ["fsdp-tp-ep", "global-groups"])
def test_sharded_first_step_gradients_and_norm(runs, name):
    """The whole first-step gradients — the router's too — within 1e-4
    of each leaf's largest entry, and the clip norm within 1e-6."""
    got, ref = runs["port"][name], runs["refs"][name]
    assert sorted(got["grads"]) == sorted(ref["grads"])
    for path, w in ref["grads"].items():
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got["grads"][path], w, rtol=0,
                                   atol=1e-4 * scale, err_msg=path)
    np.testing.assert_allclose(got["loss0"], ref["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(got["norms"][0], ref["norms"][0], rtol=1e-6)
    assert any(p.endswith("ffn/router") for p in got["grads"])


@pytest.mark.parametrize("name", list(CUT_CASES))
def test_reference_cut_losses_and_first_step_gradients(runs, name):
    """Every leaf stored as the JAX package cuts it, the leaves a layer
    computes whole gathered before use: the losses within 1e-5
    relative and the first-step gradients within 1e-4 of each leaf's
    largest entry — a gradient summed over the 'model' ranks' whole
    products would be off by 2× — and the clip norm within 1e-6."""
    got, ref = runs["port"][name], runs["refs"][name]
    np.testing.assert_allclose(got["loss0"], ref["losses"][0], rtol=1e-5)
    assert sorted(got["grads"]) == sorted(ref["grads"])
    bad = {}
    for path, w in ref["grads"].items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got["grads"][path] - w).max()) / scale
        if err > 1e-4:
            bad[path] = err
    assert not bad, bad
    np.testing.assert_allclose(got["norms"][0], ref["norms"][0], rtol=1e-6)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    assert {"tp_gather", "tp_gather.bwd"} & set(got["step_bytes"]) == {
        "tp_gather"}
    if name == "jamba":
        assert {"mamba.in.bwd", "x_proj", "x_proj.bwd",
                "mamba.out"} <= set(got["step_bytes"])


@pytest.mark.parametrize("arch", ROUNDTRIP_ARCHS)
def test_layout_cut_gather_roundtrip_through_a_checkpoint(runs, arch):
    """On every rank of (data 2, model 2): ``Layout.gather ∘ cut`` is the
    whole tree bitwise, a checkpoint of it restores to the same cut,
    every cut leaf has the rule's shape, and a Mamba ``in_proj`` cut
    holds the rank's ``x`` and ``z`` columns."""
    reports = runs["port"]["roundtrip"]
    assert len(reports) == 4
    for rank, report in enumerate(reports):
        assert report[arch] == dict(shapes=True, gathered=True, recut=True,
                                    in_proj=True), (rank, report[arch])


def test_global_groups_case_drops_by_the_global_capacity():
    """The global-groups case is one where a data rank's own tokens
    would group differently: its capacities differ, and the global
    group must drop (its 4 experts take at most 4 · 288 of the 1536
    assignments)."""
    spec = CASES["global-groups"]
    _, seq, batch, _ = spec["data"]
    t_all, t_rank = batch * seq, batch * seq // 2
    cf, k, e = spec["capacity_factor"], 2, 4
    glob, local = (TMOE.capacity(t, e, k, cf) for t in (t_all, t_rank))
    assert (glob, local) == (288, 256)
    assert e * glob < t_all * k


def test_sharded_state_is_cut_over_both_axes(runs):
    """Each rank holds about a quarter of the masters and the moments:
    every leaf is cut over 'data' where its rule has an 'F' slot that
    divides, and over 'model' where its layer computes on a cut."""
    got = runs["port"]["fsdp-tp-ep"]
    whole = sum(v.nbytes for v in got["params"].values())
    for r in got["resident"]:
        assert r["params"] == r["m"] == r["v"]
        assert r["params"] < 0.3 * whole
    assert sum(r["params"] for r in got["resident"]) >= whole
    specs = got["specs"]
    assert specs["periods/0/ffn/w_gate"] == (None, "model", "data", None)
    assert specs["periods/0/ffn/router"] == (None, "data", None)
    assert specs["periods/0/ffn/shared/w_down"] == (None, "model", "data")
    assert specs["embed/table"] == ("model", "data")
    assert {"fsdp", "fsdp.bwd", "moe", "moe.slots"} <= set(
        got["step_bytes"])


def test_elastic_restore_across_mesh_sizes(runs):
    """3 steps on 4 data ranks, a save, a restore on 2 and 2 more steps
    equal 5 single-device JAX steps; the JAX package restores the
    port's save, with its own leaf paths."""
    first, second = runs["elastic"]
    eref = runs["eref"]
    _close(first, eref["params"][2], what="after 3 steps")
    _close(second, eref["params"][4], what="after 5 steps")
    state = eref["state"]
    restored = j_restore(os.path.join(runs["ckpt"], "step_00000005"), state)
    _close(_paths(restored.params), second, rtol=0, atol=0,
           what="JAX restore")
    jdir = os.path.join(runs["ckpt"], "jax")
    JManager(jdir).save(state, step=5)

    def paths(d):
        with open(os.path.join(d, "step_00000005", "index.json")) as f:
            return [e["path"] for e in json.load(f)["leaves"]]
    assert paths(runs["ckpt"]) == paths(jdir)
