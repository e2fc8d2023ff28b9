"""The port's checkpoints, fault-tolerant trainer and launchers, and the
on-disk format it shares with the JAX package.

* ``save_pytree`` / ``restore_pytree``: a round trip of f32 and int32
  leaves (bitwise, on the leaves' devices, ``requires_grad`` kept); a
  shape mismatch raises ``ValueError``, a missing leaf ``KeyError``, a
  bf16 leaf ``TypeError`` before anything is written; the manager
  ignores ``.tmp-`` directories, keeps ``keep_n`` steps, and an async
  save writes the values of the step it was called at though the next
  optimizer step overwrites the tensors in place.
* ``ResilientTrainer`` on a scaled-down Granite-MoE, CPU: a failure
  injected at step 5 is recovered from the step-4 checkpoint and the run
  ends bitwise equal to an uninterrupted one; every step past a zero
  deadline counts as a straggler; 3 steps, a checkpoint, a restore and 3
  more equal 6 straight steps bitwise (parameters and moments).
* Across packages, both directions: a JAX ``save_pytree`` of a JAX
  ``TrainState`` (with error feedback) restores into the port's, and
  the port's into the JAX package's, every leaf bitwise; the two
  ``index.json`` path lists (and shapes and dtypes) are equal.
* The launchers: ``repro_torch.launch.train --scale-down 64,4,128
  --layers 1 --steps 6 --ckpt-dir D --device cpu`` writes ``D`` (its
  losses falling), ``repro_torch.launch.serve --ckpt-dir D`` prints
  ``restored step 6`` and serves the restored weights (also at ``--tp
  2 --shard-params``, each rank restoring and cutting: the tokens of
  ``--tp 1``); a JAX-written checkpoint served through both packages'
  launchers, lockstep, exact and REXP uint8, on the same prompts, gives
  the same greedy tokens.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as JCKPT
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import RunConfig as JRun
from repro.launch import serve as JSERVE
from repro.optim import adamw as JADAM
from repro.optim import grad_compress as JGC
from repro.runtime import train_loop as JTL
from repro_torch.checkpoint.ckpt import (checkpoint_meta, checkpoint_step,
                                         restore_pytree, save_pytree)
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import RunConfig as TRun
from repro_torch.data import DataConfig, SyntheticDataset
from repro_torch.launch import serve as TSERVE
from repro_torch.launch import train as TTRAIN
from repro_torch.models.convert import (params_from_jax, tree_flatten,
                                        tree_unflatten)
from repro_torch.optim.adamw import AdamWState
from repro_torch.runtime.fault_tolerance import ResilientTrainer
from repro_torch.runtime import train_loop as TTL
from torch_train_util import jax_paths, pair

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tree_equal(a, b):
    fa, fb = tree_flatten(a), tree_flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype, p
        assert torch.equal(x.detach(), y.detach()), p


# ---------------------------------------------------------------------------
# save / restore / manager
# ---------------------------------------------------------------------------


def test_save_restore_roundtrip(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4)
            .requires_grad_(True),
            "b": {"c": torch.tensor(7, dtype=torch.int32)},
            "l": [torch.ones(2), torch.zeros(1, dtype=torch.int32)]}
    path = save_pytree(str(tmp_path), tree, step=3, meta={"x": 1})
    assert os.path.basename(path) == "step_00000003"
    out = restore_pytree(path, tree)
    tree_equal(tree, out)
    assert out["a"].requires_grad and not out["b"]["c"].requires_grad
    assert checkpoint_step(path) == 3 and checkpoint_meta(path) == {"x": 1}
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    assert [e["path"] for e in index["leaves"]] == ["a", "b/c", "l/0", "l/1"]
    assert [e["dtype"] for e in index["leaves"]] == [
        "float32", "int32", "float32", "int32"]


def test_restore_shape_mismatch_raises(tmp_path):
    path = save_pytree(str(tmp_path), {"a": torch.zeros(3, 4)}, step=0)
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_pytree(path, {"a": torch.zeros(4, 4)})


def test_restore_missing_leaf_raises(tmp_path):
    path = save_pytree(str(tmp_path), {"a": torch.zeros(3)}, step=0)
    with pytest.raises(KeyError, match="missing leaf 'b'"):
        restore_pytree(path, {"a": torch.zeros(3), "b": torch.zeros(2)})


def test_bf16_leaf_refused(tmp_path):
    with pytest.raises(TypeError, match="float32 and int32"):
        save_pytree(str(tmp_path), {"w": torch.zeros(2, dtype=torch.bfloat16)},
                    step=1)
    assert os.listdir(tmp_path) == []
    with pytest.raises(TypeError, match="bfloat16"):
        CheckpointManager(str(tmp_path), async_save=True).save(
            {"w": torch.zeros(2, dtype=torch.bfloat16)}, step=1)


def test_atomicity_tmp_dirs_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(tmp_path / "step_00000009.tmp-dead", exist_ok=True)
    assert mgr.latest_path() is None
    assert mgr.restore_latest({"a": torch.zeros(2)}) is None
    mgr.save({"a": torch.zeros(2)}, step=1)
    assert mgr.all_steps() == [1]


def test_manager_keep_n(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    for s in (1, 2, 3, 4):
        mgr.save({"a": torch.full((2,), float(s))}, step=s)
    assert mgr.all_steps() == [3, 4]
    out, step = mgr.restore_latest({"a": torch.zeros(2)})
    assert step == 4 and torch.equal(out["a"], torch.full((2,), 4.0))


def _setup(name="granite-moe-3b-a800m", **run_kw):
    _, tm, jp = pair(name, seed=0, d_model=32, vocab=64)
    run = TRun(dtype="float32", remat=False, learning_rate=1e-3, **run_kw)
    state = TTL.train_state(params_from_jax(jp, device="cpu"), run)
    step_fn = TTL.make_train_step(tm, run)
    ds = SyntheticDataset(DataConfig(64, 16, 4, seed=7))

    def batches(step):
        return {"tokens": torch.from_numpy(ds.batch(step))}

    return state, step_fn, batches, jp


def restore_like(state):
    """A deep copy of a train state (its tensors cloned)."""
    return tree_unflatten(state, [
        t.detach().clone().requires_grad_(t.requires_grad)
        for _, t in tree_flatten(state)])


def test_async_save_snapshot_survives_inplace_step(tmp_path):
    """The async save copies to the host before returning: the in-place
    optimizer step that follows does not reach the file."""
    state, step_fn, batches, _ = _setup()
    state, _ = step_fn(state, batches(0))
    before = restore_like(state)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(state, step=1)
    state, _ = step_fn(state, batches(1))          # overwrites in place
    mgr.wait()
    assert mgr.all_steps() == [1]
    out, step = mgr.restore_latest(state)
    assert step == 1
    tree_equal(before, out)
    with pytest.raises(AssertionError):
        tree_equal(state.params, out.params)


# ---------------------------------------------------------------------------
# ResilientTrainer
# ---------------------------------------------------------------------------


def _straight(state, step_fn, batches, n):
    for step in range(n):
        state, _ = step_fn(state, batches(step))
    return state


def test_bitexact_resume(tmp_path):
    """6 steps straight == 3 steps, checkpoint, restore, 3 more."""
    state, step_fn, batches, _ = _setup()
    s_a = _straight(restore_like(state), step_fn, batches, 6)
    s_b = _straight(restore_like(state), step_fn, batches, 3)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(s_b, step=3)
    s_c, start = mgr.restore_latest(restore_like(state))
    assert start == 3 and int(s_c.opt.step) == 3
    for step in range(start, 6):
        s_c, _ = step_fn(s_c, batches(step))
    tree_equal(s_a.params, s_c.params)
    tree_equal(s_a.opt.m, s_c.opt.m)
    tree_equal(s_a.opt.v, s_c.opt.v)


def test_resilient_trainer_recovers_from_failure(tmp_path):
    state, step_fn, batches, _ = _setup()
    ref = _straight(restore_like(state), step_fn, batches, 8)
    boom = {"armed": True}

    def failure_hook(step):
        if step == 5 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected node failure")

    trainer = ResilientTrainer(step_fn,
                               CheckpointManager(str(tmp_path), keep_n=2),
                               checkpoint_every=2, max_retries=2)
    final, report = trainer.run(state, batches, n_steps=8,
                                failure_hook=failure_hook)
    assert report.failures_recovered == 1 and report.restored_from is None
    assert report.final_metrics["loss"] > 0
    assert report.steps_run == 8
    tree_equal(ref.params, final.params)
    assert sorted(os.listdir(tmp_path)) == ["step_00000006", "step_00000008"]
    # a second run resumes from the last checkpoint and has nothing to do
    _, again = ResilientTrainer(step_fn, CheckpointManager(str(tmp_path)),
                                checkpoint_every=2).run(
        restore_like(state), batches, n_steps=8)
    assert again.restored_from == 8 and again.steps_run == 0


def test_resilient_trainer_gives_up_after_max_retries(tmp_path):
    state, step_fn, batches, _ = _setup()

    def always(step):
        raise RuntimeError("dead node")

    with pytest.raises(RuntimeError, match="exceeded 2 recoveries"):
        ResilientTrainer(step_fn, CheckpointManager(str(tmp_path)),
                         max_retries=2).run(state, batches, n_steps=3,
                                            failure_hook=always)


def test_straggler_detection(tmp_path):
    state, step_fn, batches, _ = _setup()
    trainer = ResilientTrainer(step_fn, CheckpointManager(str(tmp_path)),
                               checkpoint_every=100,
                               step_deadline_s=0.0)  # everything straggles
    _, report = trainer.run(state, batches, n_steps=3)
    assert report.straggler_events == 3


# ---------------------------------------------------------------------------
# The shared on-disk format
# ---------------------------------------------------------------------------


def _jax_state(jp, run):
    return JTL.TrainState(
        params=jax.tree_util.tree_map(jnp.asarray, jp),
        opt=JADAM.init_adamw(jp),
        ef=JGC.init_error_feedback(jp) if run.grad_compression else None)


def _index(path):
    with open(os.path.join(path, "index.json")) as f:
        return [(e["path"], e["shape"], e["dtype"])
                for e in json.load(f)["leaves"]]


def _trained_pair(tmp_path):
    """A JAX and a port train state of the same scaled-down Qwen3 after
    two JAX steps (moments and error feedback non-zero), each saved by
    its own package."""
    jm, tm, jp = pair("qwen3-32b", seed=2, d_model=32, vocab=64)
    jrun = JRun(dtype="float32", attention_backend="naive",
                grad_compression=True)
    jstate = _jax_state(jp, jrun)
    step = jax.jit(JTL.make_train_step(jm, jrun))
    ds = SyntheticDataset(DataConfig(64, 8, 2, seed=1))
    for i in range(2):
        jstate, _ = step(jstate, {"tokens": jnp.asarray(ds.batch(i))})
    trun = TRun(dtype="float32", grad_compression=True)
    tstate = TTL.train_state(params_from_jax(jp, device="cpu"), trun)
    jpath = JCKPT.save_pytree(str(tmp_path / "jax"), jstate, step=2)
    tpath = save_pytree(str(tmp_path / "torch"), tstate, step=0)
    return jstate, tstate, jpath, tpath, jp


def test_index_paths_equal_across_packages(tmp_path):
    jstate, tstate, jpath, tpath, _ = _trained_pair(tmp_path)
    assert _index(jpath) == _index(tpath)
    paths = [p for p, _, _ in _index(tpath)]
    assert ".params/embed/table" in paths and ".opt/.step" in paths
    assert ".params/periods/0/ffn/w_down" in paths
    assert any(p.startswith(".opt/.m/") for p in paths)
    assert any(p.startswith(".opt/.v/") for p in paths)
    assert any(p.startswith(".ef/") for p in paths)
    assert ("/.opt/.step", [], "int32") not in _index(tpath)
    assert (".opt/.step", [], "int32") in _index(tpath)
    assert [p for p, _ in tree_flatten(tstate)] == paths


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    jstate, tstate, jpath, _, _ = _trained_pair(tmp_path)
    out = restore_pytree(jpath, tstate)
    assert isinstance(out, TTL.TrainState) and isinstance(out.opt, AdamWState)
    assert out.opt.step.dtype == torch.int32 and int(out.opt.step) == 2
    ref = dict(jax_paths(jstate))
    for path, t in tree_flatten(out):
        np.testing.assert_array_equal(t.detach().numpy(), ref[path],
                                      err_msg=path)
        assert t.requires_grad == path.startswith(".params/")


def test_port_checkpoint_restores_into_jax(tmp_path):
    jstate, tstate, _, _, _ = _trained_pair(tmp_path)
    # train the port's state two steps so every leaf differs from init
    _, tm, _ = pair("qwen3-32b", seed=2, d_model=32, vocab=64)
    step = TTL.make_train_step(tm, TRun(dtype="float32",
                                        grad_compression=True))
    ds = SyntheticDataset(DataConfig(64, 8, 2, seed=1))
    for i in range(2):
        tstate, _ = step(tstate, {"tokens": torch.from_numpy(ds.batch(i))})
    path = save_pytree(str(tmp_path / "torch2"), tstate, step=2)
    out = JCKPT.restore_pytree(path, jstate)
    got = dict(jax_paths(out))
    for p, t in tree_flatten(tstate):
        np.testing.assert_array_equal(got[p], t.detach().numpy(), err_msg=p)
        assert got[p].dtype == t.detach().numpy().dtype
    # and the JAX manager finds it
    assert JManager(str(tmp_path / "torch2")).restore_latest(jstate)[1] == 2


# ---------------------------------------------------------------------------
# The launchers
# ---------------------------------------------------------------------------

SCALE = ["--arch", "qwen3-32b", "--scale-down", "64,4,128"]


def _serve(*extra):
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *SCALE,
           "--layers", "1", "--device", "cpu", "--batch", "2",
           "--prompt-len", "12", "--new-tokens", "6", *extra]
    out = subprocess.run(cmd, env=dict(os.environ, PYTHONPATH=os.path.join(
        REPO, "src")), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def _tokens_line(out):
    return [ln for ln in out.splitlines() if ln.startswith("sample token")]


def test_train_launcher_writes_and_serve_restores(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    metrics = str(tmp_path / "m.json")
    TTRAIN.main(SCALE + ["--layers", "1", "--steps", "6", "--ckpt-dir", d,
                         "--device", "cpu", "--batch", "4", "--seq", "16",
                         "--ckpt-every", "4", "--eval-every", "3",
                         "--metrics-out", metrics])
    out = capsys.readouterr().out
    assert "done: TrainerReport(steps_run=6" in out and "eval @ 3" in out
    assert CheckpointManager(d).all_steps() == [4, 6]
    with open(metrics) as f:
        hist = json.load(f)
    assert [h["step"] for h in hist] == list(range(6))
    TSERVE.main(SCALE + ["--layers", "1", "--device", "cpu", "--ckpt-dir", d,
                         "--engine", "lockstep", "--batch", "2",
                         "--prompt-len", "8", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "restored step 6" in out
    # the restored weights are the ones served: tp 1 and tp 2 (each rank
    # restoring the whole tree, --shard-params cutting it) agree, and
    # differ from the random init's tokens
    one = _serve("--ckpt-dir", d)
    two = _serve("--ckpt-dir", d, "--tp", "2", "--dist-backend", "gloo",
                 "--shard-params")
    assert one.count("restored step 6") == two.count("restored step 6") == 1
    assert _tokens_line(one) and _tokens_line(two) == _tokens_line(one)
    assert _tokens_line(_serve()) != _tokens_line(one)


@pytest.mark.parametrize("softmax", ["exact", "rexp"])
def test_jax_checkpoint_through_both_launchers(tmp_path, monkeypatch,
                                               capsys, softmax):
    """A checkpoint the JAX package wrote (after 3 JAX train steps) served
    lockstep by the JAX launcher and by the port's, on the prompts the
    port's launcher draws: the same greedy tokens."""
    jm, _, jp = pair("qwen3-32b", seed=5, vocab=128)
    jrun = JRun(dtype="float32", attention_backend="naive",
                learning_rate=1e-2)
    jstate = _jax_state(jp, jrun)
    step = jax.jit(JTL.make_train_step(jm, jrun))
    ds = SyntheticDataset(DataConfig(128, 16, 4, seed=3))
    for i in range(3):
        jstate, _ = step(jstate, {"tokens": jnp.asarray(ds.batch(i))})
    d = str(tmp_path / "jax_ckpt")
    JManager(d).save(jstate, 3)
    flags = ["--softmax", softmax, "--precision",
             "uint8", "--engine", "lockstep", "--batch", "3",
             "--prompt-len", "10", "--new-tokens", "6", "--seed", "4",
             "--ckpt-dir", d]
    # the port's launcher, its full output captured from serve_loop
    got = {}
    orig = TSERVE.generate
    monkeypatch.setattr(TSERVE, "generate", lambda *a, **k: got.setdefault(
        "out", orig(*a, **k)))
    TSERVE.main(SCALE + ["--layers", "2", "--device", "cpu"] + flags)
    assert "restored step 3" in capsys.readouterr().out
    prompt = np.random.default_rng(4).integers(0, 128, size=(3, 10))
    # the JAX launcher, handed the same prompts at its generate call
    ref = {}
    jorig = JSERVE.generate
    monkeypatch.setattr(JSERVE, "generate", lambda m, p, pr, r, **k: (
        ref.setdefault("prompt_shape", pr.shape),
        ref.setdefault("out", jorig(m, p, jnp.asarray(prompt, jnp.int32), r,
                                    **k)))[1])
    monkeypatch.setattr(sys, "argv", ["serve"] + SCALE + ["--periods", "2"]
                        + flags)
    JSERVE.main()
    assert "restored step 3" in capsys.readouterr().out
    assert ref["prompt_shape"] == (3, 10)
    np.testing.assert_array_equal(got["out"].numpy(), np.asarray(ref["out"]))
