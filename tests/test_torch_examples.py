"""The port's examples (``examples/*_torch.py``) against the JAX package's.

Each JAX example runs once, unedited, through ``runpy.run_path`` in a
module fixture (its globals and its printed output captured); its torch
counterpart runs on the CPU, given the JAX example's weights converted
by ``convert.params_from_jax`` where the example has weights:

* quickstart: the printed output equal, line for line;
* calibration: the Σe^x statistics of the JAX example's model and
  token batches within 1e-5 relative (the count equal), the same
  recommended LUT_α length, and the worst-row lines equal;
* serving: trained from the JAX example's init, the losses within 1e-3
  relative of its printed ones (printed to 3 decimals) and of its last
  step's; given its *trained* weights, the ``generate`` tokens and the
  teacher-forced argmaxes equal under every policy, and the engine's
  tokens equal for every request;
* the resilient trainer: the same report (steps, recoveries,
  stragglers), the final metrics within 1e-4 relative and the printed
  losses within 1e-4 relative of the values they round.

Each counterpart also refuses to run without a card unless given
``device="cpu"``.
"""

import contextlib
import importlib.util
import io
import os
import re
import runpy

import jax
import numpy as np
import pytest
import torch

from repro.models import build_model as jax_build
from repro.runtime.train_loop import init_train_state as j_init
from repro_torch.models.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
NAMES = ("quickstart", "calibrate_luts", "serve_lut_softmax",
         "train_resilient")

torch.set_num_threads(2)


def _capture(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def _port(name: str):
    """The torch counterpart, imported as a module."""
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", os.path.join(EXAMPLES, f"{name}_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_runs():
    """Each JAX example's globals and printed output, by name."""
    return {name: _capture(lambda n=name: runpy.run_path(
        os.path.join(EXAMPLES, f"{n}.py"))) for name in NAMES}


def _losses(text: str) -> dict[int, float]:
    return {int(s): float(v) for s, v in
            re.findall(r"step\s+(\d+) loss (\d+\.\d+)", text)}


def _jax_init(g) -> dict:
    """The JAX example's initial weights (its ``init_train_state`` at
    key 0 under its run), as numpy."""
    state = j_init(jax_build(g["ARCH"]), jax.random.PRNGKey(0),
                   g.get("train_run", g["run"]))
    return jax.tree_util.tree_map(np.asarray, state.params)


def test_quickstart_prints_the_jax_examples_figures(jax_runs):
    _, want = jax_runs["quickstart"]
    got, text = _capture(lambda: _port("quickstart").main(device="cpu"))
    assert text == want
    assert got["attention_delta"] > 0


def test_calibration_matches_the_jax_example(jax_runs):
    g, want = jax_runs["calibrate_luts"]
    mod = _port("calibrate_luts")
    model = mod.build_model(mod.ARCH)
    params = params_from_jax(g["params"], device="cpu")
    batches = [torch.tensor(np.asarray(jax.random.randint(
        jax.random.PRNGKey(seed), (4, 64), 0, mod.ARCH.vocab_size)))
        for seed in range(4)]
    (res, alpha_len), _ = _capture(lambda: mod.collect(model, params,
                                                       batches))
    ref = g["res"]
    assert res.count == ref.count
    for k in ("mean", "p50", "p99", "p999", "max"):
        np.testing.assert_allclose(getattr(res, k), getattr(ref, k),
                                   rtol=1e-5, err_msg=k)
    assert alpha_len == g["alpha_len"]
    _, text = _capture(lambda: mod.worst_rows("cpu"))
    rows = [line for line in text.splitlines() if "TV distance" in line]
    assert len(rows) == 2
    assert rows == [line for line in want.splitlines()
                    if "TV distance" in line]


@pytest.fixture(scope="module")
def serving(jax_runs):
    """The serving example's port: trained from the JAX init, then
    serving the JAX example's trained weights."""
    g, text = jax_runs["serve_lut_softmax"]
    mod = _port("serve_lut_softmax")
    model = mod.build_model(mod.ARCH)
    (_, losses), _ = _capture(lambda: mod.train(
        model, params_from_jax(_jax_init(g), device="cpu"), "cpu"))
    trained = params_from_jax(jax.tree_util.tree_map(
        np.asarray, g["state"].params), device="cpu")
    (gen, tf, _), _ = _capture(lambda: mod.lockstep(model, trained, "cpu"))
    served, _ = _capture(lambda: mod.engine(model, trained, "cpu"))
    return dict(g=g, text=text, losses=losses, gen=gen, tf=tf,
                served=served)


def test_serving_example_trains_as_the_jax_one(serving):
    printed = _losses(serving["text"])
    assert sorted(printed) == [0, 20, 40, 60]
    for step, want in printed.items():
        np.testing.assert_allclose(serving["losses"][step], want, rtol=1e-3,
                                   err_msg=f"step {step}")
    np.testing.assert_allclose(serving["losses"][79],
                               float(serving["g"]["m"]["loss"]), rtol=1e-3)


def test_serving_example_serves_the_jax_tokens(serving):
    g = serving["g"]
    assert sorted(serving["gen"]) == sorted(g["gen"])
    for name, want in g["gen"].items():
        np.testing.assert_array_equal(serving["gen"][name], want,
                                      err_msg=f"generate {name}")
        np.testing.assert_array_equal(serving["tf"][name], g["tf"][name],
                                      err_msg=f"teacher-forced {name}")
    for name, outs in g["outs"].items():
        got = serving["served"]["tokens"][name]
        assert len(got) == len(outs) == 12
        for i in range(12):
            np.testing.assert_array_equal(got[i], np.asarray(outs[i].tokens),
                                          err_msg=f"engine {name} {i}")


def test_resilient_trainer_matches_the_jax_example(jax_runs, tmp_path):
    g, text = jax_runs["train_resilient"]
    mod = _port("train_resilient")
    model = mod.build_model(mod.ARCH)
    (report, losses), out = _capture(lambda: mod.train(
        model, params_from_jax(_jax_init(g), device="cpu"), "cpu",
        str(tmp_path)))
    ref = g["report"]
    assert (report.steps_run, report.failures_recovered,
            report.straggler_events) == (ref.steps_run,
                                         ref.failures_recovered,
                                         ref.straggler_events) == (20, 1, 0)
    for k, v in ref.final_metrics.items():
        np.testing.assert_allclose(report.final_metrics[k], float(v),
                                   rtol=1e-4, err_msg=k)
    printed = _losses(text)
    assert sorted(losses) == sorted(printed) == [0, 5, 10, 15]
    for step, want in printed.items():
        assert abs(losses[step] - want) <= 5e-4 + 1e-4 * abs(want), step
    assert "injected node failure at step 12" in out


@pytest.mark.parametrize("name", NAMES)
def test_examples_refuse_to_run_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _port(name).main()
