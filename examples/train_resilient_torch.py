"""Fault-tolerant training walkthrough on the PyTorch port: deterministic
data + atomic checkpoints + failure injection + bit-exact resume.

  PYTHONPATH=src python examples/train_resilient_torch.py         # card
  PYTHONPATH=src python examples/train_resilient_torch.py --device cpu

The counterpart of ``train_resilient.py``: a small MoE decoder trains
20 steps under ``ResilientTrainer``, a checkpoint every 5; a failure
injected at step 12 rolls back to step 10's checkpoint and the run goes
on to step 20.  Without a card it refuses to run unless ``--device cpu``
is given.
"""

import argparse
import tempfile

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, RunConfig
from repro_torch.data.synthetic import DataConfig, SyntheticDataset
from repro_torch.models import build_model
from repro_torch.models.device import resolve_device
from repro_torch.runtime.fault_tolerance import ResilientTrainer
from repro_torch.runtime.train_loop import make_train_step, train_state

ARCH = ARCHS["granite-moe-3b-a800m"].scaled_down(d_model=64, n_heads=4,
                                                 vocab=256, n_periods=2)
RUN = RunConfig(dtype="float32", attention_backend="naive",
                learning_rate=2e-3)
FAIL_AT, N_STEPS = 12, 20


def train(model, params, device, ckpt_dir: str) -> tuple:
    """``N_STEPS`` steps from ``params`` with a failure injected at step
    ``FAIL_AT``; returns the trainer's report and ``{step: loss}`` of the
    printed steps."""
    state = train_state(params, RUN)
    ds = SyntheticDataset(DataConfig(256, 32, 8, seed=0))
    boom = {"armed": True}
    losses = {}

    def failure_hook(step):
        if step == FAIL_AT and boom["armed"]:
            boom["armed"] = False
            print(f"  !! injected node failure at step {FAIL_AT}")
            raise RuntimeError("simulated preemption")

    def metrics_cb(step, m):
        if step % 5 == 0:
            losses[step] = m["loss"]
            print(f"  step {step:2d} loss {m['loss']:.3f}")

    trainer = ResilientTrainer(make_train_step(model, RUN),
                               CheckpointManager(ckpt_dir, keep_n=2),
                               checkpoint_every=5, step_deadline_s=30.0)
    _, report = trainer.run(
        state, lambda s: {"tokens": torch.from_numpy(ds.batch(s)).to(device)},
        n_steps=N_STEPS, failure_hook=failure_hook, metrics_cb=metrics_cb)
    print(f"\nreport: {report.steps_run} steps, "
          f"{report.failures_recovered} failure(s) recovered, "
          f"{report.straggler_events} straggler events")
    print("the deterministic (seed, step)->batch pipeline makes the "
          "recovered run bit-identical to an uninterrupted one "
          "(tests/test_torch_checkpoint.py proves it).")
    return report, losses


def main(device="cuda", params=None) -> dict:
    """Run the walkthrough on ``device`` from ``params`` (f32 weights;
    None: the port's seeded init); returns the report's figures and the
    printed losses."""
    device = resolve_device(device)
    model = build_model(ARCH)
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(0),
                            device)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        report, losses = train(model, params, device, ckpt_dir)
    return {"steps_run": report.steps_run,
            "failures_recovered": report.failures_recovered,
            "straggler_events": report.straggler_events,
            "final_metrics": report.final_metrics, "losses": losses}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    main(ap.parse_args().device)
