"""Fault-tolerant training loop: checkpoint/restart, failure recovery,
straggler detection.

The JAX package's ``runtime/fault_tolerance.py`` in torch.
``ResilientTrainer`` wraps a train step with:

  * periodic atomic checkpoints (async-capable) of the whole
    ``TrainState``, every ``checkpoint_every`` steps and at the end;
  * restore-and-retry after a failing step (at most ``max_retries``):
    the step-indexed synthetic data makes the resume exact;
  * a per-step wall-clock deadline: steps past ``step_deadline_s`` are
    counted and logged as straggler events;
  * ``failure_hook(step)``, called before each step, for tests to
    inject failures.

Reading the step's metrics with ``float`` is the step's device sync, so
an asynchronous CUDA error of the step surfaces inside it and is
recovered like any other failure.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable

from repro_torch.checkpoint.manager import CheckpointManager

log = logging.getLogger("repro_torch.ft")


@dataclasses.dataclass
class TrainerReport:
    steps_run: int
    failures_recovered: int
    straggler_events: int
    final_metrics: dict
    restored_from: int | None


class ResilientTrainer:
    def __init__(
        self,
        train_step: Callable,            # (state, batch) -> (state, metrics)
        ckpt: CheckpointManager,
        *,
        checkpoint_every: int = 50,
        step_deadline_s: float | None = None,
        max_retries: int = 3,
    ):
        self.train_step = train_step
        self.ckpt = ckpt
        self.checkpoint_every = checkpoint_every
        self.step_deadline_s = step_deadline_s
        self.max_retries = max_retries

    def run(
        self,
        state: Any,
        batches: Callable[[int], dict],   # step → batch (deterministic!)
        n_steps: int,
        *,
        start_step: int = 0,
        failure_hook: Callable[[int], None] | None = None,
        metrics_cb: Callable[[int, dict], None] | None = None,
    ) -> tuple[Any, TrainerReport]:
        """Train from the newest checkpoint (else ``state`` at
        ``start_step``) up to ``n_steps``; returns the final state and
        a :class:`TrainerReport`."""
        restored_from = None
        restored = self.ckpt.restore_latest(state)
        if restored is not None:
            state, start_step = restored
            restored_from = start_step
            log.info("restored checkpoint at step %d", start_step)

        failures = 0
        stragglers = 0
        metrics: dict = {}
        step = start_step
        while step < n_steps:
            try:
                if failure_hook is not None:
                    failure_hook(step)
                t0 = time.monotonic()
                batch = batches(step)
                state, metrics = self.train_step(state, batch)
                # materialize: an asynchronous device error of the step
                # surfaces here, inside the recovery boundary
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.monotonic() - t0
                if (self.step_deadline_s is not None
                        and dt > self.step_deadline_s):
                    stragglers += 1
                    log.warning("straggler: step %d took %.2fs (deadline "
                                "%.2fs)", step, dt, self.step_deadline_s)
                if metrics_cb is not None:
                    metrics_cb(step, metrics)
                step += 1
                if step % self.checkpoint_every == 0 or step == n_steps:
                    self.ckpt.save(state, step, meta={"metrics": metrics})
            except Exception as exc:  # noqa: BLE001 — recovery boundary
                failures += 1
                if failures > self.max_retries:
                    raise RuntimeError(
                        f"exceeded {self.max_retries} recoveries") from exc
                log.warning("step %d failed (%s); restoring latest "
                            "checkpoint", step, exc)
                restored = self.ckpt.restore_latest(state)
                if restored is None:
                    log.warning("no checkpoint yet; restarting from step 0 "
                                "state untouched")
                    step = start_step
                else:
                    state, step = restored
        self.ckpt.wait()
        return state, TrainerReport(
            steps_run=step - start_step,
            failures_recovered=failures,
            straggler_events=stragglers,
            final_metrics=metrics,
            restored_from=restored_from,
        )
