"""Training launcher.

Trains a model of the zoo end to end on the port's substrate: seeded
f32 master weights, the synthetic Markov stream (``data/synthetic.py``,
the JAX package's batches byte for byte), the train step
(``runtime/train_loop.py``: AdamW with a linear warm-up and cosine
decay, optional microbatches and int8 gradient compression), periodic
evals, and — with ``--ckpt-dir`` — the fault-tolerant trainer
(``runtime/fault_tolerance.py``) writing checkpoints in the JAX
package's format, which ``launch/serve.py --ckpt-dir`` (of either
package) serves.

The flags are the JAX launcher's, but depth is ``--layers`` (periods of
the arch's layer pattern, as in the port's serve launcher) and
``--device cuda|cpu`` (default ``cuda``: the card; ``cpu`` runs the
plain PyTorch versions) picks the device.  The run uses
``attention_backend="auto"``; its evals run under the run's softmax
policy, exact as in the JAX launcher — exact-against-LUT evals are
``make_eval_step`` with a ``RunConfig`` of each policy.  An
encoder-decoder's frames are drawn from a ``torch.Generator`` seeded by
the step (the JAX launcher draws them from ``jax.random``, so the two
streams differ).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-32b \\
      --scale-down 64,4,128 --layers 1 --steps 6 --ckpt-dir /tmp/ckpt \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-32b \\
      --scale-down 256,8,512 --steps 300 --batch 16 --seq 256 \\
      --ckpt-dir /tmp/ckpt --eval-every 50
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, RunConfig
from repro_torch.data.synthetic import DataConfig, SyntheticDataset
from repro_torch.launch.serve import arch_from_args
from repro_torch.models import build_model
from repro_torch.models.convert import tree_flatten
from repro_torch.models.device import resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedules import linear_warmup_cosine
from repro_torch.runtime.fault_tolerance import ResilientTrainer
from repro_torch.runtime.train_loop import (init_train_state, make_eval_step,
                                            make_train_step)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--scale-down", default=None,
                    help="d_model,n_heads,vocab — reduced same-family config")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many periods of the arch's "
                         "layer pattern (default 2 with --scale-down)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = arch_from_args(args)
    model = build_model(arch)
    run = RunConfig(dtype=args.dtype, attention_backend="auto", remat=True,
                    microbatch=args.microbatch, learning_rate=args.lr,
                    grad_compression=args.grad_compression)
    opt_cfg = AdamWConfig(
        learning_rate=linear_warmup_cosine(args.lr, args.steps // 10,
                                           args.steps),
        grad_clip=run.grad_clip, weight_decay=run.weight_decay)
    state = init_train_state(
        model, torch.Generator(device=device).manual_seed(args.seed), run,
        device)
    n_params = sum(p.numel() for _, p in tree_flatten(state.params))
    print(f"arch={arch.name} params={n_params:,} device={device}")

    step_fn = make_train_step(model, run, opt_cfg)
    eval_fn = make_eval_step(model, run)
    ds = SyntheticDataset(DataConfig(vocab_size=arch.vocab_size,
                                     seq_len=args.seq,
                                     global_batch=args.batch,
                                     seed=args.seed))
    enc_shape = ((args.batch, arch.encoder_seq, arch.d_model)
                 if arch.encoder_layers else None)

    def batches(step: int) -> dict:
        b = {"tokens": torch.from_numpy(ds.batch(step)).to(device)}
        if enc_shape:
            gen = torch.Generator(device=device).manual_seed(step)
            b["encoder_input"] = torch.randn(enc_shape, generator=gen,
                                             device=device)
        return b

    history: list[dict] = []
    t0 = time.time()
    state_holder = [state]

    def metrics_cb(step: int, m: dict) -> None:
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {m['loss']:.4f} "
                  f"gnorm {m.get('grad_norm', 0):.2f} "
                  f"({(time.time() - t0):.0f}s)")
        if args.eval_every and step and step % args.eval_every == 0:
            em = eval_fn(state_holder[0].params, batches(10_000 + step))
            em = {k: float(v) for k, v in em.items()}
            print(f"  eval @ {step}: {em}")
            history.append({"step": step, **m, **em})
        else:
            history.append({"step": step, **m})

    if args.ckpt_dir:
        trainer = ResilientTrainer(
            lambda s, b: _track(step_fn, state_holder, s, b),
            CheckpointManager(args.ckpt_dir, keep_n=2),
            checkpoint_every=args.ckpt_every)
        state, report = trainer.run(state, batches, args.steps,
                                    metrics_cb=metrics_cb)
        print(f"done: {report}")
    else:
        for step in range(args.steps):
            state, m = step_fn(state, batches(step))
            state_holder[0] = state
            metrics_cb(step, {k: float(v) for k, v in m.items()})

    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f, indent=1)


def _track(step_fn, holder, state, batch):
    out = step_fn(state, batch)
    holder[0] = out[0]
    return out


if __name__ == "__main__":
    main()
