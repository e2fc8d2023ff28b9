"""End-to-end serving driver on the PyTorch port — the paper's deployment
scenario.

  PYTHONPATH=src python examples/serve_lut_softmax_torch.py       # card
  PYTHONPATH=src python examples/serve_lut_softmax_torch.py --device cpu

The counterpart of ``serve_lut_softmax.py``: trains a small LM briefly
(so the weights are meaningful), serves a batch of prompts under the
exact softmax and the LUT softmaxes — free-running and teacher-forced —
and then serves mixed-length requests through the continuous-batching
engine over the paged KV pool.  On the card the attention runs the
port's CUDA kernels (the dense LUT-attention kernel in lockstep, the
paged kernels in the engine); on the CPU their plain versions.  Without
a card it refuses to run unless ``--device cpu`` is given.
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCHS, RunConfig
from repro_torch.core.policies import SoftmaxPolicy
from repro_torch.data.synthetic import DataConfig, SyntheticDataset
from repro_torch.models import build_model
from repro_torch.models.convert import tree_flatten, tree_map
from repro_torch.models.device import resolve_device
from repro_torch.runtime import (EngineConfig, PagedCacheConfig,
                                 ServingEngine)
from repro_torch.runtime.serve_loop import generate
from repro_torch.runtime.train_loop import make_train_step, train_state

ARCH = ARCHS["qwen3-32b"].scaled_down(d_model=128, n_heads=4, vocab=512,
                                      n_periods=2)
STEPS, BATCH, SEQ = 80, 16, 64
TRAIN_RUN = RunConfig(dtype="float32", attention_backend="naive",
                      remat=True, learning_rate=2e-3)
POLICIES = {
    "exact": SoftmaxPolicy(),
    "rexp_uint8": SoftmaxPolicy(impl="rexp", precision="uint8"),
    "lut2d_uint8": SoftmaxPolicy(impl="lut2d", precision="uint8"),
    "rexp_uint2": SoftmaxPolicy(impl="rexp", precision="uint2"),
}
CACHE = PagedCacheConfig(n_pages=96, page_size=8, max_pages_per_seq=8)


def serve_run(policy: SoftmaxPolicy) -> RunConfig:
    """The serving config: f32, the port's attention backend (the card's
    kernels, or the plain versions on the CPU)."""
    return RunConfig(dtype="float32", softmax_policy=policy)


def dataset() -> SyntheticDataset:
    return SyntheticDataset(DataConfig(ARCH.vocab_size, SEQ, BATCH, seed=0))


def train(model, params, device) -> tuple:
    """``STEPS`` AdamW steps from ``params`` (f32 masters, updated in
    place); returns the trained params and ``{step: loss}`` of the
    printed steps and the last."""
    state = train_state(params, TRAIN_RUN)
    step_fn = make_train_step(model, TRAIN_RUN)
    ds = dataset()
    n = sum(x.numel() for _, x in tree_flatten(state.params))
    print(f"training {ARCH.name}-mini ({n:,} params) for {STEPS} steps…")
    losses = {}
    for step in range(STEPS):
        tokens = torch.from_numpy(ds.batch(step)).to(device)
        state, m = step_fn(state, {"tokens": tokens})
        if step % 20 == 0 or step == STEPS - 1:
            losses[step] = float(m["loss"])
        if step % 20 == 0:
            print(f"  step {step:3d} loss {losses[step]:.3f}")
    return tree_map(lambda t, _: t.detach(), state.params), losses


def lockstep(model, params, device) -> tuple:
    """Free-running generation (16 prompts × 24 new tokens) and the
    teacher-forced next-token argmaxes along exact's trajectory, by
    policy."""
    prompts = torch.from_numpy(dataset().batch(9999)[:, :32]).to(device)
    gen = {name: generate(model, params, prompts, serve_run(pol),
                          max_new_tokens=24).cpu().numpy()
           for name, pol in POLICIES.items()}
    traj = torch.cat([prompts, torch.from_numpy(gen["exact"]).to(device)],
                     dim=1)
    tf = {}
    with torch.no_grad():
        for name, pol in POLICIES.items():
            logits, _ = model.prefill(params, traj[:, :-1], serve_run(pol),
                                      max_len=traj.shape[1])
            tf[name] = logits[:, 31:].argmax(-1).cpu().numpy()
    print("\nbatched serving, 16 prompts × 24 new tokens each:")
    print(f"  {'policy':12s} {'teacher-forced step agreement':>30s} "
          f"{'free-running agreement':>24s}")
    agreement = {}
    for name in POLICIES:
        a_tf = float((tf[name] == tf["exact"]).mean())
        a_fr = float((gen[name] == gen["exact"]).mean())
        agreement[name] = (a_tf, a_fr)
        print(f"  {name:12s} {a_tf:>29.1%} {a_fr:>23.1%}")
    print("(paper's claim: 8-bit LUT softmax ≈ exact per step; 2-bit "
          "degrades.  Free-running agreement compounds single flips.)")
    return gen, tf, agreement


def requests() -> list[tuple[list[int], int]]:
    """12 mixed-length requests (prompts 4–32, outputs 4–24), drawn as
    the JAX example draws them (numpy, seed 0)."""
    rng = np.random.default_rng(0)
    return [(rng.integers(0, ARCH.vocab_size, size=int(l)).tolist(), int(m))
            for l, m in zip(rng.integers(4, 33, size=12),
                            rng.integers(4, 25, size=12))]


def engine(model, params, device) -> dict:
    """The requests through the continuous-batching engine (4 slots,
    pages of 8) under the exact and the uint8 REXP softmax: each
    request's tokens by policy, and the agreement."""
    reqs = requests()
    print("\ncontinuous batching, 12 mixed-length requests "
          f"(prompts 4–32, outputs 4–24), {CACHE.max_context}-token "
          "pages×8:")
    outs = {}
    for name in ("exact", "rexp_uint8"):
        eng = ServingEngine(model, params, serve_run(POLICIES[name]),
                            EngineConfig(n_slots=4, cache=CACHE),
                            device=device)
        res = eng.run(reqs)
        outs[name] = [np.asarray(res[i].tokens) for i in range(len(reqs))]
        toks = eng.stats.tokens
        print(f"  {name:12s} {toks} tokens in {eng.stats.wall_s:.2f}s "
              f"({toks / eng.stats.wall_s:.1f} tok/s, {eng.stats.steps} "
              f"decode steps, {eng.stats.preemptions} preemptions)")
    agree = float(np.mean([float((outs["rexp_uint8"][i]
                                  == outs["exact"][i]).mean())
                           for i in range(len(reqs))]))
    print(f"  rexp_uint8 vs exact free-running agreement: {agree:.1%}")
    return {"tokens": outs, "agreement": agree}


def main(device="cuda", params=None) -> dict:
    """Train from ``params`` (f32 weights; None: the port's seeded init),
    then serve the trained weights; returns the losses, the lockstep
    tokens and argmaxes, the agreements and the engine's tokens."""
    device = resolve_device(device)
    model = build_model(ARCH)
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(0),
                            device)
    trained, losses = train(model, params, device)
    gen, tf, agreement = lockstep(model, trained, device)
    served = engine(model, trained, device)
    return {"losses": losses, "generate": gen, "teacher_forced": tf,
            "agreement": agreement, "engine": served}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    main(ap.parse_args().device)
