"""LUT calibration walkthrough on the PyTorch port — the paper's §5.3 /
Fig. 4 procedure.

  PYTHONPATH=src python examples/calibrate_luts_torch.py          # card
  PYTHONPATH=src python examples/calibrate_luts_torch.py --device cpu

The counterpart of ``calibrate_luts.py``: collects Σe^x statistics from
a model's attention logits (``core.SumCollector`` through
``Model.train_logits``), sizes LUT_α from their tail, and shows the
accuracy of the default (NLP, 1×16) table and the calibrated one on flat
worst-case rows.  Without a card it refuses to run unless ``--device
cpu`` is given.
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCHS, RunConfig
from repro_torch.core import (SumCollector, build_rexp_tables,
                              softmax_exact, softmax_rexp)
from repro_torch.models import build_model
from repro_torch.models.device import resolve_device

ARCH = ARCHS["internlm2-20b"].scaled_down(d_model=128, n_heads=4, vocab=512,
                                          n_periods=2)
RUN = RunConfig(dtype="float32", attention_backend="naive")


def draw_batches(device, n: int = 4) -> list[torch.Tensor]:
    """``n`` batches of (4, 64) token ids, seeded (torch's stream: not
    the JAX example's numbers)."""
    g = torch.Generator().manual_seed(0)
    return [torch.randint(0, ARCH.vocab_size, (4, 64), generator=g).to(device)
            for _ in range(n)]


def collect(model, params, batches) -> tuple:
    """Σe^x of every attention row the training forward computes; prints
    the statistics and the recommended LUT_α length."""
    collector = SumCollector()
    with torch.no_grad():
        for tokens in batches:
            model.train_logits(params, tokens, RUN, collector=collector)
    res = collector.result()
    print(f"Σe^x over {res.count} attention rows: mean={res.mean:.1f} "
          f"p99={res.p99:.1f} max={res.max:.1f}")
    alpha_len = res.recommend_alpha_len()
    print(f"recommended LUT_alpha length: {alpha_len} "
          f"(paper NLP default is 16; DETR needed 256–512)")
    return res, alpha_len


def worst_rows(device) -> list[tuple]:
    """Flat logits (numpy, seed 0, as the JAX example draws them) whose
    Σe^x exceeds the default table: the TV distance and the share of
    collapsed rows under the default and the calibrated table."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 0.3, (64, 128)).astype(np.float32)
                         ).to(device)
    exact = softmax_exact(x)
    out = []
    for name, t in (("default(1x16)", build_rexp_tables("uint8")),
                    ("calibrated", build_rexp_tables("uint8", 192))):
        y = softmax_rexp(x, t)
        tv = float(torch.mean(torch.sum(torch.abs(y - exact), -1)) / 2)
        zeros = float(torch.mean((torch.sum(y, -1) == 0).float()))
        print(f"  {name:14s} TV distance {tv:.3f}, collapsed rows "
              f"{zeros:5.1%}  (bytes: {t.nbytes})")
        out.append((name, round(tv, 3), round(zeros, 3), t.nbytes))
    print("— the Fig. 4 lesson: size LUT_alpha from the observed Σe^x tail.")
    return out


def main(device="cuda", params=None) -> dict:
    """Run the walkthrough on ``device``; ``params`` the model's weights
    (a tree of tensors on ``device``), None the port's seeded init.
    Returns the statistics, the recommended length and the worst-row
    figures."""
    device = resolve_device(device)
    model = build_model(ARCH)
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(0),
                            device)
    res, alpha_len = collect(model, params, draw_batches(device))
    return {"count": res.count, "mean": res.mean, "p99": res.p99,
            "max": res.max, "alpha_len": alpha_len,
            "worst_rows": worst_rows(device)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    main(ap.parse_args().device)
