"""Quickstart on the PyTorch port: the paper's two LUT softmax methods.

  PYTHONPATH=src python examples/quickstart_torch.py               # card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The counterpart of ``quickstart.py``, step for step and figure for
figure: the tables, the two softmax approximations against the exact
one, and attention under a ``SoftmaxPolicy`` — on the card the dense
LUT-attention kernel, on the CPU its plain version.  Without a card it
refuses to run unless ``--device cpu`` is given.
"""

import argparse

import numpy as np
import torch

from repro_torch.core import (build_lut2d_tables, build_rexp_tables,
                              softmax_exact, softmax_lut2d, softmax_rexp)
from repro_torch.core.policies import SoftmaxPolicy
from repro_torch.kernels.lut_attention.ops import lut_attention
from repro_torch.models.device import resolve_device


def draw_inputs() -> dict:
    """The example's inputs, drawn as ``quickstart.py`` draws them
    (numpy, seed 0): logits (4, 16) and q, k, v (1, 2, 32, 16)."""
    rng = np.random.default_rng(0)
    out = {"logits": rng.normal(0, 2, (4, 16)).astype(np.float32)}
    for name in ("q", "k", "v"):
        out[name] = rng.normal(0, 1, (1, 2, 32, 16)).astype(np.float32)
    return out


def tables() -> tuple:
    """1. The paper's uint8 tables (Eq. 4/7/8, Table 8 defaults)."""
    rexp8 = build_rexp_tables("uint8")
    lut2d8 = build_lut2d_tables("uint8")
    print(f"REXP uint8 tables: LUT_1/e {rexp8.lut_recip_exp.tolist()} "
          f"+ LUT_alpha[{rexp8.lut_alpha.size}] = {rexp8.nbytes} bytes")
    print(f"2D-LUT uint8 tables: {lut2d8.nbytes} bytes "
          f"(sigma {lut2d8.lut_sigma.shape})")
    return rexp8, lut2d8


def approximate(logits: torch.Tensor, rexp8, lut2d8) -> dict:
    """2. Each softmax approximation against the exact one: max|err| and
    the row sums, by method."""
    exact = softmax_exact(logits)
    out = {}
    for name, approx in (("rexp", softmax_rexp(logits, rexp8)),
                         ("lut2d", softmax_lut2d(logits, lut2d8))):
        err = float(torch.max(torch.abs(approx - exact)))
        sums = np.round(approx.sum(-1).cpu().numpy(), 3)
        print(f"{name:6s} max|err| = {err:.4f}  row sums ≈ {sums}")
        out[name] = (err, sums)
    return out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> float:
    """3. Causal attention under the exact and the uint8 REXP policy: the
    largest difference of their outputs."""
    out_exact = lut_attention(q, k, v, SoftmaxPolicy(), causal=True)
    out_lut = lut_attention(q, k, v,
                            SoftmaxPolicy(impl="rexp", precision="uint8"),
                            causal=True)
    delta = float(torch.max(torch.abs(out_exact - out_lut)))
    print(f"attention output delta (uint8 REXP vs exact): {delta:.4f}")
    return delta


def main(device="cuda", params=None) -> dict:
    """Run the three steps on ``device`` and return what they printed,
    rounded as printed.  ``params``: the inputs (:func:`draw_inputs`'
    keys, numpy arrays); None draws them."""
    device = resolve_device(device)
    inputs = params if params is not None else draw_inputs()
    t = {k: torch.from_numpy(np.asarray(x)).to(device)
         for k, x in inputs.items()}
    rexp8, lut2d8 = tables()
    approx = approximate(t["logits"], rexp8, lut2d8)
    delta = attention(t["q"], t["k"], t["v"])
    return {"tables": (rexp8.nbytes, lut2d8.nbytes),
            **{f"{m}_err": round(e, 4) for m, (e, _) in approx.items()},
            **{f"{m}_sums": s.tolist() for m, (_, s) in approx.items()},
            "attention_delta": round(delta, 4)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    main(ap.parse_args().device)
