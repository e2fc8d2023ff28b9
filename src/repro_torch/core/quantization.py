"""Int8 quantization: the KV-pool rounding convention and PTQ-D.

The counterpart of the JAX package's ``core/quantization.py``.

* :func:`quantize_rows` / :func:`dequantize_rows` / :func:`fake_quant_rows`
  are the ONE rounding convention of the int8 KV pool: the engine
  quantizes K/V rows with it at scatter time, the paged kernels
  dequantize with it, and the lockstep path fake-quantizes its
  contiguous cache with it, so all three see the same values bit for
  bit.  Everything is f32: ``amax / 127`` and ``x / scale`` are true
  IEEE divisions (not reciprocal multiplies), rounding is half to even
  (``torch.round``), the codes clamp to ±127 and the scale is floored
  at f32-tiny — which makes the codes and scales bitwise those of the
  JAX package on the same f32 input.
* :func:`fake_quant_symmetric`, :func:`fake_quant_affine`,
  :func:`quantize_params_ptqd` and :func:`quantization_error_report`
  emulate the paper's PTQ-D protocol (dynamic post-training int8
  quantization of every linear layer) as fake quantization, over a
  flat ``{path: tensor}`` dict of parameters.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

INT8_QMAX = 127.0
_TINY = torch.finfo(torch.float32).tiny


def fake_quant_symmetric(x: Tensor, qmax: float = INT8_QMAX) -> Tensor:
    """Per-tensor symmetric fake quantization (weight scheme).

    scale = max|x| / qmax;  q = clip(round(x / scale), −qmax, qmax).
    """
    x = x.float()
    scale = torch.clamp(x.abs().amax() / qmax, min=_TINY)
    return torch.clamp(torch.round(x / scale), -qmax, qmax) * scale


def fake_quant_affine(x: Tensor, qmax: float = 255.0) -> Tensor:
    """Per-tensor affine fake quantization (dynamic activation scheme).

    The range is extended to include 0 so zero stays exactly
    representable, and the zero-point is clamped onto the integer grid
    ``[0, qmax]`` so a one-sided tensor does not drift on a round trip.
    """
    x = x.float()
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    lo = torch.minimum(x.amin(), zero)
    hi = torch.maximum(x.amax(), zero)
    scale = torch.clamp((hi - lo) / qmax, min=_TINY)
    zp = torch.clamp(torch.round(-lo / scale), 0.0, qmax)
    q = torch.clamp(torch.round(x / scale) + zp, 0.0, qmax)
    return (q - zp) * scale


def quantize_rows(x: Tensor, qmax: float = INT8_QMAX
                  ) -> tuple[Tensor, Tensor]:
    """Symmetric int8 quantization per row (amax over the LAST axis).

    Returns ``(q, scale)``: ``q`` int8 of ``x.shape``, ``scale`` f32 of
    ``x.shape[:-1]``, floored at f32-tiny so an all-zero row round-trips
    to exact zeros instead of NaN.
    """
    x = x.float()
    scale = torch.clamp(x.abs().amax(dim=-1) / qmax, min=_TINY)
    q = torch.clamp(torch.round(x / scale[..., None]), -qmax, qmax)
    return q.to(torch.int8), scale


def dequantize_rows(q: Tensor, scale: Tensor) -> Tensor:
    """Inverse of :func:`quantize_rows`: ``q · scale`` back to f32 (one
    f32 multiply per element, as the paged kernels do)."""
    return q.float() * scale[..., None]


def fake_quant_rows(x: Tensor, qmax: float = INT8_QMAX) -> Tensor:
    """``dequantize_rows(*quantize_rows(x))`` — the lockstep view of the
    engine's int8 KV pool, numerically identical by construction."""
    return dequantize_rows(*quantize_rows(x, qmax))


def _is_linear_weight(path: str, leaf: Tensor) -> bool:
    """Matmul weights: float leaves with ndim ≥ 2 that are not
    embeddings (torch dynamic quantization targets nn.Linear only)."""
    if leaf.dim() < 2 or not leaf.is_floating_point():
        return False
    path = path.lower()
    return not ("embed" in path or "pos_" in path)


def quantize_params_ptqd(params: dict[str, Tensor]) -> dict[str, Tensor]:
    """PTQ-D weight quantization of a flat ``{path: tensor}`` dict.

    Every linear-layer weight is snapped onto the symmetric int8 grid
    (in its own dtype); biases, norm scales and embeddings stay float.
    """
    return {path: (fake_quant_symmetric(t).to(t.dtype)
                   if _is_linear_weight(path, t) else t)
            for path, t in params.items()}


def quantization_error_report(params: dict[str, Tensor],
                              qparams: dict[str, Tensor]) -> dict:
    """Aggregate weight-quantization error stats over the float leaves of
    ndim ≥ 2 (max |Δ| relative to the leaf's max |w|)."""
    errs = []
    for path, a in params.items():
        b = qparams[path]
        if a.dim() >= 2 and a.is_floating_point():
            d = (a.float() - b.float()).abs()
            denom = torch.clamp(a.abs().amax().float(), min=1e-9)
            errs.append(float(d.amax() / denom))
    return {
        "n_quantized_tensors": len(errs),
        "max_rel_err": max(errs) if errs else 0.0,
        "mean_rel_err": sum(errs) / len(errs) if errs else 0.0,
    }
