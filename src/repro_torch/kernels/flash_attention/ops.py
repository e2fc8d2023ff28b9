"""Public exact-attention API.

``flash_attention`` dispatches, as the JAX package's
``kernels/flash_attention/ops.py`` does, between the flash kernel and the
plain paths it shares with the LUT attention ops (policy = exact):

    ``backend``   CUDA tensors                 CPU tensors
    ``auto``      the CUDA flash kernel        its plain version
    ``cuda``      the CUDA flash kernel        raises
    ``naive``     ``lut_attention(EXACT, backend="naive")`` on either
    ``blocked``   ``lut_attention(EXACT, backend="blocked")`` on either

``cuda`` is the JAX package's ``pallas``.  A ``kv_len`` (the valid
length of a pre-allocated cache) goes to the kernel as a runtime
argument on ``auto`` and ``cuda``, and on CPU tensors ``auto`` takes it
to the plain version: both compute what the JAX package's default
``naive`` backend does with it (JAX's ``pallas`` takes none).  Nothing
falls back: on CUDA tensors ``auto`` and ``cuda`` launch the kernel or
raise.
"""

from __future__ import annotations

import torch

from repro_torch.core.policies import EXACT
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda)
from repro_torch.kernels.lut_attention.ops import lut_attention

Tensor = torch.Tensor

BACKENDS = ("auto", "cuda", "naive", "blocked")


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = False,
                    scale: float | None = None, backend: str = "auto",
                    kv_len: Tensor | int | None = None, q_chunk: int = 512,
                    k_chunk: int = 1024) -> Tensor:
    """Exact attention, (B, H, Lq, D) f32; see the module docstring."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown flash_attention backend {backend!r}: "
                         f"expected one of {BACKENDS} (the port's 'cuda' is "
                         f"the JAX package's 'pallas')")
    if backend == "cuda" and not q.is_cuda:
        raise ValueError(f"flash_attention backend 'cuda' needs CUDA "
                         f"tensors, got {q.device}; use 'auto', 'naive' or "
                         f"'blocked' on the CPU")
    if backend in ("auto", "cuda"):
        return flash_attention_cuda(q, k, v, causal=causal, scale=scale,
                                    kv_len=kv_len)[0]
    return lut_attention(q, k, v, EXACT, causal=causal, scale=scale,
                         kv_len=kv_len, backend=backend, q_chunk=q_chunk,
                         k_chunk=k_chunk)
