"""Dense LUT attention: the CUDA kernel's wrapper and its plain version.

The counterpart of the JAX package's ``kernels/lut_attention/
lut_attention.py`` (``lut_attention_pallas``: ``_rowmax_kernel``,
``_sum_kernel``, then ``_rexp_av_kernel`` / ``_lut2d_av_kernel`` or the
fused ``_fused_sum_av_kernel``).  q (B, H, Lq, D) attends to contiguous
k, v (B, KVH, Lk, D) with the REXP or 2D-LUT softmax; the output is f32.

* :func:`lut_attention_cuda` launches ``csrc/lut_attention.cu`` on CUDA
  tensors: one thread block per (sequence, query head, tile of query
  rows) runs every pass.  A runtime ``kv_len`` (the valid length of a
  pre-allocated cache; the JAX kernel's static ``lk_valid``) masks the
  tail, and causal queries are right-aligned to it.  On CPU tensors it
  runs the plain version — only because the tensors lie on the CPU.
* :func:`lut_attention_plain` is the plain PyTorch version of the same
  function (``ref.lut_attention_ref``): the same integer LUT pipeline,
  the f32 q·k and σ·V sums in another order.

``lut_attention_cuda.launches`` counts the launches per mode:
``"rexp_fused"`` (REXP's α form), ``"rexp"`` (faithful per-element σ)
and ``"lut2d"``.
"""

from __future__ import annotations

import torch

from repro_torch.core.lut_builder import Lut2DTables, RexpTables
from repro_torch.kernels import build
from repro_torch.kernels.common import KERNEL_DTYPES, kernel_tables
from repro_torch.kernels.lut_attention import ref as _ref

Tensor = torch.Tensor

MODES = ("rexp_fused", "rexp", "lut2d")


def mode_of(method: str, fused_requant: bool) -> str:
    """The kernel mode a call takes: fused only for REXP, as in the JAX
    package."""
    if method not in ("rexp", "lut2d"):
        raise ValueError(f"the dense LUT kernel takes 'rexp' or 'lut2d', got "
                         f"{method!r}")
    return "rexp_fused" if method == "rexp" and fused_requant else method


def lut_attention_plain(q: Tensor, k: Tensor, v: Tensor,
                        tables: RexpTables | Lut2DTables, *,
                        method: str = "rexp", causal: bool = False,
                        scale: float | None = None,
                        index_mode: str = "round",
                        fused_requant: bool = False,
                        kv_len: Tensor | int | None = None) -> Tensor:
    """The plain PyTorch version: materialized masked logits + the policy
    softmax (or REXP's fused α form; 2D-LUT ignores ``fused_requant``)."""
    return _ref.lut_attention_ref(q, k, v, method=method, tables=tables,
                                  scale=scale, causal=causal,
                                  index_mode=index_mode,
                                  fused_requant=fused_requant, kv_len=kv_len)


def check_kernel_inputs(q: Tensor, k: Tensor, v: Tensor,
                        kv_len: Tensor | int | None) -> int:
    """Validate what the kernel takes; returns ``kv_len`` as an int (Lk
    when None).  Raises on anything the kernel does not take instead of
    launching on it."""
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the dense LUT kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-D tensor, got "
                             f"shape {tuple(t.shape)}, strides {t.stride()}")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; the "
                             f"kernel takes {q.dtype} on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"the kernel reads {name} 16 bytes at a time: "
                             f"its storage must be 16-byte aligned")
    b, h, lq, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"both be (B={b}, KVH, Lk, Dh={dh})")
    kvh, lk = k.shape[1], k.shape[2]
    if kvh < 1 or h % kvh:
        raise ValueError(f"query heads H={h} must be a multiple of KV heads "
                         f"KVH={kvh}")
    if dh > 256 or dh % 8 or lq < 1 or lk < 1:
        raise ValueError(f"the kernel takes Dh ≤ 256, a multiple of 8, and "
                         f"Lq, Lk ≥ 1; got Dh={dh}, Lq={lq}, Lk={lk}")
    kv = lk if kv_len is None else int(kv_len)
    if not 0 <= kv <= lk:
        raise ValueError(f"kv_len={kv} must lie in [0, Lk={lk}]")
    return kv


def lut_attention_cuda(q: Tensor, k: Tensor, v: Tensor,
                       tables: RexpTables | Lut2DTables, *,
                       method: str = "rexp", causal: bool = False,
                       scale: float | None = None,
                       index_mode: str = "round",
                       fused_requant: bool = False,
                       kv_len: Tensor | int | None = None) -> Tensor:
    """Dense LUT attention; returns (B, H, Lq, D) f32.

    CUDA tensors launch the kernel on the current stream (or raise);
    CPU tensors run :func:`lut_attention_plain`.  ``fused_requant``
    selects REXP's α form (ignored for 2D-LUT, as in the JAX package).
    """
    mode = mode_of(method, fused_requant)
    if not q.is_cuda:
        return _ref.lut_attention_ref(q, k, v, method=method, tables=tables,
                                      scale=scale, causal=causal,
                                      index_mode=index_mode,
                                      fused_requant=fused_requant,
                                      kv_len=kv_len)
    kv = check_kernel_inputs(q, k, v, kv_len)
    b, h, lq, dh = q.shape
    kvh, lk = k.shape[1], k.shape[2]
    main, aux, ints, floats = kernel_tables(method, tables, index_mode,
                                            q.device)
    out = torch.empty((b, h, lq, dh), dtype=torch.float32, device=q.device)
    scale = scale if scale is not None else dh ** -0.5
    err = build.load("lut_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), main.data_ptr(),
        aux.data_ptr(), out.data_ptr(), KERNEL_DTYPES[q.dtype], b, h, kvh,
        lq, lk, dh, kv, int(causal), int(mode == "rexp_fused"), *ints,
        scale, *floats, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lut_attention kernel launch failed: CUDA error "
                           f"{err}")
    lut_attention_cuda.launches[mode] += 1
    return out


lut_attention_cuda.launches = dict.fromkeys(MODES, 0)
