"""Exact flash attention: the CUDA kernel's wrapper and its plain version.

The counterpart of the JAX package's ``kernels/flash_attention/
flash_attention.py`` (``flash_attention_pallas``, body
``_flash_kernel``): exact softmax attention with GQA and right-aligned
causal masking; q (B, H, Lq, D), k / v (B, KVH, Lk, D) of one float
type; returns ``(out, m, l)`` — out (B, H, Lq, D), the row max m and
the sum l = Σ exp(s − m) (B, H, Lq), all f32.  An optional ``kv_len``
(an int, or a tensor of one or of B lengths) marks the valid keys of a
pre-allocated cache and right-aligns the causal queries to it, as the
JAX package's ``naive`` backend does (its ``pallas`` backend takes
none).

* :func:`flash_attention_cuda` launches ``csrc/flash_attention.cu`` on
  CUDA tensors (one block per (sequence, head, 64 query rows), the keys
  in tiles with the online recurrence; the kernel picks its own tiling,
  so there is no ``block_q`` / ``block_k``) or raises; on CPU tensors it
  runs the plain version — only because the tensors lie on the CPU.
  :func:`flash_route` names its route before the launch: ``"tiles"``
  (tensor cores, p·V as three 16-bit pieces of p) for bf16 and f16 with
  D ≤ 128, a multiple of 8; ``"simt"`` (IEEE f32 on the CUDA cores) for
  f32 and the other head dims.
* :func:`flash_attention_plain` is the plain PyTorch version
  (``ref.flash_attention_stats``): materialized logits, one softmax.

The JAX package defines no backward for this kernel, and neither does
the port.  ``flash_attention_cuda.launches`` counts the launches by
route.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import FLOAT_DTYPES, shapes_only
from repro_torch.kernels.flash_attention import ref as _ref

Tensor = torch.Tensor

#: the kernel's routes, in the order of its C entry point's ``route``
ROUTES = ("simt", "tiles")
TILE_DTYPES = (torch.bfloat16, torch.float16)
TILE_MAX_D = 128


def flash_route(dtype: torch.dtype, d: int) -> str:
    """The route a call takes: ``"tiles"`` for 16-bit inputs with
    D ≤ 128 (a multiple of 8), ``"simt"`` for f32 and every other D."""
    if dtype in TILE_DTYPES and d <= TILE_MAX_D and d % 8 == 0:
        return "tiles"
    return "simt"


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, *,
                          causal: bool = False,
                          scale: float | None = None,
                          kv_len: Tensor | int | None = None):
    """The plain PyTorch version: ``(out, m, l)``, all f32."""
    return _ref.flash_attention_stats(q, k, v, causal=causal, scale=scale,
                                      kv_len=kv_len)


def check_kernel_inputs(q: Tensor, k: Tensor, v: Tensor) -> None:
    """Raise on anything the kernel does not take instead of launching."""
    if q.dtype not in FLOAT_DTYPES:
        raise TypeError(f"the flash-attention kernel takes float32, bfloat16 "
                        f"or float16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; the "
                             f"kernel takes {q.dtype} on {q.device}")
    b, h, lq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"both be (B={b}, KVH, Lk, D={d})")
    kvh, lk = k.shape[1], k.shape[2]
    if kvh < 1 or h % kvh:
        raise ValueError(f"query heads H={h} must be a multiple of KV heads "
                         f"KVH={kvh}")
    if not (1 <= d <= 256 and lq >= 1 and lk >= 1 and b >= 1):
        raise ValueError(f"the kernel takes 1 ≤ D ≤ 256 and B, Lq, Lk ≥ 1; "
                         f"got D={d}, B={b}, Lq={lq}, Lk={lk}")


def _kv_len_args(kv_len: Tensor | int | None, b: int, lk: int,
                 device: torch.device):
    """The kernel's ``(kv_len, kv_lens pointer)`` pair and the tensor
    that owns the pointer: an int goes by value (no device work), a
    tensor as B int32 lengths on the device (one length is expanded)."""
    if kv_len is None:
        return lk, 0, None
    if not isinstance(kv_len, Tensor):
        return int(kv_len), 0, None
    if kv_len.numel() not in (1, b):
        raise ValueError(f"kv_len must hold one length or B={b}, got shape "
                         f"{tuple(kv_len.shape)}")
    lens = kv_len.to(device=device, dtype=torch.int32).reshape(-1)
    lens = lens.expand(b).contiguous()
    return 0, lens.data_ptr(), lens


def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor, *,
                         causal: bool = False, scale: float | None = None,
                         route: str | None = None,
                         kv_len: Tensor | int | None = None):
    """Exact flash attention; returns ``(out, m, l)``, all f32.

    CUDA tensors launch the kernel on the current stream through
    ``route`` (default: :func:`flash_route`'s choice), or raise; CPU
    tensors run :func:`flash_attention_plain`.  A forced ``route`` (tests
    and ``chip_smoke.py`` time both on the same inputs; no model path
    passes one) that the inputs do not suit raises.  ``kv_len`` masks
    keys at or past it (see the module docstring).
    """
    d = q.shape[-1]
    if route is None:
        route = flash_route(q.dtype, d)
    elif route not in ROUTES:
        raise ValueError(f"unknown flash route {route!r}: expected one of "
                         f"{ROUTES}")
    elif route == "tiles" and flash_route(q.dtype, d) != "tiles":
        raise ValueError(f"the tile route takes bfloat16 or float16 with "
                         f"D ≤ {TILE_MAX_D}, a multiple of 8; got "
                         f"{q.dtype}, D={d}")
    if shapes_only(q):
        f32 = dict(dtype=torch.float32, device=q.device)
        return (torch.empty(q.shape, **f32), torch.empty(q.shape[:3], **f32),
                torch.empty(q.shape[:3], **f32))
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     kv_len=kv_len)
    check_kernel_inputs(q, k, v)
    q, k, v = (t.contiguous() for t in (q, k, v))
    # the tile route copies 16 bytes at a time: a view whose storage
    # starts off a 16-byte boundary is copied to one that does not
    q, k, v = (t.clone() if t.data_ptr() % 16 else t for t in (q, k, v))
    b, h, lq, d = q.shape
    kvh, lk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, h, lq, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    l = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    n_valid, lens_ptr, _lens = _kv_len_args(kv_len, b, lk, q.device)
    err = build.load("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        m.data_ptr(), l.data_ptr(), FLOAT_DTYPES[q.dtype], b, h, kvh, lq, lk,
        d, int(causal), ROUTES.index(route), scale, n_valid, lens_ptr,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({route} "
                           f"route): CUDA error {err}")
    flash_attention_cuda.launches[route] += 1
    return out, m, l


flash_attention_cuda.launches = dict.fromkeys(ROUTES, 0)


def kernel_spec(geom):
    """Static declaration for ``repro_torch.analysis.kernel_guard``: the
    launch :func:`flash_route` picks for ``geom``'s (b, h, lq, dh) calls
    in f32 and bf16, from the kernel's own plan (``csrc/launch_plan.h``);
    exact attention accumulates no integer Σ."""
    from repro_torch.analysis.kernel_guard import (Coverage, KernelSpec,
                                                   Operand, launch_of)
    b, h, kvh, dh = geom["b"], geom["h"], geom["kvh"], geom["dh"]
    lq, lk = geom["lq"], geom["lk"]
    launches = []
    for dtype, dname in ((torch.float32, "float32"),
                         (torch.bfloat16, "bfloat16")):
        route = flash_route(dtype, dh)
        plan = build.host_plan("flash_attention",
                               [ROUTES.index(route), b, h, lq, dh])
        launches.append(launch_of(
            f"{dname}/{route}", plan,
            inputs=(Operand("q", (b, h, lq, dh), dname),
                    Operand("k", (b, kvh, lk, dh), dname),
                    Operand("v", (b, kvh, lk, dh), dname)),
            outputs=(Operand("out", (b, h, lq, dh)),
                     Operand("m", (b, h, lq)), Operand("l", (b, h, lq))),
            coverage=Coverage(rows=lq, kvh=h, rpb=plan["rows_per_block"],
                              flat=True)))
    return KernelSpec(name="flash_attention", module=__name__, kind="cuda",
                      launches=tuple(launches))
