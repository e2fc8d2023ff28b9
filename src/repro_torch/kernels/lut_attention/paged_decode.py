"""Paged-decode LUT attention: the CUDA kernel's wrapper and its plain
version.

The counterpart of the JAX package's ``kernels/lut_attention/
paged_decode.py`` (``paged_decode_attention``, three ``pallas_call``s).
Every slot of the decode batch holds one single-token query that attends
to its own sequence, whose K/V lie scattered over the shared page pool
``(num_pages, page_size, KVH, Dh)``; the block table names the pages.

* :func:`paged_decode_attention` launches ``csrc/paged_decode.cu`` on
  CUDA tensors: one thread-block cluster per (slot, KV head) holds the
  KV head's query heads as its rows and runs the three passes (row max,
  integer Σ, per-element σ·V) over the live pages only, split across
  its CTAs (the launcher picks the split from the shapes,
  ``max_kv_len``, the caller's bound on ``kv_lens``, and
  ``plan_kv_heads``, the KV heads it plans for).  Given
  ``k_scales`` / ``v_scales`` (an int8 pool, the JAX package's
  ``_pg_*_kernel_int8`` bodies) it launches the int8 entry point
  instead, which dequantizes each row before use.  On CPU tensors it
  runs the plain version — only because the tensors lie on the CPU.
* :func:`paged_decode_plain` is the plain PyTorch version of the same
  function: gather (and, for an int8 pool, dequantize) the block-table
  view, then the dense masked policy softmax
  (``ops.lut_attention_decode_varlen``).

Both compute the same integer LUT pipeline (bins, ``e_int``, Σ,
``σ_int``); the f32 q·k dot and the σ·V contraction sum in different
orders, so outputs agree to f32 roundoff on the same logits.
"""

from __future__ import annotations

import torch

from repro_torch.core.policies import SoftmaxPolicy
from repro_torch.kernels import build
from repro_torch.kernels.common import (KERNEL_DTYPES, kernel_tables,
                                        shapes_only)
from repro_torch.kernels.lut_attention import ops

Tensor = torch.Tensor


def _kernel_tables(policy: SoftmaxPolicy, device: torch.device):
    """``common.kernel_tables`` of a policy (the paged kernels' form)."""
    return kernel_tables(policy.impl, ops._tables_for(policy),
                         policy.index_mode, device)


def check_kernel_inputs(q: Tensor, k_pages: Tensor, v_pages: Tensor,
                        block_tables: Tensor, *cursors: Tensor,
                        k_scales: Tensor | None = None,
                        v_scales: Tensor | None = None):
    """Validate what the kernels take; returns the int32 contiguous
    block tables and cursors on the query's device.  Raises on anything
    the kernels do not take instead of launching on it (the queries go
    through :func:`aligned`).

    A float pool has the queries' dtype; an int8 pool comes with both
    scale pools, f32, contiguous, ``(n_pages, page_size, KVH)``, on the
    queries' device."""
    dev = q.device
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"paged kernels take float32 or bfloat16, got "
                        f"{q.dtype}")
    quantized = ops.check_scales(k_scales, v_scales)
    pool_dtype = torch.int8 if quantized else q.dtype
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.device != dev or t.dtype != pool_dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; the "
                             f"kernel takes {pool_dtype} pages for "
                             f"{q.dtype} queries on {dev}"
                             f"{' with scales' if quantized else ''}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (n_pages, "
                             f"page_size, KVH, Dh) pool, got shape "
                             f"{tuple(t.shape)}")
    if k_pages.shape != v_pages.shape:
        raise ValueError(f"k/v pools differ: {tuple(k_pages.shape)} vs "
                         f"{tuple(v_pages.shape)}")
    b, h, _, dh = q.shape
    kvh = k_pages.shape[2]
    if k_pages.shape[3] != dh or h % kvh or dh > 256 or dh % 8:
        raise ValueError(f"queries (H={h}, Dh={dh}) do not fit the pool "
                         f"(KVH={kvh}, Dh={k_pages.shape[3]}); the kernels "
                         f"take Dh ≤ 256, a multiple of 8")
    align = 8 if quantized else 16
    if k_pages.data_ptr() % align or v_pages.data_ptr() % align:
        raise ValueError(f"the kernels read the pools {align} bytes at a "
                         f"time: their storage must be {align}-byte "
                         f"aligned")
    if quantized:
        for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            if (t.device != dev or t.dtype != torch.float32
                    or t.shape != k_pages.shape[:3]
                    or not t.is_contiguous()):
                raise ValueError(
                    f"{name} must be a contiguous float32 "
                    f"{tuple(k_pages.shape[:3])} scale pool on {dev}, got "
                    f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block_tables must be (B={b}, mp), got "
                         f"{tuple(block_tables.shape)}")
    out = [block_tables.to(device=dev, dtype=torch.int32).contiguous()]
    for c in cursors:
        if c.shape != (b,):
            raise ValueError(f"per-slot cursors must be (B={b},), got "
                             f"{tuple(c.shape)}")
        out.append(c.to(device=dev, dtype=torch.int32).contiguous())
    return out


def aligned(q: Tensor) -> Tensor:
    """``q`` contiguous and 16-byte aligned: the kernels read query rows
    16 bytes at a time (a view that starts off a 16-byte boundary is
    copied, not refused)."""
    q = q.contiguous()
    return q.clone() if q.data_ptr() % 16 else q


def max_len_arg(max_kv_len: int | None) -> int:
    """The launchers' ``max_kv_len``: the caller's bound on the slots'
    live lengths, known on the host (0: none — the kernel then splits for
    the block table's whole width).  A slot past it is still computed in
    full; the bound only steers how the keys are split."""
    if max_kv_len is None:
        return 0
    if max_kv_len < 0:
        raise ValueError(f"max_kv_len must be ≥ 0, got {max_kv_len}")
    return int(max_kv_len)


def plan_heads_arg(plan_kv_heads: int | None, kvh: int) -> int:
    """The launchers' ``plan_kv_heads``: the KV-head count the split of
    the keys is planned for (0: the call's own ``kvh``).  A
    tensor-parallel rank that launches ``kvh`` of the model's heads passes
    the model's count, so each head's keys split, and sum, as in the
    single-device launch; the grid still covers the call's own heads."""
    if plan_kv_heads is None:
        return 0
    if plan_kv_heads < kvh:
        raise ValueError(f"plan_kv_heads ({plan_kv_heads}) below the "
                         f"call's {kvh} KV heads")
    return int(plan_kv_heads)


def paged_decode_plain(q: Tensor, k_pages: Tensor, v_pages: Tensor,
                       block_tables: Tensor, kv_lens: Tensor,
                       policy: SoftmaxPolicy, *,
                       scale: float | None = None,
                       k_scales: Tensor | None = None,
                       v_scales: Tensor | None = None) -> Tensor:
    """The plain PyTorch version: gathered (dequantized) view + dense
    policy softmax."""
    k, v = ops.gather_kv(k_pages, v_pages, block_tables, kv_lens, k_scales,
                         v_scales)
    return ops.lut_attention_decode_varlen(q, k, v, policy, kv_lens,
                                           scale=scale)


def paged_decode_attention(
    q: Tensor,              # (B, H, 1, Dh) single-token queries
    k_pages: Tensor,        # (num_pages, page_size, KVH, Dh) shared pool
    v_pages: Tensor,
    block_tables: Tensor,   # (B, max_pages_per_seq) int physical page ids
    kv_lens: Tensor,        # (B,) int — valid keys incl. the new token
    policy: SoftmaxPolicy,
    *,
    scale: float | None = None,
    k_scales: Tensor | None = None,  # (num_pages, page_size, KVH) f32 —
    v_scales: Tensor | None = None,  # an int8 pool's row scales
    max_kv_len: int | None = None,   # host-known bound on kv_lens
    plan_kv_heads: int | None = None,  # KV heads the split is planned for
) -> Tensor:
    """Paged-decode attention; returns (B, H, 1, Dh) f32.

    CUDA tensors launch the kernel on the current stream (or raise);
    CPU tensors run :func:`paged_decode_plain`.  ``max_kv_len`` and
    ``plan_kv_heads`` only steer the kernel's split of the keys
    (:func:`max_len_arg`, :func:`plan_heads_arg`).
    ``launches`` counts the launches on f32/bf16 pools, ``int8_launches``
    those on int8 pools.
    """
    b, h, lq, dh = q.shape
    if lq != 1:
        raise ValueError(f"paged decode takes single-token queries, got "
                         f"Lq={lq}")
    if shapes_only(q):
        return torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if not q.is_cuda:
        return paged_decode_plain(q, k_pages, v_pages, block_tables,
                                  kv_lens, policy, scale=scale,
                                  k_scales=k_scales, v_scales=v_scales)
    bt, kl = check_kernel_inputs(q, k_pages, v_pages, block_tables, kv_lens,
                                 k_scales=k_scales, v_scales=v_scales)
    q = aligned(q)
    n_pages, ps, kvh, _ = k_pages.shape
    main, aux, ints, floats = _kernel_tables(policy, q.device)
    out = torch.empty((b, h, 1, dh), dtype=torch.float32, device=q.device)
    scale = scale if scale is not None else dh ** -0.5
    pools = (k_pages.data_ptr(), v_pages.data_ptr())
    int8 = k_scales is not None
    if int8:
        pools += (k_scales.data_ptr(), v_scales.data_ptr())
    err = build.load("paged_decode", f"paged_decode{'_int8' * int8}_launch")(
        q.data_ptr(), *pools, bt.data_ptr(), kl.data_ptr(), main.data_ptr(),
        aux.data_ptr(), out.data_ptr(), KERNEL_DTYPES[q.dtype], b, h, kvh,
        dh, n_pages, ps, bt.shape[1], *ints, scale, *floats,
        max_len_arg(max_kv_len), plan_heads_arg(plan_kv_heads, kvh),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode{'_int8' * int8} kernel launch "
                           f"failed: CUDA error {err}")
    if int8:
        paged_decode_attention.int8_launches += 1
    else:
        paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.int8_launches = 0
