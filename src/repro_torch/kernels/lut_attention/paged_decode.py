"""Paged-decode LUT attention: the CUDA kernel's wrapper and its plain
version.

The counterpart of the JAX package's ``kernels/lut_attention/
paged_decode.py`` (``paged_decode_attention``, three ``pallas_call``s).
Every slot of the decode batch holds one single-token query that attends
to its own sequence, whose K/V lie scattered over the shared page pool
``(num_pages, page_size, KVH, Dh)``; the block table names the pages.

* :func:`paged_decode_attention` launches ``csrc/paged_decode.cu`` on
  CUDA tensors: one thread block per (slot, query head) runs the three
  passes (row max, integer Σ, per-element σ·V) over the live pages only.
  On CPU tensors it runs the plain version — only because the tensors
  lie on the CPU.
* :func:`paged_decode_plain` is the plain PyTorch version of the same
  function: gather the block-table view, then the dense masked policy
  softmax (``ops.lut_attention_decode_varlen``).

Both compute the same integer LUT pipeline (bins, ``e_int``, Σ,
``σ_int``); the f32 q·k dot and the σ·V contraction sum in different
orders, so outputs agree to f32 roundoff on the same logits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.lut_softmax import inv_scale
from repro_torch.core.policies import SoftmaxPolicy
from repro_torch.kernels import build
from repro_torch.kernels.common import policy_kernel_tables
from repro_torch.kernels.lut_attention import ops

Tensor = torch.Tensor

_METHODS = {"exact": 0, "rexp": 1, "lut2d": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=64)
def _kernel_tables(policy: SoftmaxPolicy, device: torch.device):
    """The policy's tables on ``device`` plus the scalar kernel arguments
    (method, round mode, the f32 reciprocals) — built once per policy and
    device, read-only afterwards."""
    if policy.impl not in _METHODS:
        raise ValueError(f"unsupported paged-kernel policy {policy.impl!r}")
    if policy.index_mode not in ("round", "floor"):
        raise ValueError(f"unknown index_mode {policy.index_mode!r}")
    (lut_main, lut_aux, exp_step, qmax, scale_ex,
     scale_sum) = policy_kernel_tables(policy.impl, ops._tables_for(policy))
    main = torch.as_tensor(np.ascontiguousarray(lut_main), device=device)
    aux = torch.as_tensor(np.ascontiguousarray(lut_aux), device=device)
    ints = (main.numel(), aux.shape[0], aux.shape[1], _METHODS[policy.impl],
            int(policy.index_mode == "round"))
    floats = (inv_scale(exp_step), inv_scale(qmax),
              inv_scale(qmax * scale_ex) if scale_ex else 0.0,
              inv_scale(qmax * scale_sum) if scale_sum else 0.0)
    return main, aux, ints, floats


def check_kernel_inputs(q: Tensor, k_pages: Tensor, v_pages: Tensor,
                        block_tables: Tensor, *cursors: Tensor):
    """Validate what the kernels take; returns the int32 contiguous
    block tables and cursors on the query's device.  Raises on anything
    the kernels do not take instead of launching on it."""
    dev = q.device
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged kernels take float32 or bfloat16, got "
                        f"{q.dtype}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; the "
                             f"queries are {q.dtype} on {dev}")
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
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("the kernels read the pools 16 bytes at a time: "
                         "their storage must be 16-byte aligned")
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


def paged_decode_plain(q: Tensor, k_pages: Tensor, v_pages: Tensor,
                       block_tables: Tensor, kv_lens: Tensor,
                       policy: SoftmaxPolicy, *,
                       scale: float | None = None) -> Tensor:
    """The plain PyTorch version: gathered view + dense policy softmax."""
    return ops.lut_attention_decode_varlen(
        q, ops.gather_pages(k_pages, block_tables),
        ops.gather_pages(v_pages, block_tables), policy, kv_lens,
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
) -> Tensor:
    """Paged-decode attention; returns (B, H, 1, Dh) f32.

    CUDA tensors launch the kernel on the current stream (or raise);
    CPU tensors run :func:`paged_decode_plain`.  ``launches`` counts the
    kernel launches.
    """
    b, h, lq, dh = q.shape
    if lq != 1:
        raise ValueError(f"paged decode takes single-token queries, got "
                         f"Lq={lq}")
    if not q.is_cuda:
        return paged_decode_plain(q, k_pages, v_pages, block_tables,
                                  kv_lens, policy, scale=scale)
    bt, kl = check_kernel_inputs(q, k_pages, v_pages, block_tables, kv_lens)
    q = q.contiguous()
    n_pages, ps, kvh, _ = k_pages.shape
    main, aux, ints, floats = _kernel_tables(policy, q.device)
    out = torch.empty((b, h, 1, dh), dtype=torch.float32, device=q.device)
    scale = scale if scale is not None else dh ** -0.5
    err = build.load("paged_decode")(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), bt.data_ptr(),
        kl.data_ptr(), main.data_ptr(), aux.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], b, h, kvh, dh, n_pages, ps, bt.shape[1], *ints,
        scale, *floats, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error "
                           f"{err}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
