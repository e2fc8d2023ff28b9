"""Paged-prefill LUT attention: the CUDA kernel's wrapper and its plain
version.

The counterpart of the JAX package's ``kernels/lut_attention/
paged_prefill.py`` (``paged_prefill_attention``, three
``pallas_call``s masked by ``_chunk_logits``).  A C-token prompt chunk
whose K/V are already in the pool attends causally to its sequence
through the block table: key ``pos`` is visible to chunk row ``i`` iff
``pos < kv_lens[b]`` and ``pos ≤ q_start[b] + i``.  Rows past a chunk's
valid length compute defined values that the engine discards, as in the
JAX package.

* :func:`paged_prefill_attention` launches ``csrc/paged_prefill.cu`` on
  CUDA tensors: one thread block per (slot, query head, tile of chunk
  rows) runs the three passes; on CPU tensors it runs the plain version.
* :func:`paged_prefill_plain` is the plain PyTorch version: gathered
  view + dense masked policy softmax (``ops.lut_attention_prefill_varlen``).
"""

from __future__ import annotations

import torch

from repro_torch.core.policies import SoftmaxPolicy
from repro_torch.kernels import build
from repro_torch.kernels.lut_attention import ops
from repro_torch.kernels.lut_attention.paged_decode import (
    _DTYPES, _kernel_tables, check_kernel_inputs)

Tensor = torch.Tensor


def paged_prefill_plain(q: Tensor, k_pages: Tensor, v_pages: Tensor,
                        block_tables: Tensor, q_start: Tensor,
                        kv_lens: Tensor, policy: SoftmaxPolicy, *,
                        scale: float | None = None) -> Tensor:
    """The plain PyTorch version: gathered view + dense policy softmax."""
    return ops.lut_attention_prefill_varlen(
        q, ops.gather_pages(k_pages, block_tables),
        ops.gather_pages(v_pages, block_tables), policy, q_start=q_start,
        kv_lens=kv_lens, scale=scale)


def paged_prefill_attention(
    q: Tensor,              # (B, H, C, Dh) chunk queries
    k_pages: Tensor,        # (num_pages, page_size, KVH, Dh) shared pool
    v_pages: Tensor,
    block_tables: Tensor,   # (B, max_pages_per_seq) int physical page ids
    q_start: Tensor,        # (B,) int — tokens cached before this chunk
    kv_lens: Tensor,        # (B,) int — valid keys incl. this chunk
    policy: SoftmaxPolicy,
    *,
    scale: float | None = None,
) -> Tensor:
    """Paged-prefill attention; returns (B, H, C, Dh) f32.

    CUDA tensors launch the kernel on the current stream (or raise);
    CPU tensors run :func:`paged_prefill_plain`.  ``launches`` counts the
    kernel launches.
    """
    if not q.is_cuda:
        return paged_prefill_plain(q, k_pages, v_pages, block_tables,
                                   q_start, kv_lens, policy, scale=scale)
    bt, kl, qs = check_kernel_inputs(q, k_pages, v_pages, block_tables,
                                     kv_lens, q_start)
    q = q.contiguous()
    b, h, c, dh = q.shape
    n_pages, ps, kvh, _ = k_pages.shape
    main, aux, ints, floats = _kernel_tables(policy, q.device)
    out = torch.empty((b, h, c, dh), dtype=torch.float32, device=q.device)
    scale = scale if scale is not None else dh ** -0.5
    err = build.load("paged_prefill")(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), bt.data_ptr(),
        kl.data_ptr(), qs.data_ptr(), main.data_ptr(), aux.data_ptr(),
        out.data_ptr(), _DTYPES[q.dtype], b, h, kvh, dh, n_pages, ps,
        bt.shape[1], c, *ints, scale, *floats,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_prefill kernel launch failed: CUDA error "
                           f"{err}")
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
