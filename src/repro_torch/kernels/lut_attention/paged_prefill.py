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
  CUDA tensors: one thread-block cluster per (slot, KV head, block of
  up to 16 of its query heads × chunk rows) runs the three passes over
  the live pages, split across its CTAs; given ``k_scales`` /
  ``v_scales`` (an int8 pool, the ``_pf_*_kernel_int8`` bodies) it
  launches the int8 entry point.  On CPU tensors it runs the plain
  version.
* :func:`paged_prefill_plain` is the plain PyTorch version: gathered
  (dequantized) view + dense masked policy softmax
  (``ops.lut_attention_prefill_varlen``).
"""

from __future__ import annotations

import torch

from repro_torch.core.policies import SoftmaxPolicy
from repro_torch.kernels import build
from repro_torch.kernels.common import KERNEL_DTYPES, shapes_only
from repro_torch.kernels.lut_attention import ops
from repro_torch.kernels.lut_attention.paged_decode import (
    _kernel_tables, aligned, check_kernel_inputs, max_len_arg,
    plan_heads_arg)

Tensor = torch.Tensor


def paged_prefill_plain(q: Tensor, k_pages: Tensor, v_pages: Tensor,
                        block_tables: Tensor, q_start: Tensor,
                        kv_lens: Tensor, policy: SoftmaxPolicy, *,
                        scale: float | None = None,
                        k_scales: Tensor | None = None,
                        v_scales: Tensor | None = None) -> Tensor:
    """The plain PyTorch version: gathered (dequantized) view + dense
    policy softmax."""
    k, v = ops.gather_kv(k_pages, v_pages, block_tables, kv_lens, k_scales,
                         v_scales)
    return ops.lut_attention_prefill_varlen(q, k, v, policy, q_start=q_start,
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
    k_scales: Tensor | None = None,  # (num_pages, page_size, KVH) f32 —
    v_scales: Tensor | None = None,  # an int8 pool's row scales
    max_kv_len: int | None = None,   # host-known bound on kv_lens
    plan_kv_heads: int | None = None,  # KV heads the split is planned for
) -> Tensor:
    """Paged-prefill attention; returns (B, H, C, Dh) f32.

    CUDA tensors launch the kernel on the current stream (or raise);
    CPU tensors run :func:`paged_prefill_plain`.  ``max_kv_len`` and
    ``plan_kv_heads`` only steer the kernel's split of the keys
    (``paged_decode.max_len_arg``, ``plan_heads_arg``).  ``launches``
    counts the launches on f32/bf16 pools, ``int8_launches`` those on
    int8 pools.
    """
    if shapes_only(q):
        return torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if not q.is_cuda:
        return paged_prefill_plain(q, k_pages, v_pages, block_tables,
                                   q_start, kv_lens, policy, scale=scale,
                                   k_scales=k_scales, v_scales=v_scales)
    bt, kl, qs = check_kernel_inputs(q, k_pages, v_pages, block_tables,
                                     kv_lens, q_start, k_scales=k_scales,
                                     v_scales=v_scales)
    q = aligned(q)
    b, h, c, dh = q.shape
    n_pages, ps, kvh, _ = k_pages.shape
    main, aux, ints, floats = _kernel_tables(policy, q.device)
    out = torch.empty((b, h, c, dh), dtype=torch.float32, device=q.device)
    scale = scale if scale is not None else dh ** -0.5
    pools = (k_pages.data_ptr(), v_pages.data_ptr())
    int8 = k_scales is not None
    if int8:
        pools += (k_scales.data_ptr(), v_scales.data_ptr())
    err = build.load("paged_prefill",
                     f"paged_prefill{'_int8' * int8}_launch")(
        q.data_ptr(), *pools, bt.data_ptr(), kl.data_ptr(), qs.data_ptr(),
        main.data_ptr(), aux.data_ptr(), out.data_ptr(),
        KERNEL_DTYPES[q.dtype], b, h, kvh, dh, n_pages, ps, bt.shape[1], c,
        *ints, scale, *floats, max_len_arg(max_kv_len),
        plan_heads_arg(plan_kv_heads, kvh),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_prefill{'_int8' * int8} kernel launch "
                           f"failed: CUDA error {err}")
    if int8:
        paged_prefill_attention.int8_launches += 1
    else:
        paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
paged_prefill_attention.int8_launches = 0
