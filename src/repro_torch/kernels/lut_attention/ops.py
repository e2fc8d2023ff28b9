"""Public paged attention-with-LUT-softmax API.

The continuous-batching engine attends through the two *paged*
dispatchers — :func:`lut_attention_paged_decode` (single-token decode)
and :func:`lut_attention_paged_prefill` (prompt chunks whose K/V are
already in the pool).  Both follow ONE dispatch matrix, keyed by the
``paged_backend`` knob and by where the tensors lie:

    knob (``paged_backend``)   CUDA tensors          CPU tensors
    ``auto``                   the CUDA kernel       the plain version
    ``cuda``                   the CUDA kernel       raises
    ``dense``                  the plain version     the plain version

There is no fallback: on CUDA tensors ``auto`` and ``cuda`` launch the
hand-written kernel (``csrc/paged_decode.cu`` / ``csrc/paged_prefill.cu``)
or raise — a kernel that does not build or does not launch is an
exception, never a silent switch to the plain version or to the CPU.
``cuda`` is the counterpart of the JAX package's ``pallas`` knob.

The plain version of both kernels is the dense reference below: gather
the block-table view of the pool (:func:`gather_pages`), materialize the
masked logits, and run the policy softmax of ``core.lut_softmax``
(:func:`_policy_softmax`).  It computes the same function as the kernels
— identical integer LUT pipeline, the final f32 σ·V contraction in
another order — and is what the CPU tests hold to the JAX package.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import lut_builder
from repro_torch.core import lut_softmax as _core
from repro_torch.core.policies import SoftmaxPolicy

Tensor = torch.Tensor


@functools.lru_cache(maxsize=None)
def _tables_for(policy: SoftmaxPolicy):
    """The policy's Table-8 LUT bundle (None for exact); tables are
    read-only, so one bundle per policy is shared."""
    if policy.impl == "rexp":
        return lut_builder.build_rexp_tables(policy.precision,
                                             policy.alpha_len)
    if policy.impl == "lut2d":
        return lut_builder.build_lut2d_tables(policy.precision)
    return None


def _logits(q: Tensor, k: Tensor, scale: float) -> Tensor:
    """(B, H, Lq, D) × (B, KVH, Lk, D) → (B, H, Lq, Lk) f32 logits; query
    head h reads KV head h // G (GQA), in f32 whatever the input dtype."""
    b, h, lq, d = q.shape
    kvh, lk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, kvh, h // kvh, lq, d)
    s = torch.matmul(qg, k.float().unsqueeze(2).transpose(-1, -2))
    return s.reshape(b, h, lq, lk) * scale


def _policy_softmax(s: Tensor, policy: SoftmaxPolicy) -> Tensor:
    """Masked logits (−inf tails) → σ under the policy's semantics.

    Single dispatch point for every dense serving path, so decode and
    prefill cannot silently diverge.
    """
    if policy.impl == "exact":
        return _core.softmax_exact(s, axis=-1)
    if policy.impl == "rexp":
        return _core.softmax_rexp(s, _tables_for(policy), axis=-1,
                                  index_mode=policy.index_mode)
    if policy.impl == "lut2d":
        return _core.softmax_lut2d(s, _tables_for(policy), axis=-1,
                                   index_mode=policy.index_mode)
    raise ValueError(f"unsupported softmax policy {policy.impl!r}")


def _grouped_pv(p: Tensor, v: Tensor) -> Tensor:
    """σ (B, H, Lq, Lk) × v (B, KVH, Lk, D) → (B, H, Lq, D) f32, each KV
    head's value rows shared by its G query heads (no repeated V)."""
    b, h, lq, lk = p.shape
    kvh = v.shape[1]
    out = torch.matmul(p.reshape(b, kvh, h // kvh, lq, lk),
                       v.float().unsqueeze(2))
    return out.reshape(b, h, lq, -1)


def lut_attention_decode_varlen(q: Tensor, k: Tensor, v: Tensor,
                                policy: SoftmaxPolicy, kv_lens: Tensor, *,
                                scale: float | None = None) -> Tensor:
    """Decode attention with a *per-sequence* valid KV length.

    q (B, H, Lq, D); k, v (B, KVH, Lk, D) — the block-table-gathered
    view of the pool (logical order, junk past ``kv_lens``); kv_lens (B,)
    int.  Keys at or past ``kv_lens`` are masked to −inf before the
    policy softmax.
    """
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    s = _logits(q, k, scale)
    valid = torch.arange(k.shape[2], device=q.device)[None, :] \
        < kv_lens.to(q.device)[:, None]                        # (B, Lk)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    return _grouped_pv(_policy_softmax(s, policy), v)


def lut_attention_prefill_varlen(q: Tensor, k: Tensor, v: Tensor,
                                 policy: SoftmaxPolicy, *, q_start: Tensor,
                                 kv_lens: Tensor,
                                 scale: float | None = None) -> Tensor:
    """Chunked-prefill attention with materialized logits (the oracle).

    Query row i sits at absolute position ``q_start + i`` and sees keys
    ``[0, q_start + i]``; keys at or past ``kv_lens`` are masked per row.
    q (B, H, C, D); k, v (B, KVH, Lk, D) gathered views; q_start,
    kv_lens (B,) int.
    """
    lq, d = q.shape[2], q.shape[3]
    scale = scale if scale is not None else d ** -0.5
    s = _logits(q, k, scale)
    dev = q.device
    ki = torch.arange(k.shape[2], device=dev)[None, None, None, :]
    qi = (q_start.to(dev)[:, None]
          + torch.arange(lq, device=dev)[None, :])[:, None, :, None]
    mask = (ki <= qi) & (ki < kv_lens.to(dev)[:, None, None, None])
    s = s.masked_fill(~mask, float("-inf"))
    return _grouped_pv(_policy_softmax(s, policy), v)


def gather_pages(pages: Tensor, block_tables: Tensor) -> Tensor:
    """(P, ps, KVH, Dh) pool + (B, mp) table → (B, KVH, mp·ps, Dh) view.

    Logical token order is preserved: page j of a slot covers absolute
    positions [j·ps, (j+1)·ps).  This materialized view exists only on
    the plain path — the CUDA kernels read pages straight from the pool.
    """
    b, mp = block_tables.shape
    ps, kvh, dh = pages.shape[1], pages.shape[2], pages.shape[3]
    g = pages[block_tables.long()]              # (B, mp, ps, KVH, Dh)
    return g.permute(0, 3, 1, 2, 4).reshape(b, kvh, mp * ps, dh)


def _resolve_paged(backend: str, device: torch.device, *, kind: str) -> str:
    """The dispatch matrix of the module docstring, in code: returns
    ``'cuda'`` (the kernel) or ``'dense'`` (the plain version)."""
    device = torch.device(device)
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "dense"
    if backend == "cuda":
        if device.type != "cuda":
            raise ValueError(
                f"paged {kind} backend 'cuda' needs CUDA tensors, got "
                f"{device}; use 'auto' or 'dense' on the CPU")
        return "cuda"
    if backend == "dense":
        return "dense"
    raise ValueError(f"unknown paged {kind} backend {backend!r}: expected "
                     f"'auto', 'cuda' or 'dense'")


def resolve_paged_backend(backend: str = "auto",
                          device: torch.device | str = "cuda") -> str:
    """Resolve the paged-decode knob for tensors on ``device``."""
    return _resolve_paged(backend, device, kind="decode")


def resolve_paged_prefill_backend(backend: str = "auto",
                                  device: torch.device | str = "cuda") -> str:
    """Resolve the paged-prefill knob for tensors on ``device`` (the same
    matrix as :func:`resolve_paged_backend`)."""
    return _resolve_paged(backend, device, kind="prefill")


def lut_attention_paged_decode(
    q: Tensor,              # (B, H, 1, D) single-token queries
    k_pages: Tensor,        # (num_pages, page_size, KVH, D) shared pool
    v_pages: Tensor,
    block_tables: Tensor,   # (B, max_pages_per_seq) int32
    kv_lens: Tensor,        # (B,) int32 — valid keys incl. the new token
    policy: SoftmaxPolicy,
    *,
    scale: float | None = None,
    backend: str = "auto",  # 'auto' | 'cuda' | 'dense'
) -> Tensor:
    """Decode attention straight off the paged KV pool; (B, H, 1, D) f32.

    Dispatches per the module docstring's matrix: the CUDA kernel walks
    the block tables page by page (no gathered view, no logits tensor);
    the plain version gathers the block-table view and reuses
    :func:`lut_attention_decode_varlen`.
    """
    from repro_torch.kernels.lut_attention import paged_decode
    fn = (paged_decode.paged_decode_attention
          if resolve_paged_backend(backend, q.device) == "cuda"
          else paged_decode.paged_decode_plain)
    return fn(q, k_pages, v_pages, block_tables, kv_lens, policy,
              scale=scale)


def lut_attention_paged_prefill(
    q: Tensor,              # (B, H, C, D) chunk queries
    k_pages: Tensor,        # (num_pages, page_size, KVH, D) shared pool
    v_pages: Tensor,
    block_tables: Tensor,   # (B, max_pages_per_seq) int32
    q_start: Tensor,        # (B,) int32 — tokens cached before this chunk
    kv_lens: Tensor,        # (B,) int32 — valid keys incl. this chunk
    policy: SoftmaxPolicy,
    *,
    scale: float | None = None,
    backend: str = "auto",  # 'auto' | 'cuda' | 'dense'
) -> Tensor:
    """Prefill-chunk attention reading prior keys through the block
    tables; (B, H, C, D) f32.  The chunk's K/V were already scattered
    into the pool, so the pool is the only KV storage.  Dispatches per
    the module docstring's matrix."""
    from repro_torch.kernels.lut_attention import paged_prefill
    fn = (paged_prefill.paged_prefill_attention
          if resolve_paged_prefill_backend(backend, q.device) == "cuda"
          else paged_prefill.paged_prefill_plain)
    return fn(q, k_pages, v_pages, block_tables, q_start, kv_lens, policy,
              scale=scale)
