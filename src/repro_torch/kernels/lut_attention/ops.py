"""Public attention-with-LUT-softmax API.

The lockstep path (contiguous ``AttnCache``, ``serve_loop.generate``)
and the encoder-decoder's full-sequence attentions go through
:func:`lut_attention`, whose dispatch matrix is keyed by the
``attention_backend`` knob and by where the tensors lie:

    knob (``attention_backend``)   CUDA tensors          CPU tensors
    ``auto``                       the dense CUDA kernel the plain version
    ``cuda``                       the dense CUDA kernel raises
    ``naive``                      the plain version     the plain version
    ``blocked``                    the blocked path      the blocked path

The kernel is ``csrc/lut_attention.cu`` (the port of the JAX package's
``lut_attention_pallas``); its plain version is the materialized-logits
oracle ``ref.lut_attention_ref``.  The exact policy takes the plain
version under every knob, as the JAX package sends it to its naive
path: the TPU kernel has no exact body, and no launch is counted for it.
Without a ``kv_len`` REXP takes its fused α form; with one (a cache's
valid length) the faithful per-element σ — 2D-LUT is faithful in both.
``blocked`` is :func:`lut_attention_blocked`, the port of the JAX
package's flash-style XLA scan: plain PyTorch over (q-chunk × k-chunk)
tiles, never more than one tile of logits per (batch, head), with the
fused-requant semantics for the LUT policies whatever the ``kv_len``
(as in the JAX package); it runs no kernel on either device.

The continuous-batching engine attends through the two *paged*
dispatchers — :func:`lut_attention_paged_decode` (single-token decode)
and :func:`lut_attention_paged_prefill` (prompt chunks whose K/V are
already in the pool).  Both follow ONE dispatch matrix, keyed by the
``paged_backend`` knob and by where the tensors lie:

    knob (``paged_backend``)   CUDA tensors          CPU tensors
    ``auto``                   the CUDA kernel       the plain version
    ``cuda``                   the CUDA kernel       raises
    ``dense``                  the plain version     the plain version

and two ``mesh`` rows (tensor-parallel serving; any knob with a mesh of
``tp > 1`` — :func:`paged_mesh_regime` picks the row, and the pool each
rank passes is its own share, ``partitioning.local_pool_specs``):

    ``mesh``, KVH % tp == 0    ``'heads'``: each rank attends its H/tp
                               query heads against its KVH/tp pool heads
                               through the knob's row above (the CUDA
                               kernel on CUDA tensors), then one
                               all-gather of the (B, H, Lq, D) output
    ``mesh``, KVH % tp != 0    ``'pages'``: each rank holds a slab of the
                               pages; plain-torch (m, Σ, σ·V) partials
                               over its slab, reduced by all-reduces of
                               (B, H, Lq, 1) max and Σ and of the
                               (B, H, Lq, D) σ·V — never gathered KV

(``kernels/lut_attention/sharded_paged.py``; the JAX package computes
its ``'pages'`` partials in plain JAX too, and no CUDA kernel returns
them yet).

Tensors of shapes only (fake or meta: ``kernels.common.shapes_only``,
the dry run's) take the CUDA column of both matrices, whatever device
they name: the kernels' fake implementations give their outputs'
shapes, so a trace follows the card's path and nothing runs.

There is no fallback in either matrix: on CUDA tensors ``auto`` and
``cuda`` launch the hand-written kernel (``csrc/paged_decode.cu`` /
``csrc/paged_prefill.cu`` / ``csrc/lut_attention.cu``) or raise — a
kernel that does not build or does not launch is an exception, never a
silent switch to the plain version or to the CPU.  ``cuda`` is the
counterpart of the JAX package's ``pallas`` knob.

An int8 pool (``kv_dtype="int8"``) passes its f32 per-token × KV-head
scale pools as ``k_scales`` / ``v_scales`` (both or neither) beside the
int8 pages: the kernels dequantize each row before use, the plain
version dequantizes the gathered view (:func:`_gather_dequant`); the
integer LUT pipeline is the same.

The plain version of both paged kernels is the dense reference below:
gather the block-table view of the pool (:func:`gather_pages`),
materialize the masked logits, and run the policy softmax of
``core.lut_softmax`` (:func:`_policy_softmax`).  It computes the same
function as the kernels — identical integer LUT pipeline, the final f32
σ·V contraction in another order — and is what the CPU tests hold to
the JAX package.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import lut_builder
from repro_torch.core import lut_softmax as _core
from repro_torch.core.policies import SoftmaxPolicy
from repro_torch.core.quantization import dequantize_rows
from repro_torch.kernels.common import shapes_only
from repro_torch.kernels.lut_attention import ref as _ref
from repro_torch.kernels.lut_attention.lut_attention import lut_attention_cuda

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


# ---------------------------------------------------------------------------
# Blocked path (flash-style chunk loops; per-row kv_len and q_start)
# ---------------------------------------------------------------------------


def _chunk_mask(q0: int, k0: int, bq: int, bk: int, causal: bool, lq: int,
                lk_eff: Tensor | int, q_start: Tensor | int | None,
                device: torch.device) -> Tensor:
    """Visibility mask for a (q-chunk, k-chunk) tile.

    ``lk_eff`` (valid key count) and ``q_start`` (absolute position of
    query row 0) may be scalars or per-row ``(B,)`` tensors.  Returns a
    mask broadcastable against the ``(B, KVH, G, bq, bk)`` logits tile:
    ``(bq, bk)`` gains a leading batch axis only when a per-row argument
    is given.  Without ``q_start`` the causal queries are the *last*
    ``lq`` positions of the valid keys (``q_start = lk_eff − lq``).
    """
    def _b(x):  # scalar → as is; (B,) → (B, 1, 1, 1, 1)
        x = torch.as_tensor(x, device=device)
        return x.reshape(-1, 1, 1, 1, 1) if x.dim() == 1 else x
    ki = (k0 + torch.arange(bk, device=device))[None, :]       # (1, bk)
    mask = ki < _b(lk_eff)
    if causal:
        if q_start is None:
            q_start = torch.as_tensor(lk_eff, device=device) - lq
        qi = (q0 + torch.arange(bq, device=device))[:, None] + _b(q_start)
        mask = mask & (ki <= qi)
    return mask


def _grouped_logits(qc: Tensor, kc: Tensor, scale: float) -> Tensor:
    """q (B, KVH, G, bq, D) × k (B, KVH, bk, D) → (B, KVH, G, bq, bk) f32."""
    return torch.matmul(qc.float(),
                        kc.float().unsqueeze(2).transpose(-1, -2)) * scale


def lut_attention_blocked(q: Tensor, k: Tensor, v: Tensor,
                          policy: SoftmaxPolicy, *, causal: bool = False,
                          scale: float | None = None,
                          kv_len: Tensor | int | None = None,
                          q_start: Tensor | int | None = None,
                          q_chunk: int = 512, k_chunk: int = 1024) -> Tensor:
    """Flash-style LUT attention in plain PyTorch (fused-requant
    semantics); (B, H, Lq, D) f32.

    The port of the JAX package's ``lut_attention_blocked``: a loop over
    query chunks, and inside it over key chunks.  Exact softmax runs the
    online recurrence (running max, sum and rescaled accumulator); REXP
    and 2D-LUT take one pass for the row max and one for the integer Σ
    and U = Σ e·v, then REXP scales U by α(Σ)/qmax² and 2D-LUT by
    1/(qmax · j(Σ) · scale_Σ), the binned denominator.  q (B, H, Lq, D);
    k, v (B, KVH, Lk, D).  ``kv_len`` (scalar or per-row (B,)) masks the
    tail of a pre-allocated cache; ``q_start`` (scalar or (B,)) pins the
    absolute position of query row 0 for the causal mask (default
    ``kv_len − Lq``).  Never materializes more than a (q_chunk ×
    k_chunk) logits tile per (batch, head); the padding to chunk
    multiples never counts as valid keys.  The JAX function's ``unroll``
    only serves XLA's cost analysis and has no counterpart here.
    """
    b, h, lq, d = q.shape
    kvh, lk = k.shape[1], k.shape[2]
    g = h // kvh
    dev = q.device
    scale = scale if scale is not None else d ** -0.5
    bq, bk = min(q_chunk, lq), min(k_chunk, lk)
    lq_p, lk_p = -(-lq // bq) * bq, -(-lk // bk) * bk
    q = torch.nn.functional.pad(q, (0, 0, 0, lq_p - lq))
    k = torch.nn.functional.pad(k, (0, 0, 0, lk_p - lk))
    v = torch.nn.functional.pad(v, (0, 0, 0, lk_p - lk))
    lk_eff = lk if kv_len is None else kv_len     # never the padding
    qg = q.reshape(b, kvh, g, lq_p, d)

    def tiles(qi):
        """(key chunk, value chunk, masked logits) of query chunk qi."""
        qc = qg[:, :, :, qi * bq:(qi + 1) * bq]
        for ki in range(lk_p // bk):
            kc, vc = (t[:, :, ki * bk:(ki + 1) * bk] for t in (k, v))
            mask = _chunk_mask(qi * bq, ki * bk, bq, bk, causal, lq, lk_eff,
                               q_start, dev)
            s = _grouped_logits(qc, kc, scale).masked_fill(~mask,
                                                            float("-inf"))
            yield vc, s

    if policy.impl == "exact":
        def one_q_chunk(qi):
            m = torch.full((b, kvh, g, bq), float("-inf"), device=dev)
            l = torch.zeros((b, kvh, g, bq), device=dev)
            acc = torch.zeros((b, kvh, g, bq, d), device=dev)
            for vc, s in tiles(qi):
                m_new = torch.maximum(m, torch.amax(s, dim=-1))
                m_safe = torch.where(torch.isfinite(m_new), m_new,
                                     torch.zeros_like(m_new))
                p = torch.where(torch.isfinite(s),
                                torch.exp(s - m_safe[..., None]),
                                torch.zeros_like(s))
                corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                                   torch.zeros_like(m))
                l = l * corr + torch.sum(p, dim=-1)
                acc = (acc * corr[..., None]
                       + torch.matmul(p, vc.float().unsqueeze(2)))
                m = m_new
            return acc / torch.clamp(l, min=1e-30)[..., None]
    else:
        tables = _tables_for(policy)
        qmax = tables.precision.qmax
        inv = _core.inv_scale(qmax)
        if policy.impl == "rexp":
            lut_main, e_step = tables.lut_recip_exp, 1.0
        else:
            lut_main, e_step = tables.lut_exp, tables.exp_step
        lut_main = torch.as_tensor(lut_main, dtype=torch.int32, device=dev)
        n_lut = lut_main.shape[0]

        def e_of(s, m_safe):
            """f32 integer numerators of a tile given the row max."""
            finite = torch.isfinite(s)
            dd = torch.where(finite,
                             (m_safe[..., None] - s) * _core.inv_scale(e_step),
                             torch.full_like(s, n_lut - 1))
            idx = _core._bin_index(dd, policy.index_mode, 0, n_lut - 1)
            return torch.where(finite, lut_main[idx],
                               torch.zeros((), dtype=torch.int32,
                                           device=dev)).float()

        def one_q_chunk(qi):
            m = torch.full((b, kvh, g, bq), float("-inf"), device=dev)
            for _, s in tiles(qi):
                m = torch.maximum(m, torch.amax(s, dim=-1))
            m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
            ssum = torch.zeros((b, kvh, g, bq), device=dev)
            u = torch.zeros((b, kvh, g, bq, d), device=dev)
            for vc, s in tiles(qi):
                e = e_of(s, m_safe)
                ssum = ssum + torch.sum(e, dim=-1)
                u = u + torch.matmul(e, vc.float().unsqueeze(2))
            if policy.impl == "rexp":
                lut_a = torch.as_tensor(tables.lut_alpha, dtype=torch.int32,
                                        device=dev)
                ja = _core._bin_index(ssum * inv, policy.index_mode, 0,
                                      lut_a.shape[0] - 1)
                return u * (lut_a[ja].float() * inv * inv)[..., None]
            # 2D-LUT's fused form divides U by the binned denominator: the
            # faithful per-element σ is only on the naive and kernel paths
            n_cols = tables.lut_sigma.shape[1]
            jj = _core._bin_index(
                ssum * _core.inv_scale(qmax * tables.scale_sum),
                policy.index_mode, 1, n_cols).float()
            return u * (inv / (jj * tables.scale_sum))[..., None]

    out = torch.cat([one_q_chunk(i) for i in range(lq_p // bq)], dim=3)
    return out.reshape(b, h, lq_p, d)[:, :, :lq]


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def _device_of(q: Tensor):
    """The device a dispatch reads: ``"cuda"`` for tensors of shapes
    only (the module docstring), else the tensor's own."""
    return "cuda" if shapes_only(q) else q.device


def resolve_attention_backend(backend: str = "auto",
                              device: torch.device | str = "cuda") -> str:
    """The dense matrix of the module docstring, in code: returns
    ``'cuda'`` (the kernel), ``'naive'`` (the plain version) or
    ``'blocked'`` for tensors on ``device``."""
    device = torch.device(device)
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "naive"
    if backend == "cuda":
        if device.type != "cuda":
            raise ValueError(
                f"lut_attention backend 'cuda' needs CUDA tensors, got "
                f"{device}; use 'auto' or 'naive' on the CPU")
        return "cuda"
    if backend in ("naive", "blocked"):
        return backend
    raise ValueError(f"unknown lut_attention backend {backend!r}: expected "
                     f"'auto', 'cuda', 'naive' or 'blocked' (the port's "
                     f"'cuda' is the JAX package's 'pallas')")


def lut_attention(q: Tensor, k: Tensor, v: Tensor, policy: SoftmaxPolicy,
                  *, causal: bool = False, scale: float | None = None,
                  kv_len: Tensor | int | None = None,
                  backend: str = "auto", q_chunk: int = 512,
                  k_chunk: int = 1024) -> Tensor:
    """Attention with the policy's softmax over contiguous K/V;
    (B, H, Lq, D) f32.

    q (B, H, Lq, D); k, v (B, KVH, Lk, D).  ``kv_len`` (the valid key
    count of a pre-allocated cache) masks the tail and right-aligns the
    causal queries to it; without it REXP takes the fused α requant, as
    in the JAX package.  Dispatches per the module docstring's matrix;
    ``q_chunk`` / ``k_chunk`` size the ``blocked`` path's tiles.
    """
    route = resolve_attention_backend(backend, _device_of(q))
    if route == "blocked":
        return lut_attention_blocked(q, k, v, policy, causal=causal,
                                     scale=scale, kv_len=kv_len,
                                     q_chunk=q_chunk, k_chunk=k_chunk)
    kw = dict(scale=scale, causal=causal, index_mode=policy.index_mode,
              fused_requant=kv_len is None, kv_len=kv_len)
    if route == "naive" or policy.impl == "exact":
        return _ref.lut_attention_ref(q, k, v, method=policy.impl,
                                      tables=_tables_for(policy), **kw)
    return lut_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                              _tables_for(policy), method=policy.impl, **kw)


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


def gather_page_scales(scales: Tensor, block_tables: Tensor) -> Tensor:
    """(P, ps, KVH) scale pool + (B, mp) table → (B, KVH, mp·ps) view,
    row-aligned with :func:`gather_pages`: scale [b, n, t] dequantizes
    token row t of the gathered int8 K (or V) view."""
    b, mp = block_tables.shape
    ps, kvh = scales.shape[1], scales.shape[2]
    g = scales[block_tables.long()]             # (B, mp, ps, KVH)
    return g.permute(0, 3, 1, 2).reshape(b, kvh, mp * ps)


def check_scales(k_scales: Tensor | None, v_scales: Tensor | None) -> bool:
    """True for an int8 pool (both scale pools given), False for a
    float pool (neither); one without the other raises."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("an int8 pool needs both k_scales and v_scales")
    return k_scales is not None


def _gather_dequant(k_pages: Tensor, v_pages: Tensor, block_tables: Tensor,
                    k_scales: Tensor, v_scales: Tensor, kv_lens: Tensor):
    """int8 pool → dequantized (B, KVH, mp·ps, Dh) f32 K and V views.

    Rows at or past a slot's ``kv_lens`` become 0: the softmax gives
    them weight 0 exactly, and zeroing them keeps junk in unwritten
    pages and scales (a NaN or inf scale on the null page included) out
    of σ·V, where 0 · NaN would otherwise poison the row — the kernels
    never read those rows at all.
    """
    valid = (torch.arange(block_tables.shape[1] * k_pages.shape[1],
                          device=k_pages.device)[None, :]
             < kv_lens.to(k_pages.device).long()[:, None])
    valid = valid[:, None, :, None]                    # (B, 1, L, 1)

    def one(pages, scales):
        x = dequantize_rows(gather_pages(pages, block_tables),
                            gather_page_scales(scales, block_tables))
        return torch.where(valid, x, torch.zeros((), device=x.device))

    return one(k_pages, k_scales), one(v_pages, v_scales)


def gather_kv(k_pages: Tensor, v_pages: Tensor, block_tables: Tensor,
              kv_lens: Tensor, k_scales: Tensor | None = None,
              v_scales: Tensor | None = None):
    """The plain versions' block-table view of the pool: gathered K and V
    (B, KVH, mp·ps, Dh), dequantized for an int8 pool."""
    if check_scales(k_scales, v_scales):
        return _gather_dequant(k_pages, v_pages, block_tables, k_scales,
                               v_scales, kv_lens)
    return (gather_pages(k_pages, block_tables),
            gather_pages(v_pages, block_tables))


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


def paged_mesh_regime(mesh, n_kv_heads: int) -> str | None:
    """The mesh rows of the paged dispatch matrix (module docstring):
    ``None`` without a mesh of ``tp > 1`` (the single-device rows apply),
    ``'heads'`` when the KV-head count divides ``tp``, else ``'pages'``."""
    from repro_torch.runtime.partitioning import mesh_model_tp
    tp = mesh_model_tp(mesh)
    if tp <= 1:
        return None
    return "heads" if n_kv_heads % tp == 0 else "pages"


def _sharded(q, k_pages, v_pages, block_tables, kv_lens, policy, mesh,
             n_kv_heads, gather, **kw):
    """The mesh rows, or None when no mesh row applies."""
    if mesh is None:
        return None
    if n_kv_heads is None:
        raise ValueError("a mesh needs n_kv_heads, the arch's KV-head count "
                         "(a rank's pool holds only its share)")
    regime = paged_mesh_regime(mesh, n_kv_heads)
    if regime is None:
        return None
    from repro_torch.kernels.lut_attention import sharded_paged
    return sharded_paged.paged_attention_sharded(
        q, k_pages, v_pages, block_tables, kv_lens, policy, mesh=mesh,
        regime=regime, gather=gather, **kw)


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
    k_scales: Tensor | None = None,  # (num_pages, page_size, KVH) f32 —
    v_scales: Tensor | None = None,  # int8 pool dequant scales (or None)
    max_kv_len: int | None = None,   # host-known bound on kv_lens
    mesh=None,                       # partitioning.Mesh (tensor parallel)
    n_kv_heads: int | None = None,   # the arch's KVH (with a mesh)
    gather: bool = True,             # 'heads': q and output hold every head
    plan_kv_heads: int | None = None,  # KV heads the kernel's split plans
                                       # for (a 'heads' rank: the model's)
) -> Tensor:
    """Decode attention straight off the paged KV pool; (B, H, 1, D) f32.

    Dispatches per the module docstring's matrix: the CUDA kernel walks
    the block tables page by page (no gathered view, no logits tensor),
    its split of the keys steered by ``max_kv_len`` and
    ``plan_kv_heads``; the plain version
    gathers the block-table view and reuses
    :func:`lut_attention_decode_varlen`.  With a ``mesh`` of ``tp > 1``
    the pools are this rank's share and ``n_kv_heads`` (the arch's KV
    heads) picks the mesh row; in the ``'heads'`` row ``gather=False``
    passes and returns this rank's heads only (``shard_params``, where
    ``wo`` is split by rows).
    """
    from repro_torch.kernels.lut_attention import paged_decode
    args = (q, k_pages, v_pages, block_tables, kv_lens, policy)
    kw = dict(scale=scale, k_scales=k_scales, v_scales=v_scales)
    out = _sharded(*args, mesh, n_kv_heads, gather, backend=backend,
                   max_kv_len=max_kv_len, **kw)
    if out is not None:
        return out
    if resolve_paged_backend(backend, _device_of(q)) == "cuda":
        return paged_decode.paged_decode_attention(
            *args, **kw, max_kv_len=max_kv_len, plan_kv_heads=plan_kv_heads)
    return paged_decode.paged_decode_plain(*args, **kw)


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
    k_scales: Tensor | None = None,  # (num_pages, page_size, KVH) f32 —
    v_scales: Tensor | None = None,  # int8 pool dequant scales (or None)
    max_kv_len: int | None = None,   # host-known bound on kv_lens
    mesh=None,                       # partitioning.Mesh (tensor parallel)
    n_kv_heads: int | None = None,   # the arch's KVH (with a mesh)
    gather: bool = True,             # 'heads': q and output hold every head
    plan_kv_heads: int | None = None,  # KV heads the kernel's split plans
                                       # for (a 'heads' rank: the model's)
) -> Tensor:
    """Prefill-chunk attention reading prior keys through the block
    tables; (B, H, C, D) f32.  The chunk's K/V were already scattered
    into the pool, so the pool is the only KV storage.  Dispatches per
    the module docstring's matrix (``max_kv_len``, ``mesh``,
    ``n_kv_heads``, ``gather`` and ``plan_kv_heads`` as for decode)."""
    from repro_torch.kernels.lut_attention import paged_prefill
    args = (q, k_pages, v_pages, block_tables, q_start, kv_lens, policy)
    kw = dict(scale=scale, k_scales=k_scales, v_scales=v_scales)
    out = _sharded(q, k_pages, v_pages, block_tables, kv_lens, policy, mesh,
                   n_kv_heads, gather, q_start=q_start, backend=backend,
                   max_kv_len=max_kv_len, **kw)
    if out is not None:
        return out
    if resolve_paged_prefill_backend(backend, _device_of(q)) == "cuda":
        return paged_prefill.paged_prefill_attention(
            *args, **kw, max_kv_len=max_kv_len, plan_kv_heads=plan_kv_heads)
    return paged_prefill.paged_prefill_plain(*args, **kw)
