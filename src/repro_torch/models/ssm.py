"""State-space and recurrent mixers: Mamba (Jamba's) and xLSTM's mLSTM and
sLSTM.

The counterpart of the JAX package's ``models/ssm.py`` for the lockstep
serving path: the same parameter leaves, shapes and semantics, and the
same three modes for each mixer —

  * no cache — the full sequence from a zero state;
  * a cache and S > 1 — a prefill: the recurrence starts from the
    cache's state (Mamba's depthwise conv from zeros, as the JAX
    package's padded conv does) and the final state (and Mamba's conv
    tail) is written back;
  * a cache and S == 1 — one decode step (Mamba's conv over the cached
    tail and the new token).

The caches (:class:`MambaCache`, :class:`MLSTMCache`,
:class:`SLSTMCache`) are small dataclasses of tensors updated in place,
as ``layers.AttnCache`` is.  No softmax runs here: the paper's LUT
softmax does not apply to these mixers.

The JAX package scans the recurrences in chunks (an associative scan
within a Mamba chunk; remat boundaries for training).  Here each runs as
a loop over the time steps on the ``(B, DI, N)`` / ``(B, H, dh, dh)``
state, which never builds a whole chunk's per-step tensors: the same
recurrence summed in another order, so the results agree with the JAX
package's at any chunk size up to roundoff.  As there, the decay and
drive, the gates and the state updates run in f32 from f32 masters, the
depthwise conv sums in the activation dtype and every projection casts
its weight to the activation dtype.

Under a scope whose weights are a rank's cut (``partitioning.Layout``:
training, lockstep serving on a mesh) Mamba is channel-parallel when
``'model'`` divides its channels: a rank computes its ``DI / tp``
channels end to end — ``in_proj``'s ``x`` and ``z`` columns, the conv,
``dt_proj``, ``a_log``, ``d_skip`` and the state ``h`` (B, DI / tp, N) —
and the row partials of ``x_proj`` (the per-token Δ, B, C) and of
``out_proj`` are summed over ``'model'``.  The conv tail, which the JAX
package's cache holds whole, stays whole on every rank: the new inputs'
channels are gathered into it.  The mLSTM and sLSTM compute every
channel (their weights gathered just before use); a state the cache
holds cut over ``'model'`` (its heads, or a conv tail's taps, where
``'model'`` divides them) is gathered before the step and the rank's
part written back after it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init
from repro_torch.runtime import partitioning as PT

Tensor = torch.Tensor
Params = dict[str, Any]


# ---------------------------------------------------------------------------
# Mamba (selective SSM) — Jamba's majority mixer
# ---------------------------------------------------------------------------

D_STATE = 16
D_CONV = 4
EXPAND = 2


@dataclasses.dataclass
class MambaCache:
    """A Mamba layer's decode state: ``h`` (B, DI, N) f32, the SSM state;
    ``conv`` (B, D_CONV − 1, DI) in the activation dtype, the last
    inputs of the depthwise conv."""

    h: Tensor
    conv: Tensor

    @staticmethod
    def zeros(b: int, d_model: int, dtype, device) -> "MambaCache":
        d_inner = EXPAND * d_model
        return MambaCache(
            h=torch.zeros((b, d_inner, D_STATE), dtype=torch.float32,
                          device=device),
            conv=torch.zeros((b, D_CONV - 1, d_inner), dtype=dtype,
                             device=device))


def init_mamba(d_model: int, generator: torch.Generator, device) -> Params:
    """Random f32 leaves in the JAX package's layout: ``in_proj`` (D, 2DI),
    ``conv_w`` (K, DI), ``conv_b`` (DI,), ``x_proj`` (DI, R + 2N),
    ``dt_proj`` (R, DI), ``dt_bias`` (DI,) — softplus⁻¹ of a log-uniform
    step in [1e-3, 1e-1] — ``a_log`` (DI, N) = log(1..N) (S4D-real),
    ``d_skip`` (DI,) ones and ``out_proj`` (DI, D)."""
    d_inner = EXPAND * d_model
    dt_rank = max(1, math.ceil(d_model / 16))
    u = torch.empty((d_inner,), dtype=torch.float32, device=device)
    u.uniform_(math.log(1e-3), math.log(1e-1), generator=generator)
    a_init = torch.arange(1, D_STATE + 1, dtype=torch.float32,
                          device=device)[None, :].repeat(d_inner, 1)
    return {
        "in_proj": dense_init((d_model, 2 * d_inner), generator, device),
        "conv_w": dense_init((D_CONV, d_inner), generator, device,
                             in_axis_size=D_CONV),
        "conv_b": torch.zeros((d_inner,), dtype=torch.float32,
                              device=device),
        "x_proj": dense_init((d_inner, dt_rank + 2 * D_STATE), generator,
                             device, in_axis_size=d_inner),
        "dt_proj": dense_init((dt_rank, d_inner), generator, device,
                              in_axis_size=dt_rank),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))),
        "a_log": torch.log(a_init),
        "d_skip": torch.ones((d_inner,), dtype=torch.float32, device=device),
        "out_proj": dense_init((d_inner, d_model), generator, device,
                               in_axis_size=d_inner),
    }


def _row_product(a: Tensor, w: Tensor, mesh, site: str) -> Tensor:
    """``a @ w`` in ``a.dtype``, the weight cast to it.  With a ``mesh``
    ``a`` holds the rank's channels and ``w`` their rows: the partial
    products of the same operands are taken in f32, summed over
    ``'model'`` in f32 and rounded once, as the whole product is."""
    w = w.to(a.dtype)
    if mesh is None:
        return a @ w
    return PT.reduce_from(a.float() @ w.float(), mesh, site=site).to(a.dtype)


def _mamba_ssm_inputs(p: Params, xc: Tensor, mesh=None):
    """Per-token SSM tensors from the post-conv activations xc (B, S, DI):
    ``delta`` (B, S, DI), ``bmat`` and ``cmat`` (B, S, N), all f32.  With
    a ``mesh`` xc holds the rank's channels, ``x_proj`` its rows: the
    partial products are summed over ``'model'`` (:func:`_row_product`),
    and as each rank's channels read the sum, its gradient is summed
    there too."""
    dt_rank = p["dt_proj"].shape[0]
    proj = _row_product(xc, p["x_proj"], mesh, "x_proj").float()
    proj = PT.copy_to(proj, mesh, site="x_proj")
    dt, bmat, cmat = torch.split(proj, [dt_rank, D_STATE, D_STATE], dim=-1)
    delta = F.softplus(dt @ p["dt_proj"].float() + p["dt_bias"].float())
    return delta, bmat, cmat


def _causal_depthwise_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """x (B, S, DI); w (K, DI): the depthwise causal conv along S from a
    zero history, summed tap by tap in ``x.dtype``."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:s] * w[0].to(x.dtype)
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def _held(t: Tensor, whole: int, mesh) -> Tensor:
    """A state leaf with its dim 1 whole: ``t`` itself, or gathered over
    ``'model'`` when the cache holds the rank's cut of ``whole``."""
    if mesh is None or t.shape[1] == whole:
        return t
    return PT.all_gather(t, mesh, 1, site="state_gather")


def _put(dst: Tensor, src: Tensor, mesh) -> None:
    """Write the whole-in-dim-1 state ``src`` into the cache leaf
    ``dst``: all of it, or the rank's part where ``dst`` holds a cut."""
    if dst.shape[1] != src.shape[1]:
        n = dst.shape[1]
        src = src[:, mesh.rank * n:(mesh.rank + 1) * n]
    dst.copy_(src)


def apply_mamba(p: Params, x: Tensor, *, cache: MambaCache | None = None,
                path: str = "") -> Tensor:
    """Mamba block of x (B, S, D) → (B, S, D) in ``x.dtype``; the modes of
    the module docstring, ``cache`` updated in place; channel-parallel
    under a scope that computes on the channels' cut of the mixer at
    ``path`` (``periods/<i>/mixer``; module docstring)."""
    b, s, d = x.shape
    d_inner = EXPAND * d
    mesh = PT.active_scope().model_mesh(f"{path}/in_proj")
    di = d_inner // (mesh.tp if mesh is not None else 1)
    lo = mesh.rank * di if mesh is not None else 0
    xin = PT.copy_to(x, mesh, site="mamba.in")
    xz = xin @ p["in_proj"].to(x.dtype)
    xr, z = torch.split(xz, di, dim=-1)
    conv = (_held(cache.conv, D_CONV - 1, PT.active_mesh())
            if cache is not None else None)
    if cache is not None and s == 1:
        # decode: the conv over the cached tail and the new token, as the
        # JAX package's einsum — exact products, an f32 sum, one cast
        conv_buf = torch.cat([conv[..., lo:lo + di], xr], dim=1)
        xc = (conv_buf.float() * p["conv_w"].to(x.dtype).float()).sum(
            1, keepdim=True).to(x.dtype) + p["conv_b"].to(x.dtype)
    else:
        xc = _causal_depthwise_conv(xr, p["conv_w"], p["conv_b"])
    xc = F.silu(xc.float()).to(x.dtype)
    delta, bmat, cmat = _mamba_ssm_inputs(p, xc, mesh)
    x32 = xc.float()
    a = -torch.exp(p["a_log"].float())                           # (DI, N)
    h = (cache.h if cache is not None else
         torch.zeros((b, di, D_STATE), dtype=torch.float32,
                     device=x.device))
    ys = []
    for t in range(s):
        # h ← exp(Δ·A) ⊙ h + (Δ·x) ⊗ B on the (B, DI, N) state; y = h · C
        dt = delta[:, t]
        h = torch.exp(dt[..., None] * a) * h + (dt * x32[:, t])[..., None] \
            * bmat[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cmat[:, t]))
    if cache is not None:
        cache.h.copy_(h)
        tail = xr[:, 1 - D_CONV:]
        if mesh is not None:      # the tail's every channel, on every rank
            tail = PT.all_gather(tail, mesh, 2, site="conv_tail")
        _put(cache.conv, torch.cat([conv, tail], dim=1)[:, 1 - D_CONV:],
             PT.active_mesh())
    y = torch.stack(ys, dim=1) + p["d_skip"].float() * x32
    out = y.to(x.dtype) * F.silu(z.float()).to(x.dtype)
    return _row_product(out, p["out_proj"], mesh, "mamba.out")


# ---------------------------------------------------------------------------
# xLSTM — mLSTM (matrix memory) and sLSTM (scalar memory, recurrent weights)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MLSTMCache:
    """An mLSTM layer's state, all f32: the matrix memory ``c``
    (B, H, dh, dh), the normaliser ``n`` (B, H, dh) and the stabiliser
    ``m`` (B, H)."""

    c: Tensor
    n: Tensor
    m: Tensor

    @staticmethod
    def zeros(b: int, d_model: int, n_heads: int, device) -> "MLSTMCache":
        dh = d_model // n_heads
        z = dict(dtype=torch.float32, device=device)
        return MLSTMCache(c=torch.zeros((b, n_heads, dh, dh), **z),
                          n=torch.zeros((b, n_heads, dh), **z),
                          m=torch.zeros((b, n_heads), **z))


def init_mlstm(d_model: int, n_heads: int, generator: torch.Generator,
               device) -> Params:
    """``up_proj`` (D, 2D), ``wq`` / ``wk`` / ``wv`` (D, D), the gate
    projections ``w_igate`` / ``w_fgate`` (D, H), ``fgate_bias`` (H,)
    threes and ``down_proj`` (D, D), f32."""
    def w(shape):
        return dense_init(shape, generator, device)
    return {
        "up_proj": w((d_model, 2 * d_model)),
        "wq": w((d_model, d_model)),
        "wk": w((d_model, d_model)),
        "wv": w((d_model, d_model)),
        "w_igate": w((d_model, n_heads)),
        "w_fgate": w((d_model, n_heads)),
        "fgate_bias": torch.full((n_heads,), 3.0, dtype=torch.float32,
                                 device=device),
        "down_proj": w((d_model, d_model)),
    }


def _mlstm_cell(c, n, m, q, k, v, ig, fg):
    """One mLSTM step with the exponential input gate stabilised by ``m``:
    ``m' = max(log σ(f) + m, i)``, the memory decayed by
    ``exp(log σ(f) + m − m')`` and written with ``exp(i − m')·v kᵀ``; the
    read-out ``C q / max(|n·q|, 1)`` (B, H, dh)."""
    logf = F.logsigmoid(fg)
    m_new = torch.maximum(logf + m, ig)
    fprime = torch.exp(logf + m - m_new)[..., None]
    iprime = torch.exp(ig - m_new)[..., None]
    c = c * fprime[..., None] + iprime[..., None] * v[..., :, None] \
        * k[..., None, :]
    n = n * fprime + iprime * k
    denom = torch.clamp(torch.abs(torch.sum(n * q, dim=-1, keepdim=True)),
                        min=1.0)
    h = torch.einsum("bhij,bhj->bhi", c, q) / denom
    return c, n, m_new, h


def apply_mlstm(p: Params, x: Tensor, *, n_heads: int,
                cache: MLSTMCache | None = None) -> Tensor:
    """mLSTM block of x (B, S, D) → (B, S, D) in ``x.dtype`` (exponential
    gating, matrix memory); ``cache`` updated in place."""
    b, s, d = x.shape
    dh = d // n_heads
    up = x @ p["up_proj"].to(x.dtype)
    xm, z = torch.split(up, d, dim=-1)

    def heads(w):
        return (xm @ w.to(x.dtype)).reshape(b, s, n_heads, dh).float()

    q = heads(p["wq"]) * dh ** -0.5
    k = heads(p["wk"]) * dh ** -0.5
    v = heads(p["wv"])
    xm32 = xm.float()
    ig = xm32 @ p["w_igate"].float()                              # (B,S,H)
    fg = xm32 @ p["w_fgate"].float() + p["fgate_bias"].float()
    state = cache if cache is not None else MLSTMCache.zeros(
        b, d, n_heads, x.device)
    mesh = PT.active_mesh()
    c, n, m = (_held(t, n_heads, mesh) for t in (state.c, state.n, state.m))
    hs = []
    for t in range(s):
        c, n, m, h = _mlstm_cell(c, n, m, q[:, t], k[:, t], v[:, t],
                                 ig[:, t], fg[:, t])
        hs.append(h)
    if cache is not None:
        for name, t in (("c", c), ("n", n), ("m", m)):
            _put(getattr(cache, name), t, mesh)
    h = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    out = h * F.silu(z.float()).to(x.dtype)
    return out @ p["down_proj"].to(x.dtype)


@dataclasses.dataclass
class SLSTMCache:
    """An sLSTM layer's state, each (B, H, dh) f32: the cell ``c``, the
    normaliser ``n``, the output ``h`` (the recurrent input) and the
    stabiliser ``m`` (per element, not per head)."""

    c: Tensor
    n: Tensor
    h: Tensor
    m: Tensor

    @staticmethod
    def zeros(b: int, d_model: int, n_heads: int, device) -> "SLSTMCache":
        shape = (b, n_heads, d_model // n_heads)
        return SLSTMCache(*(torch.zeros(shape, dtype=torch.float32,
                                        device=device) for _ in range(4)))


def init_slstm(d_model: int, n_heads: int, generator: torch.Generator,
               device) -> Params:
    """``w_in`` (D, 4D) — the z, i, f, o pre-activations — the
    block-diagonal recurrent weights ``r_z`` / ``r_i`` / ``r_f`` /
    ``r_o`` (H, dh, dh), input index first, ``fgate_bias`` (D,) threes
    and ``out_proj`` (D, D), f32."""
    dh = d_model // n_heads

    def rec():
        return dense_init((n_heads, dh, dh), generator, device,
                          in_axis_size=dh)
    return {
        "w_in": dense_init((d_model, 4 * d_model), generator, device),
        "r_z": rec(), "r_i": rec(), "r_f": rec(), "r_o": rec(),
        "fgate_bias": torch.full((d_model,), 3.0, dtype=torch.float32,
                                 device=device),
        "out_proj": dense_init((d_model, d_model), generator, device),
    }


def _slstm_cell(p, c, n, h, m, zt, it, ft, ot):
    """One sLSTM step: the gates' pre-activations plus the recurrent
    contraction ``einsum("bhj,hji->bhi", h, r)`` of the previous output,
    the input gate stabilised per element by ``m``."""
    def rec(name):
        return torch.einsum("bhj,hji->bhi", h, p[name].float())
    zt = torch.tanh(zt + rec("r_z"))
    it = it + rec("r_i")
    ft = ft + rec("r_f")
    ot = torch.sigmoid(ot + rec("r_o"))
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    fprime = torch.exp(logf + m - m_new)
    iprime = torch.exp(it - m_new)
    c = fprime * c + iprime * zt
    n = fprime * n + iprime
    h = ot * c / torch.clamp(n, min=1.0)
    return c, n, h, m_new


def apply_slstm(p: Params, x: Tensor, *, n_heads: int,
                cache: SLSTMCache | None = None) -> Tensor:
    """sLSTM block of x (B, S, D) → (B, S, D) in ``x.dtype`` (a true
    recurrence through block-diagonal recurrent weights); ``cache``
    updated in place."""
    b, s, d = x.shape
    dh = d // n_heads
    pre = (x @ p["w_in"].to(x.dtype)).float()
    zx, ix, fx, ox = (t.reshape(b, s, n_heads, dh)
                      for t in torch.split(pre, d, dim=-1))
    fx = fx + p["fgate_bias"].float().reshape(n_heads, dh)
    state = cache if cache is not None else SLSTMCache.zeros(
        b, d, n_heads, x.device)
    mesh = PT.active_mesh()
    c, n, h, m = (_held(t, n_heads, mesh)
                  for t in (state.c, state.n, state.h, state.m))
    hs = []
    for t in range(s):
        c, n, h, m = _slstm_cell(p, c, n, h, m, zx[:, t], ix[:, t],
                                 fx[:, t], ox[:, t])
        hs.append(h)
    if cache is not None:
        for name, t in (("c", c), ("n", n), ("h", h), ("m", m)):
            _put(getattr(cache, name), t, mesh)
    out = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    return out @ p["out_proj"].to(x.dtype)
