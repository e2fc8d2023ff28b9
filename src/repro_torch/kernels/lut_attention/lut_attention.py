"""Dense LUT attention: the CUDA kernel's wrapper and its plain version.

The counterpart of the JAX package's ``kernels/lut_attention/
lut_attention.py`` (``lut_attention_pallas``: ``_rowmax_kernel``,
``_sum_kernel``, then ``_rexp_av_kernel`` / ``_lut2d_av_kernel`` or the
fused ``_fused_sum_av_kernel``).  q (B, H, Lq, D) attends to contiguous
k, v (B, KVH, Lk, D) with the REXP or 2D-LUT softmax; the output is f32.

* :func:`lut_attention_cuda` launches ``csrc/lut_attention.cu`` on CUDA
  tensors through one of three routes that :func:`dense_route` names
  before the launch: ``"split"`` (the paged kernels' Hopper design over
  contiguous keys: a thread-block cluster per KV head and block of its
  query rows, the keys split across the cluster's CTAs and their warps)
  for calls of fewer than :data:`MIN_TILE_ROWS` query rows — decode steps
  and short prefill chunks — in any type; ``"tiles"`` (the tensor-core
  tile engine, 64 query rows a block) for longer bf16 calls with Dh ≤ 128
  and qmax ≤ 255; ``"rows"`` (the row engine, a block per few query
  rows) for the longer calls the tile engine does not take (f32, Dh >
  128, int16 tables).  A runtime ``kv_len`` (the
  valid length of a pre-allocated cache; the JAX kernel's static
  ``lk_valid``) masks the tail, and causal queries are right-aligned to
  it.  On CPU tensors it runs the plain version — only because the
  tensors lie on the CPU.
* :func:`lut_attention_plain` is the plain PyTorch version of the same
  function (``ref.lut_attention_ref``): the same integer LUT pipeline,
  the f32 q·k and σ·V sums in another order.

``lut_attention_cuda.launches`` counts the launches per mode:
``"rexp_fused"`` (REXP's α form), ``"rexp"`` (faithful per-element σ)
and ``"lut2d"``; ``lut_attention_cuda.route_launches`` counts them per
route.

On real CUDA tensors the wrapper calls the library directly
(:func:`_launch`, no dispatcher: a decode step's host time is the main
path's bottleneck).  A fake or meta tensor (the dry run's
``FakeTensorMode``, ``launch/cells.py``) goes through the custom
operator ``repro_torch::lut_attention_dense`` (``torch.library.
custom_op``) instead: its fake implementation gives an output of the
kernel's shape and dtype — no build, no library, no launch, no plain
version — and ``FlopCounterMode`` counts the kernel's :func:`dense_flops`
for it.  ``FlopCounterMode`` does not see a real launch; a caller that
counts a real step adds :func:`dense_flops` for each launch.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.core.lut_builder import Lut2DTables, RexpTables
from repro_torch.kernels import build
from repro_torch.kernels.common import (KERNEL_DTYPES, kernel_tables,
                                        shapes_only)
from repro_torch.kernels.lut_attention import ref as _ref

Tensor = torch.Tensor

MODES = ("rexp_fused", "rexp", "lut2d")
#: the kernel's routes, in the order of its C entry point's ``route``
ROUTES = ("rows", "tiles", "split")
#: the fewest query rows a call needs to take the tile route; fewer take
#: the split route.  A tile block owns 64 rows and takes the same time to
#: walk 1500 keys however few of them are real; the split route's time
#: grows with the rows (CUDA cores, a warp a row).  On an H100 (700 W) at
#: Whisper's cross-attention shape (B=4, H=12, 1500 keys, fused REXP,
#: bf16; chip_smoke.py phase 6's "[route]" lines) the split route took
#: 0.024 ms at 1 row, 0.037 at 4 and 0.058 at 8 against the tile route's
#: 0.062; from 9 rows (a cluster's block of up to 16, two rows a warp) it
#: took 0.070: 9 is the first row count at which the tile route wins.
MIN_TILE_ROWS = 9
#: what the tile engine takes: bf16 (f32 q·k feeds the bins, so f32 stays
#: on the CUDA cores), head dims up to 128, and numerators that bf16 holds
#: exactly (qmax ≤ 255: uint8, uint4, uint2; not int16)
TILE_DTYPES = (torch.bfloat16,)
TILE_MAX_DH = 128
TILE_MAX_QMAX = 255


def mode_of(method: str, fused_requant: bool) -> str:
    """The kernel mode a call takes: fused only for REXP, as in the JAX
    package."""
    if method not in ("rexp", "lut2d"):
        raise ValueError(f"the dense LUT kernel takes 'rexp' or 'lut2d', got "
                         f"{method!r}")
    return "rexp_fused" if method == "rexp" and fused_requant else method


def tiles_take(dtype: torch.dtype, dh: int, qmax: int) -> bool:
    """Whether the tile engine takes inputs of this type, head dim and
    precision (any number of rows)."""
    return (dtype in TILE_DTYPES and dh <= TILE_MAX_DH and dh % 8 == 0
            and qmax <= TILE_MAX_QMAX)


def dense_route(dtype: torch.dtype, dh: int, lq: int, qmax: int,
                mode: str) -> str:
    """The route a dense call takes: ``"split"`` below
    :data:`MIN_TILE_ROWS` query rows; else ``"tiles"`` when the tile
    engine takes its type, head dim and precision, ``"rows"`` when it
    does not.  Every mode takes every route."""
    if mode not in MODES:
        raise ValueError(f"unknown dense mode {mode!r}: expected one of "
                         f"{MODES}")
    if lq < MIN_TILE_ROWS:
        return "split"
    return "tiles" if tiles_take(dtype, dh, qmax) else "rows"


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


def dense_flops(q_shape, k_shape) -> int:
    """The dense kernel's FLOPs: QKᵀ and σ·V over every key of the call,
    ``4 · B · H · Lq · Lk · Dh`` — the count before the causal and
    ``kv_len`` masks (the kernel's tiles walk the masked keys' blocks
    too, up to its block edges)."""
    b, h, lq, dh = q_shape
    return 4 * b * h * lq * k_shape[2] * dh


def _launch(q: Tensor, k: Tensor, v: Tensor, main: Tensor, aux: Tensor,
            ints, floats, kv: int, causal: bool, fused: bool, route: int,
            scale: float) -> Tensor:
    """One launch of ``csrc/lut_attention.cu`` on CUDA tensors."""
    b, h, lq, dh = q.shape
    out = torch.empty((b, h, lq, dh), dtype=torch.float32, device=q.device)
    err = build.load("lut_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), main.data_ptr(),
        aux.data_ptr(), out.data_ptr(), KERNEL_DTYPES[q.dtype], b, h,
        k.shape[1], lq, k.shape[2], dh, kv, int(causal), int(fused), route,
        *ints, scale, *floats,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lut_attention kernel launch failed "
                           f"({ROUTES[route]} route): CUDA error {err}")
    return out


@torch.library.custom_op("repro_torch::lut_attention_dense", mutates_args=())
def _dense_op(q: Tensor, k: Tensor, v: Tensor, main: Tensor, aux: Tensor,
              ints: list[int], floats: list[float], kv: int, causal: bool,
              fused: bool, route: int, scale: float) -> Tensor:
    """:func:`_launch` as an operator, for fake and meta tensors."""
    return _launch(q, k, v, main, aux, ints, floats, kv, causal, fused,
                   route, scale)


@_dense_op.register_fake
def _dense_fake(q, k, v, main, aux, ints, floats, kv, causal, fused, route,
                scale):
    return q.new_empty(q.shape, dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.lut_attention_dense)
def _dense_flop_formula(q_shape, k_shape, *args, out_shape=None, **kwargs):
    return dense_flops(q_shape, k_shape)


def check_kernel_inputs(q: Tensor, k: Tensor, v: Tensor,
                        kv_len: Tensor | int | None) -> int:
    """Validate what the kernel takes; returns ``kv_len`` as an int (Lk
    when None).  Raises on anything the kernel does not take instead of
    launching on it (a tensor of shapes only has no storage to
    align)."""
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
        if not shapes_only(t) and t.data_ptr() % 16:
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
                       kv_len: Tensor | int | None = None,
                       route: str | None = None) -> Tensor:
    """Dense LUT attention; returns (B, H, Lq, D) f32.

    CUDA tensors launch the kernel on the current stream through
    ``route`` (default: :func:`dense_route`'s choice), or raise; CPU
    tensors run :func:`lut_attention_plain`.  ``fused_requant`` selects
    REXP's α form (ignored for 2D-LUT, as in the JAX package).  A forced
    ``route`` (tests and ``chip_smoke.py`` time every route on the same
    inputs; no model path passes one) that the inputs do not suit raises:
    ``"rows"`` and ``"split"`` take every input the kernel takes,
    ``"tiles"`` only those :func:`tiles_take` names, at any row count.
    The kernel has no backward: under autograd, inputs that require
    grad raise (on any device) rather than give an output that silently
    carries no gradient — evaluate under ``torch.no_grad()``.  Fake and
    meta tensors (:func:`shapes_only`) get the output's shape from the
    operator's fake implementation, and no launch is counted.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "lut_attention_cuda has no backward: its inputs require grad; "
            "train through the exact softmax (train_logits) and run the "
            "LUT policies under torch.no_grad()")
    mode = mode_of(method, fused_requant)
    qmax = tables.precision.qmax
    b, h, lq, dh = q.shape
    if route is None:
        route = dense_route(q.dtype, dh, lq, qmax, mode)
    elif route not in ROUTES:
        raise ValueError(f"unknown dense route {route!r}: expected one of "
                         f"{ROUTES}")
    elif route == "tiles" and not tiles_take(q.dtype, dh, qmax):
        raise ValueError(f"the tile route takes bfloat16 with Dh ≤ "
                         f"{TILE_MAX_DH} (a multiple of 8) and qmax ≤ "
                         f"{TILE_MAX_QMAX}; got {q.dtype}, Dh={dh}, "
                         f"qmax={qmax}")
    fake = shapes_only(q)
    if not q.is_cuda and not fake:
        return _ref.lut_attention_ref(q, k, v, method=method, tables=tables,
                                      scale=scale, causal=causal,
                                      index_mode=index_mode,
                                      fused_requant=fused_requant,
                                      kv_len=kv_len)
    kv = check_kernel_inputs(q, k, v, kv_len)
    scale = scale if scale is not None else dh ** -0.5
    if fake:
        none = q.new_empty((0,), dtype=torch.int32)
        return _dense_op(q, k, v, none, none, [0] * 5, [0.0] * 4, kv,
                         causal, mode == "rexp_fused", ROUTES.index(route),
                         scale)
    main, aux, ints, floats = kernel_tables(method, tables, index_mode,
                                            q.device)
    out = _launch(q, k, v, main, aux, ints, floats, kv, causal,
                  mode == "rexp_fused", ROUTES.index(route), scale)
    lut_attention_cuda.launches[mode] += 1
    lut_attention_cuda.route_launches[route] += 1
    return out


lut_attention_cuda.launches = dict.fromkeys(MODES, 0)
lut_attention_cuda.route_launches = dict.fromkeys(ROUTES, 0)


def kernel_spec(geom):
    """Static declaration for ``repro_torch.analysis.kernel_guard``: the
    launch :func:`dense_route` picks for a ``geom["lq"]``-row call over
    ``geom["lk"]`` keys (all valid), for f32 and bf16 inputs and each
    mode (each method's largest tables), from the kernel's own plan
    (``csrc/launch_plan.h``): a split launch is planned to run in one
    wave; the rows and tiles routes put a query head on each grid row."""
    from repro_torch.analysis.kernel_guard import (N_SMS, Coverage,
                                                   KernelSpec, Operand,
                                                   launch_of, method_tables)
    b, h, kvh, dh = geom["b"], geom["h"], geom["kvh"], geom["dh"]
    lq, lk = geom["lq"], geom["lk"]
    launches = []
    for dtype, dname in ((torch.float32, "float32"),
                         (torch.bfloat16, "bfloat16")):
        for mode in MODES:
            method = "lut2d" if mode == "lut2d" else "rexp"
            route = dense_route(dtype, dh, lq, 255, mode)
            main, ar, ac = method_tables(method)
            plan = build.host_plan("lut_attention", [
                ROUTES.index(route), KERNEL_DTYPES[dtype], b, h, kvh, lq,
                lk, dh, lk, int(mode == "rexp_fused"), main, ar, ac, N_SMS])
            if plan is None:
                raise ValueError(f"lut_attention: the launcher refuses "
                                 f"{route} at {dict(geom)}")
            split = route == "split"
            cov = (Coverage(rows=h // kvh * lq, kvh=kvh,
                            rpb=plan["rows_per_block"],
                            units=max(-(-lk // 32), 1)) if split else
                   Coverage(rows=lq, kvh=h, rpb=plan["rows_per_block"],
                            flat=True))
            launches.append(launch_of(
                f"{dname}/{mode}/{route}", plan,
                inputs=(Operand("q", (b, h, lq, dh), dname),
                        Operand("k", (b, kvh, lk, dh), dname),
                        Operand("v", (b, kvh, lk, dh), dname)),
                outputs=(Operand("out", (b, h, lq, dh)),), coverage=cov,
                sigma_acc=True, acc_dtype="float32", one_wave=split))
    return KernelSpec(name="lut_attention", module=__name__, kind="cuda",
                      launches=tuple(launches))
