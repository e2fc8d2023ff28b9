"""Row-wise LUT softmax: the CUDA kernel's wrappers and their plain
versions.

The counterpart of the JAX package's ``kernels/lut_softmax/
lut_softmax.py`` (``rexp_softmax_pallas`` / ``lut2d_softmax_pallas``,
bodies ``_rexp_kernel`` / ``_lut2d_kernel``): REXP or 2D-LUT softmax
over the last axis of ``x`` (any leading shape; f32, bf16 or f16),
returned as f32 of ``x``'s shape.

* :func:`rexp_softmax_cuda` / :func:`lut2d_softmax_cuda` launch
  ``csrc/lut_softmax.cu`` on CUDA tensors or raise; on CPU tensors they
  run the plain version — only because the tensor lies on the CPU.
  :func:`row_plan` picks the launch on the host: a persistent grid, and
  a warp a row with the row in registers (route ``"warp"``, up to
  ``32 · PER_LANE[-1]`` columns) or a CTA a row (route ``"cta"``, the
  row staged in shared memory by a TMA bulk copy when it is 16-byte
  aligned and fits, else re-read from L2), with vectors as wide as the
  pointers and the row length allow.
* :func:`rexp_softmax_plain` / :func:`lut2d_softmax_plain` compute the
  same function in plain PyTorch, bit for bit.

Both compute what the TPU kernel computes, and the kernel is bitwise
the plain version while ``cols · qmax < 2**24`` (the integer Σ is exact
in any order below it; past it the reference's own f32 sum depends on
its order): the row max is taken over the
*finite* entries (0 when none is), and every non-finite entry gives a
hard 0.  ``core.lut_softmax`` — and so ``make_softmax_fn`` — takes the
max over every entry, as the JAX package's ``core`` does, so a row
holding ``+inf`` or ``NaN`` gets a max of 0 there and other values than
here; rows of finite and ``−inf`` entries (every row an attention mask
makes) agree in both.  The plain version is therefore ``core``'s
function on ``x`` with its non-finite entries set to ``−inf``.

``rexp_softmax_cuda.launches`` and ``lut2d_softmax_cuda.launches`` count
the kernel launches.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core import lut_softmax as _core
from repro_torch.core.lut_builder import Lut2DTables, RexpTables
from repro_torch.kernels import build
from repro_torch.kernels.common import (FLOAT_DTYPES, kernel_tables,
                                        shapes_only)

Tensor = torch.Tensor


def _finite_only(x: Tensor) -> Tensor:
    """``x`` as f32 with every non-finite entry set to ``−inf``, so that
    ``core``'s row max is the max over the finite entries."""
    x = x.float()
    return torch.where(torch.isfinite(x), x, torch.full_like(x, -torch.inf))


def rexp_softmax_plain(x: Tensor, tables: RexpTables,
                       index_mode: str = "round") -> Tensor:
    """The plain PyTorch version of the REXP row kernel."""
    return _core.softmax_rexp(_finite_only(x), tables, axis=-1,
                              index_mode=index_mode)


def lut2d_softmax_plain(x: Tensor, tables: Lut2DTables,
                        index_mode: str = "round") -> Tensor:
    """The plain PyTorch version of the 2D-LUT row kernel."""
    return _core.softmax_lut2d(_finite_only(x), tables, axis=-1,
                               index_mode=index_mode)


#: The row kernel's routes, by their C number.
ROUTES = ("warp", "cta")
#: The warp route's register buckets (elements a lane holds, a template
#: argument of the kernel): a row of up to 32 · E columns takes bucket E.
PER_LANE = (48, 64)
#: Threads a CTA on each route, and the blocks an SM is to hold (the
#: kernels' ``__launch_bounds__``): the grid is SMs × blocks.
WARP_THREADS, CTA_THREADS = 256, 512
WARP_BLOCKS, CTA_BLOCKS = 2, 2
#: The warp route copies each warp's next row into shared memory ahead
#: of use for elements of up to this many bytes (16-bit inputs).
PREFETCH_MAX_ESIZE = 2
#: Shared memory a CTA may take, and an SM holds (1 KB of it reserved
#: for each CTA), on the H100.
SMEM_LIMIT, SMEM_PER_SM = 232448, 233472
#: The cta route's shared memory before the tables: two mbarriers and
#: two per-warp reduction arrays of 32 floats.
CTA_HEAD = 16 + 2 * 32 * 4


class RowPlan(NamedTuple):
    """One launch of the row kernel: ``route`` (an entry of
    :data:`ROUTES`), ``vec`` (elements a load: 1, 4 or 8), ``per_lane``
    (the warp route's register bucket), ``stages`` (the cta route's row
    buffers in shared memory: 0 re-reads the row), ``grid``,
    ``threads`` and ``smem`` (bytes)."""
    route: str
    vec: int
    per_lane: int
    stages: int
    grid: int
    threads: int
    smem: int


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def table_bytes(n_main: int, n_aux: int) -> int:
    """Shared memory of the kernel's tables: the main table (``n_main``
    entries) replicated across the 32 banks, the aux table (``n_aux``)
    once, all as f32."""
    return 4 * (32 * n_main + n_aux)


def row_plan(rows: int, cols: int, esize: int, x_ptr: int, out_ptr: int,
             n_sms: int, n_main: int, n_aux: int) -> RowPlan:
    """The launch of the row kernel over ``rows`` × ``cols`` elements of
    ``esize`` bytes at address ``x_ptr`` into f32 at ``out_ptr``, on a
    card of ``n_sms`` SMs, with a main table of ``n_main`` entries and an
    aux table of ``n_aux``.

    The vector is the widest of 8, 4 and 1 elements (at most 16 bytes)
    whose loads and f32 stores every row's alignment allows: it divides
    ``cols`` and both pointers' alignment (a misaligned vector access
    faults on the card).  Rows of up to ``32 · PER_LANE[-1]`` columns
    take the warp route, in the smallest register bucket that holds
    them, with a buffer a warp in shared memory for its next row for
    16-bit inputs when a vector is 4 bytes or more; longer rows the cta
    route, staged in shared memory (two buffers where two fit) when a
    vector is 16 bytes."""
    vec = next(v for v in (8, 4, 1)
               if v * esize <= 16 and cols % v == 0
               and x_ptr % (v * esize) == 0
               and out_ptr % min(16, 4 * v) == 0)
    tables = _round16(table_bytes(n_main, n_aux))
    if cols <= 32 * PER_LANE[-1]:
        per_lane = next(e for e in PER_LANE if 32 * e >= cols)
        warps = WARP_THREADS // 32
        # each warp's next row, copied into shared memory ahead of use
        # by vectors of 4 bytes or more
        stage = (_round16(cols * esize)
                 if esize <= PREFETCH_MAX_ESIZE and vec * esize >= 4 else 0)
        return RowPlan("warp", vec, per_lane, 0,
                       max(1, min(-(-rows // warps), n_sms * WARP_BLOCKS)),
                       WARP_THREADS, tables + warps * stage)
    fixed = CTA_HEAD + tables
    row_bytes = cols * esize
    stages = 0
    if vec * esize == 16:
        stages = next((s for s in (2, 1) if fixed + s * row_bytes
                       <= SMEM_LIMIT), 0)
    smem = fixed + stages * row_bytes
    blocks = max(1, min(CTA_BLOCKS, SMEM_PER_SM // (smem + 1024)))
    return RowPlan("cta", vec, 0, stages, max(1, min(rows, n_sms * blocks)),
                   CTA_THREADS, smem)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def plan_for(x: Tensor, out: Tensor, main: Tensor, aux: Tensor) -> RowPlan:
    """:func:`row_plan` for contiguous CUDA ``x`` into ``out`` with the
    tables ``main`` and ``aux``."""
    cols = x.shape[-1]
    return row_plan(x.numel() // cols, cols, x.element_size(), x.data_ptr(),
                    out.data_ptr(), _sm_count(x.device.index), main.numel(),
                    aux.numel())


def _launch(method: str, x: Tensor, tables, index_mode: str) -> Tensor:
    """Launch the row kernel of ``method`` on CUDA tensor ``x``; raises on
    what the kernel does not take and on a failed launch."""
    if x.dtype not in FLOAT_DTYPES:
        raise TypeError(f"the row-wise LUT softmax kernel takes float32, "
                        f"bfloat16 or float16, got {x.dtype}")
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"the kernel needs at least one column, got shape "
                         f"{tuple(x.shape)}")
    x = x.contiguous()
    cols = x.shape[-1]
    rows = x.numel() // cols
    if rows >= 1 << 31:
        raise ValueError(f"{rows} rows exceed the kernel's grid")
    main, aux, ints, floats = kernel_tables(method, tables, index_mode,
                                            x.device)
    n_main, aux_rows, aux_cols, _, round_mode = ints
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    plan = plan_for(x, out, main, aux)
    err = build.load("lut_softmax", f"lut_softmax_{method}_launch")(
        x.data_ptr(), main.data_ptr(), aux.data_ptr(), out.data_ptr(),
        FLOAT_DTYPES[x.dtype], rows, cols, n_main, aux_rows, aux_cols,
        round_mode, *floats, ROUTES.index(plan.route), *plan[1:],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lut_softmax {method} kernel launch failed: CUDA "
                           f"error {err}")
    return out


def rexp_softmax_cuda(x: Tensor, tables: RexpTables,
                      index_mode: str = "round") -> Tensor:
    """REXP row softmax over the last axis of ``x``; f32 of ``x``'s shape.
    CUDA tensors launch the kernel (or raise); CPU tensors run
    :func:`rexp_softmax_plain`."""
    if shapes_only(x):
        return torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if not x.is_cuda:
        return rexp_softmax_plain(x, tables, index_mode)
    if x.numel() == 0:
        return torch.empty(x.shape, dtype=torch.float32, device=x.device)
    out = _launch("rexp", x, tables, index_mode)
    rexp_softmax_cuda.launches += 1
    return out


def lut2d_softmax_cuda(x: Tensor, tables: Lut2DTables,
                       index_mode: str = "round") -> Tensor:
    """2D-LUT row softmax over the last axis of ``x``; f32 of ``x``'s
    shape.  CUDA tensors launch the kernel (or raise); CPU tensors run
    :func:`lut2d_softmax_plain`."""
    if shapes_only(x):
        return torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if not x.is_cuda:
        return lut2d_softmax_plain(x, tables, index_mode)
    if x.numel() == 0:
        return torch.empty(x.shape, dtype=torch.float32, device=x.device)
    out = _launch("lut2d", x, tables, index_mode)
    lut2d_softmax_cuda.launches += 1
    return out


rexp_softmax_cuda.launches = 0
lut2d_softmax_cuda.launches = 0
