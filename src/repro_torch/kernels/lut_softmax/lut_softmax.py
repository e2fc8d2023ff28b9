"""Row-wise LUT softmax: the CUDA kernel's wrappers and their plain
versions.

The counterpart of the JAX package's ``kernels/lut_softmax/
lut_softmax.py`` (``rexp_softmax_pallas`` / ``lut2d_softmax_pallas``,
bodies ``_rexp_kernel`` / ``_lut2d_kernel``): REXP or 2D-LUT softmax
over the last axis of ``x`` (any leading shape; f32, bf16 or f16),
returned as f32 of ``x``'s shape.

* :func:`rexp_softmax_cuda` / :func:`lut2d_softmax_cuda` launch
  ``csrc/lut_softmax.cu`` on CUDA tensors (one block per row, the row in
  shared memory between the passes when it fits) or raise; on CPU
  tensors they run the plain version — only because the tensor lies on
  the CPU.
* :func:`rexp_softmax_plain` / :func:`lut2d_softmax_plain` compute the
  same function in plain PyTorch, bit for bit.

Both compute what the TPU kernel computes: the row max is taken over the
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

import torch

from repro_torch.core import lut_softmax as _core
from repro_torch.core.lut_builder import Lut2DTables, RexpTables
from repro_torch.kernels import build
from repro_torch.kernels.common import FLOAT_DTYPES, kernel_tables

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
    err = build.load("lut_softmax", f"lut_softmax_{method}_launch")(
        x.data_ptr(), main.data_ptr(), aux.data_ptr(), out.data_ptr(),
        FLOAT_DTYPES[x.dtype], rows, cols, n_main, aux_rows, aux_cols,
        round_mode, *floats, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lut_softmax {method} kernel launch failed: CUDA "
                           f"error {err}")
    return out


def rexp_softmax_cuda(x: Tensor, tables: RexpTables,
                      index_mode: str = "round") -> Tensor:
    """REXP row softmax over the last axis of ``x``; f32 of ``x``'s shape.
    CUDA tensors launch the kernel (or raise); CPU tensors run
    :func:`rexp_softmax_plain`."""
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
    if not x.is_cuda:
        return lut2d_softmax_plain(x, tables, index_mode)
    if x.numel() == 0:
        return torch.empty(x.shape, dtype=torch.float32, device=x.device)
    out = _launch("lut2d", x, tables, index_mode)
    lut2d_softmax_cuda.launches += 1
    return out


rexp_softmax_cuda.launches = 0
lut2d_softmax_cuda.launches = 0
