"""Build the CUDA kernels under ``csrc/`` and load them through ctypes.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` into
``build/kernels/lib<name>.so`` at the repository root (a plain C
interface, no PyTorch headers, so a build takes seconds), the first time
a kernel is needed or when a source is newer than its library.
:func:`build` starts one ``nvcc`` per stale source and waits for them
all.  A kernel that fails to build raises: nothing falls back.

The loaded libraries are cached for the life of the process, as the
dynamic loader itself would.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: kernel name (one library each) → {C entry point: its argument types};
#: the stream is last.  For the paged kernels ``<name>_launch`` takes
#: f32/bf16 pools, ``<name>_int8_launch`` int8 pools plus their two f32
#: scale pools, both the caller's bound on the live lengths and the KV
#: heads the split is planned for (two ints, 0 for none: the block
#: table's width, the call's own heads) before the stream; the dense
#: kernel takes contiguous f32/bf16 q, k, v; the row-wise softmax has one
#: entry point per method and the exact flash attention one, both over
#: contiguous f32/bf16/f16 inputs; the row one takes its launch plan
#: (``lut_softmax.row_plan``, seven ints) before the stream.  The dense
#: and flash entry points take their route (an int) after their flags;
#: flash takes its valid length after the scale (an int, and a pointer to
#: B int32 lengths or null).
KERNELS = {
    "paged_decode": {
        "paged_decode_launch": [_P] * 8 + [_I] * 13 + [_F] * 5 + [_I, _I, _P],
        "paged_decode_int8_launch": [_P] * 10 + [_I] * 13 + [_F] * 5
        + [_I, _I, _P],
    },
    "paged_prefill": {
        "paged_prefill_launch": [_P] * 9 + [_I] * 14 + [_F] * 5
        + [_I, _I, _P],
        "paged_prefill_int8_launch": [_P] * 11 + [_I] * 14 + [_F] * 5
        + [_I, _I, _P],
    },
    "lut_attention": {
        "lut_attention_launch": [_P] * 6 + [_I] * 16 + [_F] * 5 + [_P],
    },
    "lut_softmax": {
        "lut_softmax_rexp_launch": [_P] * 4 + [_I] * 7 + [_F] * 4
        + [_I] * 7 + [_P],
        "lut_softmax_lut2d_launch": [_P] * 4 + [_I] * 7 + [_F] * 4
        + [_I] * 7 + [_P],
    },
    "flash_attention": {
        "flash_attention_launch": [_P] * 6 + [_I] * 9 + [_F] + [_I, _P, _P],
    },
}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_nvcc = Path("/usr/local/cuda/bin/nvcc")
    if cuda_nvcc.exists():
        return str(cuda_nvcc)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in
                 [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def build(names=tuple(KERNELS), force: bool = False) -> dict[str, dict]:
    """Compile the named kernels, all ``nvcc`` processes at once.

    Returns ``name → {"seconds": wall seconds of its nvcc (0 if it was
    up to date), "log": nvcc's output (ptxas register/smem report),
    "entries": the library's C entry points}``.
    Raises ``RuntimeError`` with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc() if any(force or _stale(n) for n in names) else None
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        if not (force or _stale(name)):
            continue
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    report = {name: {"seconds": 0.0, "log": "",
                     "entries": sorted(KERNELS[name])} for name in names}
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        report[name].update(seconds=time.perf_counter() - t0, log=log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str, entry: str | None = None):
    """C entry point ``entry`` (default ``<name>_launch``) of kernel
    ``name``, built if needed, with its ``argtypes`` set (a pointer passed
    as a bare int would be cut to 32 bits)."""
    lib = _loaded.get(name)
    if lib is None:
        if _stale(name):
            build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        for fn_name, argtypes in KERNELS[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return getattr(lib, entry or f"{name}_launch")
