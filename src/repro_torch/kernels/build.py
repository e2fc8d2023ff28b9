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

#: kernel name → (C entry point, its argument types); the stream is last.
KERNELS = {
    "paged_decode": ("paged_decode_launch",
                     [_P] * 8 + [_I] * 13 + [_F] * 5 + [_P]),
    "paged_prefill": ("paged_prefill_launch",
                      [_P] * 9 + [_I] * 14 + [_F] * 5 + [_P]),
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
    up to date), "log": nvcc's output (ptxas register/smem report)}``.
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
    report = {name: {"seconds": 0.0, "log": ""} for name in names}
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str):
    """The C entry point of kernel ``name``, built if needed, with its
    ``argtypes`` set (a pointer passed as a bare int would be cut to 32
    bits)."""
    lib = _loaded.get(name)
    if lib is None:
        if _stale(name):
            build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        fn_name, argtypes = KERNELS[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = lib
    return getattr(lib, KERNELS[name][0])
