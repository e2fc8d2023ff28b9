"""Build the CUDA kernels under ``csrc/`` and load them through ctypes.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` into
``build/kernels/lib<name>.so`` at the repository root (a plain C
interface, no PyTorch headers, so a build takes seconds), the first time
a kernel is needed or when a source is newer than its library.
:func:`build` starts one ``nvcc`` per stale source and waits for them
all.  A kernel that fails to build raises: nothing falls back.

The kernels' launch plans (``csrc/launch_plan.h``, host-only C++) are
also built by the host C++ compiler into ``build/kernels/
liblaunch_plan.so`` (:func:`load_host`), so that the kernel guard reads
on a machine without a card the plans the card launches: each library's
``<name>_plan`` entry and the host library's of the same name compile
the same header (:func:`read_plan`).  It too raises when it fails to
build.

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

HOST_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: a ``<name>_plan`` entry: the call's ints, their count, the plan's int64
#: fields (:data:`PLAN_FIELDS`) and their count
_PLAN = [_P, _I, _P, _I]

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
#: B int32 lengths or null).  Each library also has its ``<name>_plan``
#: (:func:`read_plan`); those of the split-key body (paged decode and
#: prefill, the dense split route) their ``<name>_attrs`` (:func:`read_attrs`).
KERNELS = {
    "paged_decode": {
        "paged_decode_launch": [_P] * 8 + [_I] * 13 + [_F] * 5 + [_I, _I, _P],
        "paged_decode_int8_launch": [_P] * 10 + [_I] * 13 + [_F] * 5
        + [_I, _I, _P],
        "paged_decode_plan": _PLAN,
        "paged_decode_attrs": _PLAN,
    },
    "paged_prefill": {
        "paged_prefill_launch": [_P] * 9 + [_I] * 14 + [_F] * 5
        + [_I, _I, _P],
        "paged_prefill_int8_launch": [_P] * 11 + [_I] * 14 + [_F] * 5
        + [_I, _I, _P],
        "paged_prefill_plan": _PLAN,
        "paged_prefill_attrs": _PLAN,
    },
    "lut_attention": {
        "lut_attention_launch": [_P] * 6 + [_I] * 16 + [_F] * 5 + [_P],
        "lut_attention_plan": _PLAN,
        "lut_attention_attrs": _PLAN,
    },
    "lut_softmax": {
        "lut_softmax_rexp_launch": [_P] * 4 + [_I] * 7 + [_F] * 4
        + [_I] * 7 + [_P],
        "lut_softmax_lut2d_launch": [_P] * 4 + [_I] * 7 + [_F] * 4
        + [_I] * 7 + [_P],
        "lut_softmax_plan": _PLAN,
    },
    "flash_attention": {
        "flash_attention_launch": [_P] * 6 + [_I] * 9 + [_F] + [_I, _P, _P],
        "flash_attention_plan": _PLAN,
    },
}

#: the host library: every kernel's ``<name>_plan``, the plans' limits
#: (``launch_plan_constants``: :data:`PLAN_CONSTANTS`) and the paged
#: kernels' page-id arithmetic (a block-table entry clamped into the
#: pool, a slot's live keys, a cluster rank's first unit, a block's KV
#: head and rows)
HOST = "launch_plan"
HOST_ENTRIES = {
    **{f"{name}_plan": _PLAN for name in KERNELS},
    "launch_plan_constants": [_P, _I],
    "launch_plan_clamp_page": [_I, _I],
    "launch_plan_live_keys": [_I, _I, _I],
    "launch_plan_unit_lo": [_I, _I, _I],
    "launch_plan_block_rows": [_I, _I, _I, _I, _P],
}
#: the int64 fields of a plan, in ``plan::Field``'s order
PLAN_FIELDS = ("n_split", "rows_per_block", "cache_keys", "warp_split",
               "stages", "smem", "grid_x", "grid_y", "grid_z", "cluster",
               "threads", "rpt")
#: ``launch_plan_constants``'s fields, in ``plan::kConstants``'s order
PLAN_CONSTANTS = ("smem_limit", "sm_pool", "cta_reserve", "max_split",
                  "dense_max_split", "cache_target", "dense_target",
                  "row_smem_limit", "row_cta_head")

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
    src = CSRC / (f"{name}.cpp" if name == HOST else f"{name}.cu")
    newest = max(p.stat().st_mtime for p in
                 [src, CSRC / "launch_plan.h", *CSRC.glob("*.cuh")])
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


def _host_cxx() -> str:
    for cxx in (os.environ.get("CXX"), "c++", "g++"):
        found = cxx and shutil.which(cxx)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++ / g++): the kernels' "
                       "launch plans need one to build")


def build_host() -> Path:
    """Compile ``csrc/launch_plan.cpp`` with the host C++ compiler into
    ``build/kernels/liblaunch_plan.so`` (a temporary file, then a rename:
    several processes may build it at once); raises with the compiler's
    output when it fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{HOST}.so.{os.getpid()}.tmp"
    out = subprocess.run([_host_cxx(), *HOST_FLAGS, "-o", str(tmp),
                          str(CSRC / f"{HOST}.cpp")], capture_output=True,
                         text=True)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"launch-plan library build failed (exit "
                           f"{out.returncode}):\n{out.stdout}{out.stderr}")
    os.replace(tmp, library_path(HOST))
    return library_path(HOST)


def load_host() -> ctypes.CDLL:
    """The host library of launch plans, built if needed."""
    lib = _loaded.get(HOST)
    if lib is None:
        if _stale(HOST):
            build_host()
        lib = ctypes.CDLL(str(library_path(HOST)))
        for fn_name, argtypes in HOST_ENTRIES.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[HOST] = lib
    return lib


def read_plan(fn, ins) -> dict[str, int] | None:
    """The plan a ``<name>_plan`` entry ``fn`` (of a CUDA library or of
    the host library) gives for the call's ints ``ins``, by
    :data:`PLAN_FIELDS`; None for a call its launcher refuses."""
    args = (ctypes.c_int * len(ins))(*(int(x) for x in ins))
    out = (ctypes.c_longlong * len(PLAN_FIELDS))()
    if fn(args, len(ins), out, len(PLAN_FIELDS)) != 0:
        return None
    return dict(zip(PLAN_FIELDS, out))


def read_attrs(fn, ins) -> dict[str, int]:
    """The kernel instance a ``<name>_attrs`` entry ``fn`` reports for the
    call's plan ints ``ins``: registers and local (spill) bytes a thread,
    and the CTAs of the plan a multiprocessor holds."""
    args = (ctypes.c_int * len(ins))(*(int(x) for x in ins))
    out = (ctypes.c_int * 3)()
    err = fn(args, len(ins), out, 3)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err}")
    return dict(zip(("registers", "local_bytes", "ctas_per_sm"), out))


def host_plan(name: str, ins) -> dict[str, int] | None:
    """:func:`read_plan` of the host library's ``<name>_plan``."""
    return read_plan(getattr(load_host(), f"{name}_plan"), ins)


def plan_constants() -> dict[str, int]:
    """The plans' limits, read from the host library."""
    out = (ctypes.c_longlong * len(PLAN_CONSTANTS))()
    if load_host().launch_plan_constants(out, len(PLAN_CONSTANTS)) != 0:
        raise RuntimeError("launch_plan_constants: too few fields")
    return dict(zip(PLAN_CONSTANTS, out))
