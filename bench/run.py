#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It serves the cell's traffic through the
PyTorch port (``src/repro_torch``) on one CUDA device, measures for
``--seconds`` after set-up, checks the served tokens against the plain
reference in ``bench/reference``, and prints as the last line of standard
output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, the
reference's own readings, and last ``checks``: each number compared with
its limit, which also end standard error.

It exits non-zero and prints no result without a CUDA device (or fewer
than the cell asks for), without the port beside it, or if the process
has loaded JAX or the JAX package once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def fail(msg: str, code: int = 2):
    print(f"bench: {msg}", file=sys.stderr)
    sys.exit(code)


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port, ``repro_torch``, is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    and one CPU thread for the math libraries: the clients, the server's
    driver thread and the host's dispatch share the machine's cores, and
    spinning worker threads make the host-paced steps vary from run to
    run."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"the port is not beside the benchmark ({ROOT / 'src'})")
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    set_cache_dirs()
    from harness.manifest import load_cell
    cell = load_cell(args.workload, ROOT)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        fail("no CUDA device: nothing measured", 3)
    if torch.cuda.device_count() < cell.chips:
        fail(f"{cell.name} needs {cell.chips} devices, "
             f"{torch.cuda.device_count()} found", 3)
    from harness.runner import run_cell
    result, checks = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        fail(f"the run loaded {found}: the port may not use JAX", 4)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    result["checks"] = checks
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
