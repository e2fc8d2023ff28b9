"""Multi-pod dry run: trace every (arch × shape) cell as rank 0 of the
single-pod 16×16 and the two-pod 2×16×16 mesh, and record what a rank
holds, computes and sends.

The counterpart of the JAX package's ``launch/dryrun.py``.  JAX lowers
and compiles each cell for 512 placeholder devices; the port has no
cluster, so each cell's step runs once on meta tensors at rank 0's
shapes over a ``fake`` process group of 256 or 512 ranks in this process
(``launch/cells.py``: ``build_cell`` → ``trace_cell``).  No card is
needed and no kernel is built.

Each record: ``status`` (``ok``, ``skipped`` — ``configs.
shape_applicable`` — or ``error`` with its traceback), ``seconds`` (the
trace), ``memory`` (a rank's argument, output, peak and live bytes —
live = peak + ``cells.WORKSPACE_BYTES`` — and ``fits_hbm_80g``: live ≤
:data:`HBM_PER_CARD`, the capacity torch reports on an H100 80GB HBM3),
``cost.flops`` (the rank's FLOPs,
``FlopCounterMode``), ``collectives`` (the rank's count and bytes, in
all and by site and kind), ``params`` and ``params_active``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --both-meshes [--out DIR]
      [--jobs N] [--slow-args-only]

The flags are the reference's, and ``--jobs`` and ``--slow-args-only``:
the reference has neither.  ``--jobs`` traces that many cells at once,
one process each; the recurrent archs' training and prefill traces take
hours (one process runs the sweep in about 15 h, seven in about 2.8 h).
``--slow-args-only`` builds those cells without tracing them: their
records (status ``args``) hold a rank's argument bytes, from the specs,
and nothing the trace measures.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
import traceback

#: the bytes a rank may hold: the total capacity torch reports for an
#: H100 80GB HBM3 (``torch.cuda.get_device_properties(0).total_memory``:
#: 79.18 GiB; the 80 GB of its name are not all the allocator's)
HBM_PER_CARD = 85_017_493_504


def slow_trace(arch, shape) -> bool:
    """Whether the cell's trace takes hours: a recurrent arch's training
    or prefill step (4 096 or 32 768 Python steps a layer)."""
    return arch.sub_quadratic and shape.kind != "decode"


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             trace: bool = True) -> dict:
    """One cell on one production mesh, as rank 0: its record (without
    ``trace``, a rank's argument bytes only, status ``args``)."""
    from repro_torch.configs import SHAPES, get_arch, shape_applicable
    from repro_torch.launch.cells import build_cell, trace_cell
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch_name, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "n_devices": mesh.world}
    arch = get_arch(arch_name)
    ok, reason = shape_applicable(arch, SHAPES[shape_name])
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    t0 = time.time()
    try:
        cell = build_cell(arch_name, shape_name, mesh)
        if not trace:
            rec.update(status="args", seconds=round(time.time() - t0, 1),
                       memory={"argument_bytes": argument_bytes(cell)},
                       params=cell.arch.param_count())
            return rec
        tr = trace_cell(cell)
        total = {"count": sum(c["count"] for c in tr.collectives.values()),
                 "bytes": sum(c["bytes"] for c in tr.collectives.values())}
        rec.update(
            status="ok",
            seconds=round(time.time() - t0, 1),
            memory={"argument_bytes": tr.argument_bytes,
                    "output_bytes": tr.output_bytes,
                    "peak_bytes": tr.peak_bytes,
                    "live_bytes": tr.live_bytes,
                    "fits_hbm_80g": tr.live_bytes <= HBM_PER_CARD},
            cost={"flops": float(tr.flops)},
            collectives={"total": total, "by_site": tr.collectives},
            params=cell.arch.param_count(),
            params_active=cell.arch.param_count(active_only=True),
        )
    except Exception as exc:  # noqa: BLE001 — reported per cell
        rec.update(status="error", seconds=round(time.time() - t0, 1),
                   error=f"{type(exc).__name__}: {exc}",
                   traceback=traceback.format_exc()[-2000:])
    return rec


def argument_bytes(cell) -> int:
    """A rank's bytes of the cell's arguments (weights, optimizer state,
    caches, batch), from their shapes."""
    from repro_torch.launch.cells import _nbytes, _tensors
    return _nbytes(_tensors(cell.args))


def line(rec: dict) -> str:
    """The record's ``[OK]`` / ``[ARGS]`` / ``[SKIP]`` / ``[ERR]`` line."""
    tag = f"{rec['arch']} × {rec['shape']} × {rec['mesh']}"
    if rec["status"] == "args":
        return (f"[ARGS] {tag}: arguments "
                f"{rec['memory']['argument_bytes'] / 2**30:.2f} GiB/rank "
                f"(not traced)")
    if rec["status"] == "ok":
        mem = rec["memory"]
        return (f"[OK]   {tag}: trace {rec['seconds']}s, live "
                f"{mem['live_bytes'] / 2**30:.2f} GiB/rank "
                f"(fits={mem['fits_hbm_80g']}), flops "
                f"{rec['cost']['flops']:.3e}, collectives "
                f"{rec['collectives']['total']['count']} / "
                f"{rec['collectives']['total']['bytes'] / 2**30:.3f} GiB")
    if rec["status"] == "skipped":
        return f"[SKIP] {tag}: {rec['reason']}"
    return f"[ERR]  {tag}: {rec['error']}"


def _job(job):
    return run_cell(*job)


def card_line() -> str | None:
    """The card's name and power limit, as ``nvidia-smi`` gives them,
    where a card is present."""
    import torch
    if not torch.cuda.is_available():
        return None
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def main(argv=None) -> None:
    from repro_torch.configs import ARCHS, SHAPES
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="directory for per-cell json")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, one process each")
    ap.add_argument("--slow-args-only", action="store_true",
                    help="record only a rank's argument bytes of the "
                         "cells whose traces take hours")
    args = ap.parse_args(argv)
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("give --arch and --shape, or --all")

    card = card_line()
    if card:
        print(f"card: {card}")
    cells = ([(a, s) for a in sorted(ARCHS) for s in SHAPES]
             if args.all else [(args.arch, args.shape)])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    jobs = [(a, s, mp, not (args.slow_args_only
                            and slow_trace(ARCHS[a], SHAPES[s])))
            for a, s in cells for mp in meshes]
    t0 = time.time()
    if args.jobs > 1:
        # the recurrent archs' training and prefill cells trace 4 096 or
        # 32 768 Python steps a layer: start them first
        jobs.sort(key=lambda j: not (j[3] and slow_trace(ARCHS[j[0]],
                                                         SHAPES[j[1]])))
        import multiprocessing as mp
        with mp.get_context("spawn").Pool(args.jobs,
                                          maxtasksperchild=1) as pool:
            recs = pool.imap(_job, jobs)
            _report(recs, args.out)
    else:
        _report(map(_job, jobs), args.out)
    print(f"dry run: {len(jobs)} cell-mesh pairs in "
          f"{time.time() - t0:.1f} s")


def _report(recs, out: str | None) -> None:
    for rec in recs:
        print(line(rec), flush=True)
        if out:
            os.makedirs(out, exist_ok=True)
            fname = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
            with open(os.path.join(out, fname.replace("/", "_")), "w") as f:
                json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
