#!/usr/bin/env python3
"""The correctness check's control, on the card at a cell's own size.

    python3 bench/control.py --workload <name> --seeds 11,12,13 \
        [--seconds 30] [--dump DIR]

For each seed, in one process: a run of the cell as ``run.py`` makes it
(set-up, the closed loop, a window of ``--seconds``), then the reference
over the sampled requests twice: in the configuration's precision (the
program's readings) and in the control's, fp8, put in the program's place
(at each position the token that fp8 puts first).  Both go through the
cell's own checks and limits: the program has to come out correct and the
control not.  One JSON line a seed; with ``--dump`` each served token's
gap, the program's and the control's, goes to ``DIR/<workload>.<seed>.json``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from run import BENCH, ROOT, fail, set_cache_dirs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--dump", type=Path)
    args = ap.parse_args()
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    set_cache_dirs()
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        fail("no CUDA device", 3)
    from harness.manifest import load_cell
    from harness.runner import run_cell
    cell = load_cell(args.workload, ROOT)
    if args.dump:
        args.dump.mkdir(parents=True, exist_ok=True)
    t_start = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        result, checks = run_cell(cell, seed, args.seconds, False, "cuda",
                                  t_start, control=True)
        gaps = result.pop("gaps")
        if args.dump:
            (args.dump / f"{cell.name}.{seed}.json").write_text(
                json.dumps(gaps))
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": result["correct"], "checks": checks,
                          "control_correct": result["control"]["correct"],
                          "control": result["control"],
                          "reference": result["reference"],
                          "metrics": result["metrics"],
                          "device": result["device"]}), flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
