"""``python -m repro_torch.analysis`` — the engine's step contracts and
the kernel guard.

Modes:

* ``--check-all``      the single-device contracts (with the kernel
                       guard's contracts) and the TP contracts, run on 4
                       spawned gloo ranks on the CPU.
* ``--check-kernels``  only the kernel guard (shared memory, coverage,
                       Σ-overflow bounds, LUT census): no engine runs.
* ``--single-only`` / ``--tp-only``  one half of ``--check-all``.
* ``--json PATH|-``    write the report (``-`` = stdout).
* ``--update``         rewrite the committed report(s):
                       ``ANALYSIS_contracts_torch.json`` under
                       ``--check-all``, ``ANALYSIS_kernels_torch.json``
                       whenever the kernel guard ran.
* ``--diff PATH``      ratchet against a committed contracts report.
* ``--diff-kernels PATH``  ratchet against a committed kernels report.
* ``--device cuda|cpu``  where the single-device contracts run: the card
                       (default; the paged kernels launch), or, asked
                       for, the CPU (their plain versions).  Without a
                       card ``--check-all``, ``--single-only`` and
                       ``--tp-only`` refuse unless ``--device cpu`` is
                       given.  The TP half runs on 4 gloo ranks on the
                       CPU either way (``contracts.tp_contracts``).

Exit codes: 0 all contracts hold (and the ratchets pass), 1 contract
violations, 2 ratchet regression or harness failure.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import traceback


def _repo_root() -> pathlib.Path:
    # src/repro_torch/analysis/__main__.py -> the repository is parents[3]
    return pathlib.Path(__file__).resolve().parents[3]


def _emit(args, text: str, lines) -> None:
    if args.json == "-":
        print(text)
        return
    if args.json:
        pathlib.Path(args.json).write_text(text + "\n")
    for line in lines:
        print(line, file=sys.stderr)


def _kernel_lines(report: dict):
    for name, p in sorted(report["policies"].items()):
        mark = "ok " if not p["violations"] else "FAIL"
        yield (f"[{mark}] policy {name}: lut_bytes={p['lut_bytes']} "
               f"max_lk={p['max_lk']} margin={p['margin']}")
        yield from (f"       {v}" for v in p["violations"])
    for name, k in sorted(report["kernels"].items()):
        mark = "ok " if k["status"] == "ok" else "FAIL"
        extra = (f"smem_bytes={k['smem_bytes']}" if k["kind"] == "cuda"
                 else "shard_map")
        yield f"[{mark}] kernel {name}: {extra}"
        yield from (f"       {v}" for v in k["violations"])
    yield from (f"[FAIL] {v}" for v in report["violations"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--check-all", action="store_true",
                    help="evaluate the contract suite")
    ap.add_argument("--check-kernels", action="store_true",
                    help="evaluate the kernel guard only")
    ap.add_argument("--single-only", action="store_true",
                    help="only the single-device contracts")
    ap.add_argument("--tp-only", action="store_true",
                    help="only the 4-rank contracts")
    ap.add_argument("--json", metavar="PATH",
                    help="write the report as JSON ('-' for stdout)")
    ap.add_argument("--update", action="store_true",
                    help="rewrite the committed report(s)")
    ap.add_argument("--diff", metavar="PATH",
                    help="ratchet the fresh report against a committed one")
    ap.add_argument("--diff-kernels", metavar="PATH",
                    help="ratchet the fresh kernel-guard report against a "
                         "committed ANALYSIS_kernels_torch.json")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the single-device contracts: cuda "
                         "(default; refuses without a card) or cpu")
    args = ap.parse_args(argv)
    if not (args.check_all or args.check_kernels):
        ap.error("nothing to do: pass --check-all and/or --check-kernels")
    if args.single_only and args.tp_only:
        ap.error("--single-only and --tp-only are mutually exclusive")
    if args.check_kernels and not args.check_all and args.tp_only:
        ap.error("--check-kernels has no TP half; drop --tp-only")

    if args.check_all:
        from repro_torch.models.device import resolve_device
        try:
            resolve_device(args.device)
        except RuntimeError as err:
            ap.error(f"{err} (--device cpu)")

    from repro_torch.analysis import contracts, kernel_guard
    try:
        kernel_report = (None if args.tp_only
                         else kernel_guard.check_kernels())
        if not args.check_all:
            report = None
        else:
            results = []
            if not args.tp_only:
                results += contracts.single_device_contracts(args.device)
                results += contracts.kernel_contracts(kernel_report)
            if not args.single_only:
                results += contracts.tp_contracts()
            report = contracts.build_report(results)
    except Exception:  # noqa: BLE001 - the harness failed: rc 2
        traceback.print_exc()
        return 2

    root = _repo_root()
    if report is None:
        _emit(args, json.dumps(kernel_report, indent=2, sort_keys=True),
              _kernel_lines(kernel_report))
        n_viol = kernel_report["n_violations"]
    else:
        lines = []
        for c in report["contracts"]:
            lines.append(f"[{'ok ' if c['status'] == 'ok' else 'FAIL'}] "
                         f"{c['name']}")
            lines += [f"       {v}" for v in c["violations"]]
        _emit(args, json.dumps(report, indent=2, sort_keys=True), lines)
        n_viol = report["n_violations"]
    if args.update:
        if report is not None:
            contracts.dump_report(report, str(root / contracts.REPORT_NAME))
            print(f"wrote {contracts.REPORT_NAME}", file=sys.stderr)
        if kernel_report is not None:
            kernel_guard.dump_report(kernel_report,
                                     str(root / kernel_guard.REPORT_NAME))
            print(f"wrote {kernel_guard.REPORT_NAME}", file=sys.stderr)

    problems = []
    if args.diff and report is not None:
        problems += contracts.ratchet_violations(
            contracts.load_report(args.diff), report)
    if args.diff_kernels and kernel_report is not None:
        problems += kernel_guard.ratchet_violations(
            kernel_guard.load_report(args.diff_kernels), kernel_report)
    for p in problems:
        print(p, file=sys.stderr)
    if problems:
        return 2
    return 0 if n_viol == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
