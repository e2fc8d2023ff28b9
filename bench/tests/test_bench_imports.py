"""What a run loads: no module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``repro`` (the JAX package), compared whole, since the port,
``repro_torch``, begins with ``repro``; the reference loads nothing of the
program; and the entry refuses to run without a card or without the port
beside it."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

from conftest import BENCH, ROOT


def _python(code: str, cwd=ROOT, timeout=600):
    env = dict(os.environ, PYTHONPATH="")
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_a_run_loads_no_jax():
    out = _python(f"""
        import json, sys, time
        sys.path[:0] = [{str(BENCH)!r}, {str(BENCH / 'tests')!r},
                        {str(ROOT / 'src')!r}]
        import torch
        from conftest import tiny_cell
        from harness.runner import run_cell
        res, _ = run_cell(tiny_cell("internlm2-20b.docqa"), 5, 1.0,
                          False, "cpu", time.perf_counter(),
                          dtype=torch.float32, warmup_s=0.5)
        import run
        print(json.dumps([run.forbidden_modules(), "repro_torch" in
                          sys.modules, res["metrics"] != {{}}]))
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    found, port, measured = json.loads(out.stdout.strip().splitlines()[-1])
    assert found == [] and port and measured


def test_forbidden_names_are_compared_whole():
    out = _python(f"""
        import sys, types
        sys.path.insert(0, {str(BENCH)!r})
        import run
        sys.modules["repro_torch_like"] = types.ModuleType("x")
        sys.modules["jaxish"] = types.ModuleType("x")
        a = run.forbidden_modules()
        sys.modules["repro.core"] = types.ModuleType("x")
        sys.modules["jax"] = types.ModuleType("x")
        print(a, run.forbidden_modules())
    """)
    assert out.stdout.split() == ["[]", "['jax',", "'repro']"], out.stderr


def test_the_reference_loads_nothing_of_the_program():
    out = _python(f"""
        import sys
        sys.path.insert(0, {str(BENCH)!r})
        import reference.model, reference.rexp
        print(sorted({{m.split(".")[0] for m in sys.modules}}
                     & {{"repro", "repro_torch", "jax"}}))
    """)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "internlm2-20b.docqa", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_run_refuses_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "internlm2-20b.docqa", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
