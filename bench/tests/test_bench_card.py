"""On the card: each cell, as committed, runs and comes out correct, and
its control (``control.py``, fp8) comes out over the limit.  Slow: a few
minutes a cell."""

import json
import subprocess
import sys

import pytest
from conftest import ROOT

CELLS = ["internlm2-20b.docqa"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_card(card, name):
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", name, "--seed",
         "2147483659", "--seconds", "10", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_on_card(card, name):
    out = subprocess.run(
        [sys.executable, "bench/control.py", "--workload", name, "--seeds",
         "2147483661", "--seconds", "10"], cwd=ROOT, capture_output=True,
        text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and not line["control_correct"], line
