"""The port stands alone: no module under ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro`` (an AST
scan of every import statement), and the whole package imports in a
process where both are blocked."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_quantized_and_lockstep_modules():
    """The scan above walks every module of the package, the int8 and
    lockstep ones included."""
    scanned = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert {"core/quantization.py", "kernels/lut_attention/ref.py",
            "runtime/serve_loop.py", "kernels/lut_attention/ops.py",
            "models/layers.py", "launch/serve.py"} <= scanned


def test_scan_covers_the_encdec_and_dense_kernel_modules():
    """... and the Whisper encoder-decoder and dense LUT-attention
    modules."""
    scanned = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert {"models/encdec.py", "kernels/lut_attention/lut_attention.py",
            "configs/whisper_small.py", "models/model_zoo.py"} <= scanned


def test_scan_covers_the_tensor_parallel_modules():
    """... and the tensor-parallel ones: the mesh, its placement rules and
    collectives, and the sharded attention."""
    scanned = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert {"runtime/partitioning.py", "launch/mesh.py",
            "kernels/lut_attention/sharded_paged.py",
            "kernels/lut_attention/sharded_decode.py"} <= scanned


def test_scan_covers_the_training_modules():
    """... and the training side: data, optimizer, checkpoints, the train
    loop and its fault-tolerant trainer, calibration and the launcher."""
    scanned = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert {"data/synthetic.py", "optim/adamw.py", "optim/schedules.py",
            "optim/grad_compress.py", "checkpoint/ckpt.py",
            "checkpoint/manager.py", "core/calibration.py",
            "runtime/train_loop.py", "runtime/fault_tolerance.py",
            "launch/train.py"} <= scanned


def test_scan_covers_the_multirank_modules():
    """... and the model across ranks: the pipeline schedule beside the
    mesh, the rules and the MoE layer's expert parallelism."""
    scanned = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert {"runtime/pipeline.py", "runtime/partitioning.py",
            "launch/mesh.py", "models/moe.py"} <= scanned


def test_package_imports_with_jax_and_repro_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={**os.environ,
                               "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_scan_covers_the_row_softmax_and_flash_modules():
    """... and the row-wise LUT softmax and exact flash-attention
    modules."""
    scanned = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert {"kernels/lut_softmax/lut_softmax.py",
            "kernels/lut_softmax/ops.py", "kernels/lut_softmax/ref.py",
            "kernels/flash_attention/flash_attention.py",
            "kernels/flash_attention/ops.py",
            "kernels/flash_attention/ref.py", "core/lut_softmax.py",
            "core/__init__.py"} <= scanned


def test_scan_covers_the_moe_modules():
    """... and the MoE FFN with its two configs."""
    scanned = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert {"models/moe.py", "configs/deepseek_moe_16b.py",
            "configs/granite_moe_3b_a800m.py"} <= scanned


def test_scan_covers_the_recurrent_modules():
    """... and the Mamba / xLSTM mixers with the hybrid and recurrent
    configs."""
    scanned = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert {"models/ssm.py", "configs/jamba_v0_1_52b.py",
            "configs/xlstm_125m.py"} <= scanned


def test_scan_covers_the_cell_and_dry_run_modules():
    """... and the reference's cells and dry run, with the modules they
    drive: the shape registry, the mesh factories and the fake
    tensors' kernel operators."""
    scanned = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert {"launch/cells.py", "launch/dryrun.py", "configs/base.py",
            "launch/mesh.py", "kernels/common.py",
            "runtime/serve_loop.py"} <= scanned
