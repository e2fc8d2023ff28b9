"""Shared set-up of the benchmark's CPU tests: the harness and the port on
the path, the ``gpu`` marker, and a cell cut to a size a CPU test holds.

Tests marked ``gpu`` need a CUDA device; they ask for the ``card``
fixture, which skips them without one (decided when the test runs, never
at import).  Run them on the card with ``pytest -m gpu bench/tests``."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one — run on "
        "the card with `pytest -m gpu bench/tests`")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark measures the card)")
    return torch.device("cuda")


TINY_DIMS = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
                 head_dim=16, intermediate_size=128, num_hidden_layers=2,
                 vocab_size=256)
TINY_MOE = dict(n_routed_experts=8, num_experts_per_tok=2,
                moe_intermediate_size=32, n_shared_experts=1)
TINY_DOCS = {"loop": "closed", "documents": {"count": 2, "min": 64, "max": 96},
             "question": {"dist": "lognormal", "median": 12, "sigma": 0.5,
                          "min": 8, "max": 16},
             "output": {"dist": "lognormal", "median": 6, "sigma": 0.5,
                        "min": 4, "max": 8}, "block": 4}
TINY_CHAT = {"loop": "closed",
             "prompt": {"dist": "lognormal", "median": 20, "sigma": 1.0,
                        "min": 4, "max": 80},
             "output": {"dist": "lognormal", "median": 6, "sigma": 1.0,
                        "min": 2, "max": 12}, "block": 4}


SMALL_DIMS = dict(hidden_size=256, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=64, intermediate_size=512,
                  num_hidden_layers=8, vocab_size=2048)
SMALL_MOE = dict(n_routed_experts=16, num_experts_per_tok=4,
                 moe_intermediate_size=64, n_shared_experts=1)


def tiny_cell(name: str, small: bool = False, moe: bool = False):
    """The workload ``name`` of the manifest at a CPU test's size: the same
    arch, init, mix kind, engine settings and limits, cut widths and
    lengths (``small``: 8 layers of 256, for the checks' readings).
    ``moe`` puts DeepSeek-MoE's routed experts in place of the MLP, for
    the reference's MoE path, which no cell runs yet."""
    from harness.manifest import load_cell
    cell = load_cell(name, ROOT)
    cfg = dict(cell.config, **(SMALL_DIMS if small else TINY_DIMS))
    if moe:
        cfg.update(SMALL_MOE if small else TINY_MOE, arch="deepseek-moe-16b")
    cfg["assumed"] = dict(cfg["assumed"], out_init_scale=(
        2 * cfg["num_hidden_layers"]) ** -0.5)
    cell.config = cfg
    cell.traffic = TINY_DOCS if cell.traffic.get("documents") else TINY_CHAT
    cell.settings = dict(cell.settings, n_slots=4, n_pages=64,
                         max_pages_per_seq=16, prefill_chunk=32,
                         prefill_budget=32)
    return cell
