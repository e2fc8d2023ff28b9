"""The plain reference against the port, on the CPU at a scaled-down
arch: the port's paged prefill chunks and decode steps against the
reference's full forward; the reference's REXP tables and weights
against the port's; its MoE against the port's, drops included."""

import dataclasses

import numpy as np
import pytest
import torch
from conftest import ROOT

from harness.manifest import load_cell
from harness.runner import arch_from_file, build_engine
from harness.weights import draw_params
from reference import rexp as R
from reference.model import Reference, capacity, prompt_groups


def test_tables_equal_the_ports():
    from repro_torch.core.lut_builder import build_rexp_tables
    for prec in ("int16", "uint8", "uint4"):
        t = build_rexp_tables(prec)
        assert np.array_equal(R.lut_recip_exp(prec), t.lut_recip_exp)
        assert np.array_equal(R.lut_alpha(prec), t.lut_alpha)


def test_rexp_weights_equal_the_ports():
    from repro_torch.core.lut_builder import build_rexp_tables
    from repro_torch.core.lut_softmax import softmax_rexp
    g = torch.Generator().manual_seed(0)
    x = torch.randn(64, 300, generator=g) * 3.0
    x[5, 100:] = float("-inf")
    rx = R.Rexp("uint8", "cpu")
    ours = rx.weights_int(x.clone()) * rx.inv
    theirs = softmax_rexp(x, build_rexp_tables("uint8"))
    assert torch.equal(ours, theirs)


#: the cell's arch, and the MoE path of the reference, which no cell runs
#: yet (a DeepSeek-MoE-style arch on the cell's settings)
VARIANTS = [("internlm2-20b.docqa", False), ("internlm2-20b.docqa", True)]


@pytest.mark.parametrize("name,moe", VARIANTS)
def test_weights_have_the_ports_tree(name, moe):
    from conftest import tiny_cell
    from repro_torch.models.model_zoo import build_model
    cfg = tiny_cell(name, moe=moe).config
    ours = draw_params(cfg, 3, "cpu", torch.float32)
    theirs = build_model(arch_from_file(cfg)).init(
        torch.Generator().manual_seed(3), "cpu")

    def shapes(t, p=""):
        if isinstance(t, dict):
            return {k: v for key in t for k, v in
                    shapes(t[key], f"{p}/{key}").items()}
        if isinstance(t, list):
            return {k: v for i, x in enumerate(t) for k, v in
                    shapes(x, f"{p}/{i}").items()}
        return {p: tuple(t.shape)}
    assert shapes(ours) == shapes(theirs)


def _engine_logits(cell, cfg, params, prompt, n_new):
    """Greedy tokens of the port's paged engine steps (chunked prefill,
    then decode) and the logits it took each from."""
    from repro_torch.runtime.paged_cache import (decode_view,
                                                 prefill_chunk_view,
                                                 view_arrays)
    from repro_torch.runtime.scheduler import Request, Scheduler
    st = cell.settings
    eng = build_engine(cfg, st, params, "cpu", torch.float32)
    sched = Scheduler(eng.cache, 1)
    seq = sched.add(Request(0, tuple(int(t) for t in prompt), n_new))
    sched.try_admit()
    chunk = st["prefill_chunk"]
    while seq.prefilled < len(prompt):
        n = min(chunk, len(prompt) - seq.prefilled)
        v = view_arrays(prefill_chunk_view(seq, n, chunk, eng.cache), "cpu")
        logits = eng.model.prefill_chunk_paged(
            eng.params, v.tokens, eng.pools, v.block_tables, v.cache_lens,
            v.chunk_lens, eng.run_cfg)
        sched.on_prefill_chunk(seq, n)
    rows = [logits[0, 0]]
    sched.on_token(seq, int(rows[-1].argmax()))
    while len(seq.generated) < n_new:
        sched.grow_for_decode()
        v = view_arrays(decode_view(sched.decode_slots(), 1, eng.cache), "cpu")
        logits = eng.model.decode_step_paged(
            eng.params, v.tokens, eng.pools, v.block_tables, v.lengths,
            eng.run_cfg)
        rows.append(logits[0, 0])
        sched.on_token(seq, int(rows[-1].argmax()))
    return seq.generated, torch.stack(rows)


@pytest.mark.parametrize("name,moe", VARIANTS)
def test_paged_prefill_and_decode_against_full_forward(name, moe):
    from conftest import tiny_cell
    cell = tiny_cell(name, moe=moe)
    cfg = cell.config
    params = draw_params(cfg, 11, "cpu", torch.float32)
    prompt = np.random.default_rng(0).integers(0, cfg["vocab_size"], 70)
    served, port = _engine_logits(cell, cfg, params, prompt, 12)
    ref = Reference(cfg, params, "uint8")
    seq = torch.as_tensor(np.concatenate([prompt, served[:-1]]))
    logits, _ = ref.forward(
        seq, logits_from=len(prompt) - 1,
        groups=prompt_groups(len(prompt), cell.settings["prefill_chunk"]))
    assert torch.allclose(logits, port, atol=1e-4, rtol=1e-4)
    assert ref.rexp.rows > 0 and ref.rexp.zero_rows < ref.rexp.rows


def test_moe_against_the_ports_with_drops():
    from repro_torch.models.moe import apply_moe
    from conftest import tiny_cell
    cfg = dict(tiny_cell("internlm2-20b.docqa", moe=True).config,
               num_hidden_layers=1)
    params = draw_params(cfg, 5, "cpu", torch.float32)
    ref = Reference(cfg, params, "uint8")
    h = torch.randn(300, cfg["hidden_size"],
                    generator=torch.Generator().manual_seed(1))
    h[:, 0] += 40.0   # every token prefers the same experts: drops
    lp = {k: (v[0] if not isinstance(v, dict) else
              {kk: vv[0] for kk, vv in v.items()})
          for k, v in params["periods"][0]["ffn"].items()}
    theirs = apply_moe(lp, h[None], n_experts=8, top_k=2, d_expert=32,
                       n_shared=1, group_size=4096)[0]
    ours = ref.moe_ffn(0, h, [(0, 300, 300)])
    assert capacity(300, 8, 2) == 256 and ref.dropped > 0
    assert torch.allclose(ours, theirs, atol=1e-5, rtol=1e-5)
    assert dataclasses.is_dataclass(ref.d)
