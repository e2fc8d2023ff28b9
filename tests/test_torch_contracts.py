"""The port's per-step contracts (``repro_torch.analysis.contracts``)
against the JAX package's committed ``ANALYSIS_contracts.json``, on the
CPU.

One module fixture runs the whole suite once — the single-device
contracts, the kernel guard's and the TP half on 4 spawned gloo ranks —
and the tests hold it to the reference's contract names and statuses
(read from its committed report: no JAX program is traced or compiled),
to the committed ``ANALYSIS_contracts_torch.json`` and to the ratchet.
Each mutation of an engine step flips its contract: an inserted
``.item()``, a pipelined step that returns logits, a pool replaced
rather than written in place, and the LUT datapath converted to a float
outside its sanctioned points.
"""

import json
import os

import pytest
import torch

from repro_torch.analysis import contracts as C
from repro_torch.core import lut_softmax as CORE
from repro_torch.kernels.lut_attention import ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the port's kernels the JAX package has no kernel of (its contracts
#: report has no entry for them)
PORT_ONLY = {"kernel/flash_attention", "kernel/lut_softmax"}


@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    results = C.single_device_contracts("cpu") + C.kernel_contracts()
    tp = C.tp_contracts(str(tmp_path_factory.mktemp("contracts_tp")))
    return C.build_report([r.to_dict() for r in results] + tp)


def _load(name):
    with open(os.path.join(REPO, name)) as f:
        return json.load(f)


def test_names_and_statuses_equal_the_reference(fresh):
    """Every contract of the JAX package's committed report is here, by
    the same name, topology, step and status (all ok); the port adds
    only its two kernels the JAX package has no counterpart of."""
    ref = {c["name"]: c for c in _load("ANALYSIS_contracts.json")[
        "contracts"]}
    got = {c["name"]: c for c in fresh["contracts"]}
    assert set(got) - set(ref) == PORT_ONLY
    assert set(ref) <= set(got)
    for name, want in ref.items():
        for key in ("topology", "step", "status"):
            # a Pallas kernel of the reference is a CUDA kernel here
            expect = {"pallas": "cuda"}.get(want[key], want[key])
            assert got[name][key] == expect, (name, key)
    assert fresh["n_violations"] == 0, [
        (c["name"], c["violations"]) for c in fresh["contracts"]
        if c["violations"]]


def test_committed_report_equals_a_fresh_run_and_ratchets(fresh):
    """``ANALYSIS_contracts_torch.json`` is what the suite gives now; the
    ratchet passes it and catches a contract that regressed or went."""
    committed = _load(C.REPORT_NAME)
    assert json.loads(json.dumps(fresh, sort_keys=True)) == committed
    assert C.ratchet_violations(committed, fresh) == []
    worse = json.loads(json.dumps(fresh))
    worse["contracts"] = [c for c in worse["contracts"]
                          if c["name"] != "single/cow-copy"]
    worse["contracts"][0]["violations"].append("regressed")
    assert len(C.ratchet_violations(committed, worse)) == 2


def _spec(name, eng):
    n = C.pool_leaves(eng)
    donated = {"sync": n, "pipelined": n, "int8": n}
    return next(s for s in C.single_device_specs(donated) if s.name == name)


def _inserted_item(eng):
    decode = eng._op_decode

    def with_item(**plan):
        logits = decode(**plan)
        logits.sum().item()
        return logits
    eng._op_decode = with_item


def _returns_logits(eng):
    def decode(host, max_kv_len, meta=None):
        return eng.model.decode_step_paged(
            eng.params, eng._token_buf[:, None], eng.pools,
            torch.as_tensor(host.block_tables),
            torch.as_tensor(host.lengths), eng.run_cfg,
            max_kv_len=max_kv_len)
    eng._op_decode = decode


def _replaces_pool(eng):
    def copy(copies):
        for pool in eng.pools:
            for name in pool:
                pool[name] = pool[name].clone()
    eng._op_copy = copy


def _leaky_softmax(monkeypatch):
    def leaky(x, tables, axis=-1, index_mode="round"):
        e_int = CORE.rexp_exp_int(x, tables, axis, index_mode)
        return e_int.float() / tables.precision.qmax
    monkeypatch.setattr(ops._core, "softmax_rexp", leaky)


#: mutation → (contract, pipelined engine, mutate(engine, monkeypatch),
#: words of the violation)
MUTANTS = {
    "inserted .item()": ("single/decode/rexp", False,
                         lambda e, mp: _inserted_item(e), "host sync"),
    "pipelined step returns logits": ("single/decode-sampled/lut2d", True,
                                      lambda e, mp: _returns_logits(e),
                                      "logits escape"),
    "pool replaced, not written in place": ("single/cow-copy", False,
                                            lambda e, mp: _replaces_pool(e),
                                            "pool:"),
    "LUT datapath upcast": ("single/decode/rexp", False,
                            lambda e, mp: _leaky_softmax(mp), "lut-upcast"),
}


@pytest.mark.parametrize("name", list(MUTANTS))
def test_mutant_step_flips_its_contract(monkeypatch, name):
    """The contract holds on the engine as it is and fails on the
    mutant, with the violation it names."""
    cname, pipelined, mutate, words = MUTANTS[name]
    _, eng = C.build_engine(pipelined=pipelined,
                            impl="lut2d" if pipelined else "rexp",
                            device="cpu")
    spec = _spec(cname, eng)
    assert C.check_run(spec, C.run_step(eng, spec.step)).status == "ok"
    mutate(eng, monkeypatch)
    got = C.check_run(spec, C.run_step(eng, spec.step))
    assert got.status == "violation", name
    assert any(words in v for v in got.violations), got.violations
