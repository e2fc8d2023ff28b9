"""The port's kernel guard (``repro_torch.analysis.kernel_guard``) against
the JAX package's, on the CPU.

The guard reads the CUDA kernels' own launch plans through the host
library (``csrc/launch_plan.h`` built by the host C++ compiler), so
these tests build it (a second or two, once) and also build deliberately
broken copies of the header to see each verdict flip.  Held here:

* the per-policy LUT census, overflow bounds and verdicts equal the JAX
  package's ``policy_ledger`` and its committed ``ANALYSIS_kernels.json``;
* the port's page-id maps give the reference's rows on the same probes;
* ``plan_dense`` at Jamba × ``long_500k`` (B 1, 8 KV heads, 524 288
  keys, 132 SMs) takes clusters of 4: 32 CTAs;
* a widened cache target, a coverage gap, an unclamped page id and a
  dense plan that counts a multiprocessor's shared memory twice (its
  grid then runs in two waves) each flip a kernel to violation, and a
  failed host build raises;
* the committed ``ANALYSIS_kernels_torch.json`` equals a fresh run and
  the ratchet holds it, known two-wave grids included.
"""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from repro.analysis import kernel_guard as JKG
from repro.core.precision import SIGMA_ACC_LIMIT as J_SIGMA
from repro.kernels.lut_attention import sharded_paged as JSP
from repro_torch.analysis import kernel_guard as KG
from repro_torch.kernels import build
from repro_torch.kernels.lut_attention import sharded_paged

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fresh():
    return KG.check_kernels()


def test_policy_ledger_equals_the_reference(fresh):
    """lut_bytes, max_lk and the verdicts of every policy equal the JAX
    package's ledger and its committed report; the shipped contexts and
    the Σ limit too."""
    with open(os.path.join(REPO, JKG.REPORT_NAME)) as f:
        committed = json.load(f)
    ref = JKG.policy_ledger(J_SIGMA, committed["max_contexts"])
    assert fresh["max_contexts"] == committed["max_contexts"]
    assert fresh["sigma_acc_limit"] == committed["sigma_acc_limit"] == J_SIGMA
    assert set(fresh["policies"]) == set(ref) == set(committed["policies"])
    for name, got in fresh["policies"].items():
        for want in (ref[name], committed["policies"][name]):
            for key in ("lut_bytes", "max_lk", "margin", "qmax", "tables",
                        "violations"):
                assert got[key] == want[key], (name, key)
    assert fresh["n_violations"] == 0, fresh["violations"]


def test_clamp_probes_give_the_reference_rows():
    """The 'pages' regime's page-id maps (partitioning.gather_page_ids /
    scatter_page_ids) give the JAX package's rows at every probe of every
    geometry's first and last slab."""
    for geom in KG.GEOMETRIES.values():
        ref = {p.name: p for p in JSP.kernel_spec(geom).clamps}
        mine = sharded_paged.kernel_spec(geom).clamps
        assert [p.name for p in mine] == list(ref)
        for p in mine:
            r = ref[p.name]
            ids = np.asarray(KG.probe_ids(p), np.int32)
            want = np.asarray(r.fn(jnp.asarray(ids), r.lo, r.slab))
            assert KG.clamp_rows(p) == want.tolist(), p.name


def test_plan_dense_at_jamba_long_500k_takes_32_ctas():
    """The dense split plan at Jamba × long_500k: clusters of 4 over 8 KV
    heads of one sequence — 32 CTAs on the H100's 132 SMs."""
    plan = build.host_plan("lut_attention", [
        2, 1, 1, 32, 8, 1, 524288, 128, 524288, 1, 13, 1, 16, KG.N_SMS])
    assert plan["n_split"] == plan["cluster"] == 4
    assert (plan["grid_x"], plan["grid_y"], plan["grid_z"]) == (4, 8, 1)
    assert plan["grid_x"] * plan["grid_y"] * plan["grid_z"] == 32


def _mutant(tmp_path, old, new):
    """A host library built from a copy of ``csrc/`` with ``old`` replaced
    by ``new`` in the plans' header."""
    src = tmp_path / "csrc"
    shutil.copytree(build.CSRC, src)
    header = src / "launch_plan.h"
    text = header.read_text()
    assert old in text
    header.write_text(text.replace(old, new))
    return src


MUTANTS = {
    "widened cache target": (
        "constexpr size_t kCacheTarget = 112 * 1024;",
        "constexpr size_t kCacheTarget = 1024 * 1024;", "paged_decode",
        "exceeds a CTA's", "smoke-jamba-long_500k"),
    "coverage gap": (
        "return {y % kvh, row0, rpb < left ? rpb : left};",
        "return {y % kvh, row0, rpb - 1 < left ? rpb - 1 : left};",
        "paged_prefill", "not in exactly one block", "test"),
    "unclamped page id": (
        "return id < 0 ? 0 : id > n_pages - 1 ? n_pages - 1 : id;",
        "return id;", "paged_decode_int8", "outside [0, 30)", "test"),
    "wave share of twice the shared memory": (
        "return kSmPool / size_t(per_sm) - kCtaReserve;",
        "return 2 * kSmPool / size_t(per_sm) - kCtaReserve;",
        "lut_attention", "two waves", "smoke-qwen3-decode_32k"),
}


@pytest.mark.parametrize("name", list(MUTANTS))
def test_mutant_plan_flips_its_verdict(tmp_path, monkeypatch, name):
    """Each mutation of the kernels' own header turns a kernel that holds
    into a violation at the test geometry."""
    old, new, kernel, words, geom = MUTANTS[name]
    geoms = {geom: KG.GEOMETRIES[geom]}
    assert KG.check_kernels(geoms)["kernels"][kernel]["status"] == "ok"
    src = _mutant(tmp_path, old, new)
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setitem(build._loaded, build.HOST, None)
    build._loaded.pop(build.HOST)
    report = KG.check_kernels(geoms)
    entry = report["kernels"][kernel]
    assert entry["status"] == "violation", name
    assert any(words in v for v in entry["violations"]), entry["violations"]


def test_a_failed_host_build_raises(tmp_path, monkeypatch):
    """A header the host compiler refuses makes the guard raise: nothing
    falls back to a Python mirror of the plans."""
    src = _mutant(tmp_path, "namespace paged {", "namespace paged { oops")
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setitem(build._loaded, build.HOST, None)
    build._loaded.pop(build.HOST)
    with pytest.raises(RuntimeError, match="launch-plan library build"):
        KG.check_kernels({"test": KG.GEOMETRIES["test"]})


def test_committed_report_equals_a_fresh_run_and_ratchets(fresh):
    """``ANALYSIS_kernels_torch.json`` is what the guard computes now; the
    ratchet passes it and catches a shrunk bound, grown shared memory, a
    vanished kernel and a known two-wave grid that takes more."""
    committed = KG.load_report(os.path.join(REPO, KG.REPORT_NAME))
    assert json.loads(json.dumps(fresh, sort_keys=True)) == committed
    assert KG.ratchet_violations(committed, fresh) == []
    worse = json.loads(json.dumps(fresh))
    worse["policies"]["rexp/uint8"]["max_lk"] -= 1
    worse["kernels"]["paged_decode"]["smem_bytes"] += 16
    del worse["kernels"]["lut_softmax"]
    known = worse["kernels"]["lut_attention"]["known_violations"]
    known[0] = known[0].replace(" B a CTA", "0 B a CTA")
    got = KG.ratchet_violations(committed, worse)
    assert len(got) == 4, got
