"""The manifest meets the benchmark's contract, and every cell's files are
found by name."""

import json
import re

import pytest
from conftest import ROOT

from harness import manifest as M

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["bench"]
    assert all(LINE.match(w) for w in MAN["command"])
    assert 1 <= MAN["run_seconds"] <= 51
    cells = 24
    assert 1200 + (2 + 14 * cells) * (MAN["run_seconds"] + 60) \
        + cells * 180 <= 43200
    assert len(json.dumps(MAN)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_units_and_lines(kind):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    for e in MAN[kind]:
        assert M.NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert M.UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and kind in ("configs", "workloads", "per_layer"):
                assert LINE.match(e[key]), (e["name"], key)


def test_configs_found_and_as_run():
    from harness.runner import arch_from_file
    from repro_torch.configs import ARCHS
    for c in MAN["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("bench/")
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert all(M.NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "_size")) for k in
                       c["reduced"])
        assert "qk_init_scale" in cfg["assumed"]
        assert arch_from_file(cfg) == ARCHS[cfg["arch"]]


def test_every_cell_files_found():
    used = set()
    for w in MAN["workloads"]:
        assert w["chips"] in (1, 4)
        cell = M.load_cell(w["name"], ROOT)
        used.add(w["config"])
        assert cell.traffic["loop"] == "closed"
        assert cell.settings["n_slots"] >= 1
        assert cell.end_to_end and cell.per_layer
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2
    assert used == {c["name"] for c in MAN["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics_have_readers_and_move_reported_metrics():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert m["source"] in M.SOURCES_E2E
        assert 0.01 <= m["bound"] <= 0.25
        assert callable(M.metric_reader(m["name"], ROOT))
    layers = {}
    for m in MAN["per_layer"]:
        assert m["source"] in M.SOURCES
        assert m["moves"] in e2e
        assert callable(M.metric_reader(m["name"], ROOT))
        layers.setdefault(m["layer"], []).append(m["name"])
        for w in m.get("workloads", [x["name"] for x in MAN["workloads"]]):
            assert M.reports(e2e[m["moves"]], w), (m["name"], w)
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"`{layer}`" in perf, layer
