"""The benchmark's manifest (``BENCHMARK.json`` at the repository root) and
the files it names: a cell's configuration (``configs/<config>.json``),
traffic mix (``traffic/<traffic>.json``), engine settings
(``cells/<workload>.json``) and per-metric readers (``metrics/<name>.py``),
each found by its name under ``bench/``."""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = SOURCES_E2E + ("program_span", "program_counter")


@dataclass
class Cell:
    """One workload of the manifest with everything it names."""

    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict          # the configuration file
    traffic: dict         # the traffic mix file
    settings: dict        # cells/<name>.json: the engine's settings
    end_to_end: list      # the manifest's metrics this cell reports
    per_layer: list


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, workload: str) -> bool:
    """Whether ``workload`` reports ``metric`` (every cell, without a
    ``workloads`` key)."""
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    man = load_manifest(root)
    by_name = {w["name"]: w for w in man["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: "
                       f"{sorted(by_name)}")
    w = by_name[workload]
    configs = {c["name"]: c for c in man["configs"]}
    c = configs[w["config"]]
    bench = root / "bench"
    return Cell(
        name=workload, chips=int(w["chips"]), config_name=w["config"],
        traffic_name=w["traffic"],
        config=_json(root / c["file"]),
        traffic=_json(bench / "traffic" / f"{w['traffic']}.json"),
        settings=_json(bench / "cells" / f"{workload}.json"),
        end_to_end=[m for m in man["end_to_end"] if reports(m, workload)],
        per_layer=[m for m in man["per_layer"] if reports(m, workload)])


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(ctx)`` of ``bench/metrics/<name>.py``."""
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
