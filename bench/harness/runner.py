"""One run of one cell: set-up (weights, engine, documents, warm-up), the
measured window, the metrics, then the check against the reference."""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

from harness import counts
from harness.check import (compare, judge, passes, sample,
                           stream_mismatches)
from harness.drive import prefill_documents, serve, warm_shapes
from harness.manifest import metric_reader
from harness.traffic import Traffic
from harness.weights import draw_params

DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32"}


def arch_from_file(cfg: dict):
    """The port's ArchConfig of ``cfg["arch"]`` at the file's sizes."""
    from repro_torch.configs import ARCHS
    base = ARCHS[cfg["arch"]]
    moe = base.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe, n_experts=cfg["n_routed_experts"],
            top_k=cfg["num_experts_per_tok"],
            d_expert=cfg["moe_intermediate_size"],
            n_shared=cfg["n_shared_experts"])
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return dataclasses.replace(
        base, n_layers=cfg["num_hidden_layers"], d_model=d, n_heads=h,
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=base.d_ff if moe is not None else cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"],
        head_dim=None if cfg["head_dim"] * h == d else cfg["head_dim"],
        rope_theta=float(cfg["rope_theta"]),
        norm_eps=float(cfg["rms_norm_eps"]), moe=moe)


def build_engine(cfg: dict, settings: dict, params, device, dtype):
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.policies import SoftmaxPolicy
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime.engine import EngineConfig, PipelinedEngine
    from repro_torch.runtime.paged_cache import PagedCacheConfig

    sm = settings["softmax"]
    run = RunConfig(dtype=DTYPE_NAMES[dtype],
                    softmax_policy=SoftmaxPolicy(impl=sm["impl"],
                                                 precision=sm["precision"]),
                    kv_dtype=settings["kv_dtype"])
    cache = PagedCacheConfig(n_pages=settings["n_pages"],
                             page_size=settings["page_size"],
                             max_pages_per_seq=settings["max_pages_per_seq"])
    return PipelinedEngine(build_model(arch_from_file(cfg)), params, run,
                           EngineConfig(
                               n_slots=settings["n_slots"], cache=cache,
                               prefill_chunk=settings["prefill_chunk"],
                               prefill_budget=settings["prefill_budget"],
                               prefix_cache=settings["prefix_cache"],
                               pipeline_depth=settings["pipeline_depth"]),
                           device=device)


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _device_block(device, trace_reading) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    if trace_reading is not None:
        out["busy_s"] = trace_reading.busy_s
        out["window_s"] = trace_reading.window_s
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, *, dtype=torch.bfloat16, warmup_s=None,
             control: bool = False, fault=None):
    """Set up, serve, measure and check one run.  Returns ``(result,
    checks)``: the result line's keys but ``checks``, and the checks.
    ``fault(engine)`` (tests) breaks the timed path before it runs.

    Every product accumulates in f32, as the configuration states: no
    TF32, and no bf16 GEMM whose split-K partial sums are added in bf16
    (which PyTorch allows by default)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg, st = cell.config, cell.settings
    traffic = Traffic(cell.traffic, seed, cfg["vocab_size"])
    if traffic.max_context() > st["max_pages_per_seq"] * st["page_size"]:
        raise ValueError(f"{cell.name}: the mix reaches "
                         f"{traffic.max_context()} tokens, past the block "
                         f"table")
    power = (power_limit_w() if torch.device(device).type == "cuda"
             else None)
    marks = [("start", time.perf_counter())]
    params = draw_params(cfg, seed, device, dtype)
    marks.append(("weights", time.perf_counter()))
    engine = build_engine(cfg, st, params, device, dtype)
    if fault is not None:
        fault(engine)
    marks.append(("engine", time.perf_counter()))
    warm_shapes(engine)
    prefill_documents(engine, traffic)
    marks.append(("documents", time.perf_counter()))
    drive = asyncio.run(serve(
        engine, traffic, st["n_slots"],
        st["warmup_s"] if warmup_s is None else warmup_s, seconds,
        st["trace_steps"] if trace else None))
    setup_s = drive.t0 - t_start
    marks.append(("warm-up", drive.t0))
    print(f"set-up: imports {marks[0][1] - t_start:.2f} s, " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.2f} s" for a, b in zip(marks, marks[1:])),
        file=sys.stderr)
    if trace and drive.trace is None:
        raise RuntimeError(f"the traced slice failed: {drive.trace_error}")
    dev = _device_block(device, drive.trace)
    if power is not None:
        dev["power_limit_w"] = power
    ctx = SimpleNamespace(drive=drive, window_s=drive.t1 - drive.t0,
                          setup_s=setup_s, cfg=cfg, settings=st,
                          workload=cell.name, counts=counts,
                          n_layers=cfg["num_hidden_layers"])
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    recs = drive.records
    result = {
        "correct": False,
        "attempted": sum(1 for r in recs
                         if drive.t0 <= r.t_submit <= drive.t1),
        "failed": sum(1 for r in recs if r.error is not None),
        "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {
            "device_ops": sorted(([k, v] for k, v in
                                  drive.trace.op_s.items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": [[k, v] for k, v in drive.trace.gaps]}
    # the check: after the peak is read, with the program's state freed
    picked = sample(recs, traffic, seed, st["check"]["requests"],
                    st["check"]["min_tokens"])
    mismatches = stream_mismatches(recs)
    del engine
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    chk = st["check"]
    reading = compare(cfg, params, traffic, picked,
                      st["softmax"]["precision"], st["prefill_chunk"],
                      chk.get("tail_gap"), control=control)
    checks = judge(reading if picked else None, chk)
    checks["stream_mismatch"] = {"value": mismatches, "limit": 0}
    result["correct"] = passes(checks)
    result["reference"] = {
        k: reading[k] for k in ("tokens", "requests", "mean_gap", "max_gap",
                                "argmax_agree", "over", "zero_rows", "rows",
                                "moe_dropped", "seconds")}
    result["reference"]["zero_row_share"] = (
        reading["zero_rows"] / reading["rows"] if reading["rows"] else None)
    result["reference"]["served_tokens"] = int(sum(len(r.tokens)
                                                   for r in recs))
    if control:
        # the control put in the program's place, held to the same limits
        result["control"] = dict(
            reading["control"],
            checks=judge(reading["control"] if picked else None, chk))
        result["control"]["correct"] = passes(result["control"]["checks"])
        result["gaps"] = {"program": [g.tolist() for g in reading["gaps"]],
                          "control": [g.tolist() for g in
                                      reading["control_gaps"]]}
    return result, checks
