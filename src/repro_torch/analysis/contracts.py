"""Per-step invariant contracts of the paged serving engine — the
counterpart of the JAX package's ``analysis/contracts``.

Each :class:`ContractSpec` names one device program of the engine (a
decode step, a prefill chunk, the sampled decode step and final chunk of
the pipelined engine, the copy-on-write page copy) on one topology
(single device, tensor-parallel ``'heads'``, tensor-parallel
``'pages'``) and the invariants the program must keep.  The port does
not jit, so there is no compiled artifact to read: each contract RUNS
the engine's own ``_op_*`` program once (``engine._launch``, the path a
served step takes) under :class:`StepRecorder` — a
``TorchDispatchMode`` that sees every aten operation — and the mesh's
``CollectiveLog``, and checks:

* the pool is updated in place (the counterpart of donation): every
  pool leaf keeps its storage, and no operation outputs a new tensor the
  size of a pool leaf;
* no host sync: no ``_local_scalar_dense`` (``.item()``), ``nonzero``,
  ``masked_select`` or ``unique``, and no copy from the card to the
  host (on the card, ``chip_smoke.py``'s phase 14 also runs each step
  under ``torch.cuda.set_sync_debug_mode("error")``);
* the LUT integer datapath is never converted to a float outside the
  sanctioned points (:data:`LUT_EXITS`: the f32-exact Σ, the requant,
  σ_int/qmax): a taint walk from the LUT reads (:data:`LUT_READS`), with
  the Python frame at each conversion standing in for the reference's
  named scopes; int8 pool pages become float only in the plain versions'
  dequant (:data:`INT8_EXITS`);
* the pipelined steps return token vectors, never a ``(…, V)`` tensor;
* collectives: none on one device; on a ``tp = 4`` mesh of gloo ranks
  the reference's budgets (:func:`tp_budgets`) — a decode step's
  partials at most ``2·b·h·(d+2)·4`` bytes a layer, no all-gather of
  ``ag_cap`` bytes or more, the ``'pages'`` regime all-reduces, and the
  COW copy moves at most one page a pool leaf.

``kernel_contracts`` wraps the kernel guard's verdicts.  The
reference's ``compile_count`` has no counterpart (nothing is compiled),
nor do ``hlo_guard`` and ``jaxpr_lint`` (they read JAX's IR; the
recorder takes their place).  ``python -m repro_torch.analysis
--check-all`` writes ``ANALYSIS_contracts_torch.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

REPORT_VERSION = 1
REPORT_NAME = "ANALYSIS_contracts_torch.json"

# the test suite's small serving geometry (tests/test_torch_tp.py)
D_MODEL, HEADS, VOCAB, PERIODS = 64, 4, 128, 2
N_SLOTS = 3
CACHE = dict(n_pages=30, page_size=8, max_pages_per_seq=8)

#: the functions whose integer outputs of a table read start the LUT
#: datapath (the reference's ``lut_int_scope``), by (module, function)
LUT_READS = frozenset({
    ("core/lut_softmax.py", "rexp_exp_int"),
    ("core/lut_softmax.py", "lut2d_exp_int"),
    ("core/lut_softmax.py", "softmax_rexp"),
    ("core/lut_softmax.py", "softmax_lut2d"),
    ("kernels/common.py", "policy_e_terms"),
    ("kernels/common.py", "rexp_sigma"),
    ("kernels/common.py", "lut2d_sigma_int"),
})
#: the sanctioned conversions of the LUT datapath to a float (the
#: reference's ``dequant_scope``): the f32-exact Σ, e·α / qmax and
#: σ_int / qmax
LUT_EXITS = frozenset({
    ("core/lut_softmax.py", "softmax_rexp"),
    ("core/lut_softmax.py", "softmax_lut2d"),
    ("kernels/common.py", "rexp_sigma"),
    ("kernels/common.py", "lut2d_sigma_int"),
    ("kernels/lut_attention/sharded_paged.py", "slab_sigma"),
    ("kernels/lut_attention/sharded_paged.py", "sigma_from_terms"),
})
#: where int8 pool pages may become float: the plain versions' dequant
INT8_EXITS = frozenset({("core/quantization.py", "dequantize_rows")})

#: operations that make the host wait for the device
SYNC_OPS = frozenset({"aten::_local_scalar_dense", "aten::nonzero",
                      "aten::masked_select", "aten::_unique2",
                      "aten::unique_dim", "aten::unique_consecutive",
                      "aten::item"})
#: operations whose first argument is the data and the rest indices
INDEX_OPS = frozenset({"aten::index.Tensor", "aten::index_select",
                       "aten::gather", "aten::take", "aten::embedding"})

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frame() -> tuple[str, str]:
    """The innermost frame of the port's code outside this package, as
    (module path under ``repro_torch``, function)."""
    f = sys._getframe(2)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path.startswith(_PKG + os.sep) and "analysis" not in path[
                len(_PKG):]:
            return (os.path.relpath(path, _PKG).replace(os.sep, "/"),
                    f.f_code.co_name)
        f = f.f_back
    return ("", "")


class StepRecorder(TorchDispatchMode):
    """Records what one device program does, op by op: host syncs,
    copies to the host, collectives, new tensors the size of a pool leaf,
    and integer → float conversions of the LUT datapath (taint roots: the
    integer outputs of table reads in :data:`LUT_READS`) and of the int8
    pool (roots: the pool's int8 leaves)."""

    def __init__(self, pools):
        super().__init__()
        leaves = [leaf for pool in pools for leaf in pool.values()]
        self.pool_ptrs = {leaf.untyped_storage().data_ptr()
                          for leaf in leaves}
        self.pool_shapes = {tuple(leaf.shape) for leaf in leaves}
        self.syncs: list[str] = []
        self.transfers: list[str] = []
        self.collectives: list[str] = []
        self.pool_sized: list[str] = []
        self.lut_upcasts: list[str] = []
        self.int8_upcasts: list[str] = []
        self._lut: dict[int, torch.Tensor] = {}
        self._int8: dict[int, torch.Tensor] = {
            id(x): x for x in leaves if x.dtype == torch.int8}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        full = f"{name}.{func._overloadname}" if func._overloadname not in (
            "default", "") else name
        if name in SYNC_OPS:
            self.syncs.append(full)
        if name.startswith("c10d::"):
            self.collectives.append(full)
        ins = [x for x in tree_flatten((args, kwargs))[0]
               if isinstance(x, torch.Tensor)]
        outs = [x for x in tree_flatten(out)[0]
                if isinstance(x, torch.Tensor)]
        held = {i.untyped_storage().data_ptr() for i in ins}
        for x in outs:
            if (x.device.type == "cpu" and any(i.device.type != "cpu"
                                               for i in ins)):
                self.transfers.append(f"{full} → {x.device}")
            ptr = x.untyped_storage().data_ptr()
            if (tuple(x.shape) in self.pool_shapes
                    and ptr not in self.pool_ptrs and ptr not in held):
                self.pool_sized.append(f"{full} {tuple(x.shape)}")
        data = ins[:1] if full in INDEX_OPS else ins
        for taint, exits, found, kind in (
                (self._lut, LUT_EXITS, self.lut_upcasts, "lut"),
                (self._int8, INT8_EXITS, self.int8_upcasts, "int8")):
            hot = any(id(x) in taint and not x.is_floating_point()
                      for x in data)
            if kind == "lut" and not hot and full in INDEX_OPS and ins \
                    and not ins[0].is_floating_point():
                hot = _frame() in LUT_READS
            if not hot:
                continue
            for x in outs:
                if x.is_floating_point():
                    where = _frame()
                    if where not in exits:
                        found.append(f"{kind}-upcast: {full} → {x.dtype} "
                                     f"{tuple(x.shape)} in "
                                     f"{where[0]}:{where[1]}")
                else:
                    taint[id(x)] = x
        return out


@dataclasses.dataclass(frozen=True)
class ContractSpec:
    """Declared invariants of one engine device program."""

    name: str
    topology: str            # 'single' | 'tp-heads' | 'tp-pages'
    step: str                # 'decode' | 'prefill-chunk' | 'decode-sampled'
    #                        # | 'final-chunk-sampled' | 'cow-copy'
    policy: str              # softmax impl ('rexp' | 'lut2d' | ...)
    min_donated: int = 0     # pool leaves that must keep their storage
    lut_int_clean: bool = False
    int8_dequant_clean: bool = False   # int8 → float only in dequant
    forbid_host_callbacks: bool = True  # no host sync
    forbid_host_transfers: bool = True  # no copy to the host
    forbid_logits_output: bool = False   # no (…, V) rank ≥ 2 outputs
    max_collective_tensor_bytes: int | None = None  # a layer's, in total
    max_op_tensor_bytes: tuple = ()      # ((kind, cap), ...), one record
    require_collectives: tuple = ()
    notes: str = ""


@dataclasses.dataclass
class ContractResult:
    spec: ContractSpec
    violations: list[str]
    info: dict

    @property
    def status(self) -> str:
        return "ok" if not self.violations else "violation"

    def to_dict(self) -> dict:
        return {"name": self.spec.name, "topology": self.spec.topology,
                "step": self.spec.step, "status": self.status,
                "violations": list(self.violations), "info": self.info}


@dataclasses.dataclass
class StepRun:
    """What one program did: its recorder, its return value, the pool's
    storages before and after, and the collectives it logged."""

    rec: StepRecorder
    result: object
    kept: int
    replaced: list[str]
    records: list
    on_mesh: bool = False

    @property
    def collectives(self) -> list[str]:
        """The collectives of the program: the mesh's log (a rank's
        sends of the host plan are not the program's), or on one device
        every c10d operation the recorder saw."""
        if self.on_mesh:
            return [f"{r.kind} at {r.site}" for r in self.records]
        return list(self.rec.collectives)


def check_run(spec: ContractSpec, run: StepRun, n_layers: int = PERIODS,
              vocab: int = VOCAB) -> ContractResult:
    """Evaluate one spec against one recorded run."""
    v: list[str] = []
    rec = run.rec
    if spec.min_donated:
        if run.kept < spec.min_donated:
            v.append(f"pool: {run.kept} of {spec.min_donated} leaves kept "
                     f"their storage; replaced: {run.replaced}")
        v += [f"pool: a new tensor the size of a pool leaf: {x}"
              for x in rec.pool_sized]
    if spec.forbid_host_callbacks:
        v += [f"host sync: {x}" for x in rec.syncs]
    if spec.forbid_host_transfers:
        v += [f"host transfer: {x}" for x in rec.transfers]
    if spec.lut_int_clean:
        v += rec.lut_upcasts
    if spec.int8_dequant_clean:
        v += rec.int8_upcasts
    if spec.forbid_logits_output:
        for x in tree_flatten(run.result)[0]:
            if (isinstance(x, torch.Tensor) and x.dim() >= 2
                    and x.shape[-1] == vocab):
                v.append(f"logits escape: {tuple(x.shape)}")
    layer = sum(r.nbytes for r in run.records
                if r.site not in ("embed", "head")) / n_layers
    if spec.max_collective_tensor_bytes is not None:
        if spec.max_collective_tensor_bytes == 0 and run.collectives:
            v.append(f"collectives: {run.collectives}, budget 0")
        elif layer > spec.max_collective_tensor_bytes:
            v.append(f"collectives: move {layer:g} B a layer, budget is "
                     f"{spec.max_collective_tensor_bytes} B")
    for kind, cap in spec.max_op_tensor_bytes:
        for r in run.records:
            if r.kind.startswith(kind) and r.nbytes >= cap:
                v.append(f"collectives: {r.kind} at {r.site} moves "
                         f"{r.nbytes} B, cap is {cap} B")
    for kind in spec.require_collectives:
        if not any(r.kind.startswith(kind) for r in run.records):
            v.append(f"collectives: required {kind} never appears")
    info = {"donated": run.kept,
            "collective_tensor_bytes": int(sum(r.nbytes
                                               for r in run.records)),
            "collective_count": len(run.records)}
    return ContractResult(spec=spec, violations=v, info=info)


# ---------------------------------------------------------------------------
# Engine steps (the engine's own device programs)
# ---------------------------------------------------------------------------


def build_engine(*, pipelined: bool, impl: str, mesh=None, kvh=None,
                 kv_dtype: str = "f32", device="cuda"):
    """(arch, engine): the test suite's small Qwen3 scale-down (d_model
    64, 4 heads, vocab 128, 2 periods) on a 30 × 8 × 8 cache, 3 slots,
    on ``mesh``'s device or ``device`` (the card unless the caller asks
    for the CPU)."""
    from repro_torch.configs import ARCHS, RunConfig
    from repro_torch.core.policies import SoftmaxPolicy
    from repro_torch.models import build_model
    from repro_torch.models.device import resolve_device
    from repro_torch.runtime.engine import (EngineConfig, PipelinedEngine,
                                            ServingEngine)
    from repro_torch.runtime.paged_cache import PagedCacheConfig
    arch = ARCHS["qwen3-32b"].scaled_down(
        d_model=D_MODEL, n_heads=HEADS, vocab=VOCAB, n_periods=PERIODS,
        **({} if kvh is None else {"n_kv_heads": kvh}))
    model = build_model(arch)
    dev = mesh.device if mesh is not None else resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen, dev)
    pol = (SoftmaxPolicy(impl=impl, precision="uint8")
           if impl != "exact" else SoftmaxPolicy())
    run = RunConfig(dtype="float32", softmax_policy=pol, kv_dtype=kv_dtype)
    cfg = EngineConfig(n_slots=N_SLOTS, cache=PagedCacheConfig(**CACHE),
                       mesh=mesh)
    cls = PipelinedEngine if pipelined else ServingEngine
    return arch, cls(model, params, run, cfg, device=dev)


def pool_leaves(eng) -> int:
    return sum(len(pool) for pool in eng.pools)


def _decode_host(eng):
    from repro_torch.runtime.paged_cache import decode_view
    return decode_view({}, eng.n_slots, eng.cache)


def _chunk_host(eng):
    from repro_torch.runtime.paged_cache import PrefillChunkView
    c, mp = eng.prefill_chunk, eng.cache.max_pages_per_seq
    return PrefillChunkView(tokens=np.zeros((1, c), np.int32),
                            block_tables=np.zeros((1, mp), np.int32),
                            cache_lens=np.zeros((1,), np.int32),
                            chunk_lens=np.ones((1,), np.int32))


def copy_pages(eng) -> tuple[int, int]:
    """The COW copy a contract runs: a page to one on the next rank's
    slab in the ``'pages'`` regime (one page of every leaf on the wire),
    else page 1 to page 2."""
    if eng.regime == "pages":
        slab = eng.pools[0]["k_pages"].shape[1] - 1
        return 1, slab + 1
    return 1, 2


def step_plan(eng, step: str) -> tuple[str, dict]:
    """The ``(op, plan)`` of ``step`` as the engine launches it."""
    if step == "decode":
        return "decode", dict(host=_decode_host(eng), max_kv_len=1)
    if step == "prefill-chunk":
        return "chunk", dict(host=_chunk_host(eng), max_kv_len=1)
    if step == "decode-sampled":
        return "decode", dict(host=_decode_host(eng), max_kv_len=1)
    if step == "final-chunk-sampled":
        return "chunk", dict(host=_chunk_host(eng), max_kv_len=1,
                             first=(0, 0, 0.0))
    if step == "cow-copy":
        return "copy", dict(copies=[copy_pages(eng)])
    raise ValueError(f"unknown contract step {step!r}")


def run_step(eng, step: str) -> StepRun:
    """Run one program through ``engine._launch`` (rank 0 of a mesh sends
    the plan; the other ranks follow) under a :class:`StepRecorder`.  On
    the card the program runs once before (its first call uploads the
    policy's tables by a pageable copy) and then under
    ``torch.cuda.set_sync_debug_mode("error")``: a step that makes the
    host wait raises."""
    op, plan = step_plan(eng, step)
    cuda = eng.device.type == "cuda"
    if cuda:
        with torch.no_grad():
            eng._launch(op, **plan)
        torch.cuda.synchronize()
    leaves = [(name, leaf) for pool in eng.pools
              for name, leaf in pool.items()]
    before = [leaf.untyped_storage().data_ptr() for _, leaf in leaves]
    if eng.mesh is not None:
        eng.mesh.log.records.clear()
    rec = StepRecorder(eng.pools)
    mode = torch.cuda.get_sync_debug_mode() if cuda else None
    try:
        if cuda:
            torch.cuda.set_sync_debug_mode("error")
        with torch.no_grad(), rec:
            result = eng._launch(op, **plan)
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(mode)
    after = [(name, leaf) for pool in eng.pools
             for name, leaf in pool.items()]
    kept = sum(a == b.untyped_storage().data_ptr() and b is leaf
               for a, (_, b), (_, leaf) in zip(before, after, leaves))
    replaced = [name for a, (name, b), (_, leaf) in zip(before, after,
                                                         leaves)
                if a != b.untyped_storage().data_ptr() or b is not leaf]
    records = list(eng.mesh.log.records) if eng.mesh is not None else []
    return StepRun(rec=rec, result=result, kept=kept, replaced=replaced,
                   records=records, on_mesh=eng.mesh is not None)


# ---------------------------------------------------------------------------
# The contract suite
# ---------------------------------------------------------------------------


def tp_budgets(arch, eng, kvh: int) -> dict:
    """The reference's decode budgets: never KV-sized, only (B, H, 1)
    partials; the COW copy at most one page a pool leaf."""
    d = arch.resolved_head_dim
    pool_bytes = CACHE["n_pages"] * CACHE["page_size"] * kvh * d * 4
    b, h = eng.n_slots, arch.n_heads
    page_bytes = PERIODS * CACHE["page_size"] * kvh * d * 4
    return {"pool_bytes": pool_bytes,
            "partial_budget": 2 * b * h * (d + 2) * 4,
            "ag_cap": pool_bytes // 4 - 1,
            "cow_budget": pool_leaves(eng) * page_bytes}


def single_device_specs(donated: dict) -> list[ContractSpec]:
    """The single-device contracts (``donated``: pool leaves by engine:
    ``sync``, ``pipelined``, ``int8``)."""
    out = []
    for step in ("decode", "prefill-chunk"):
        out.append(ContractSpec(
            name=f"single/{step}/rexp", topology="single", step=step,
            policy="rexp", min_donated=donated["sync"], lut_int_clean=True,
            max_collective_tensor_bytes=0,
            notes="pool written in place; integer-Σ REXP datapath never "
                  "upcast; no collectives on a single device"))
    out.append(ContractSpec(
        name="single/cow-copy", topology="single", step="cow-copy",
        policy="rexp", min_donated=donated["sync"],
        max_collective_tensor_bytes=0,
        notes="COW page duplicate written in place in the pool"))
    for step in ("decode-sampled", "final-chunk-sampled"):
        out.append(ContractSpec(
            name=f"single/{step}/lut2d", topology="single", step=step,
            policy="lut2d", min_donated=donated["pipelined"],
            lut_int_clean=True, forbid_logits_output=True,
            max_collective_tensor_bytes=0,
            notes="sampling on the device: token vectors out, never "
                  "(…, V) logits"))
    for step in ("decode", "prefill-chunk"):
        out.append(ContractSpec(
            name=f"single/{step}/rexp-int8", topology="single", step=step,
            policy="rexp", min_donated=donated["int8"], lut_int_clean=True,
            int8_dequant_clean=True, max_collective_tensor_bytes=0,
            notes="int8 pool: pages leave their type only in the plain "
                  "versions' dequant; scale leaves written in place"))
    out.append(ContractSpec(
        name="single/cow-copy/int8", topology="single", step="cow-copy",
        policy="rexp", min_donated=donated["int8"], int8_dequant_clean=True,
        max_collective_tensor_bytes=0,
        notes="COW duplicate moves page and scale leaves in place"))
    return out


def single_device_contracts(device="cuda") -> list[ContractResult]:
    """The contracts of one device, on ``device``: the card, where the
    paged kernels launch, unless the caller asks for the CPU (their
    plain versions)."""
    engines = {
        "sync": build_engine(pipelined=False, impl="rexp",
                             device=device)[1],
        "pipelined": build_engine(pipelined=True, impl="lut2d",
                                  device=device)[1],
        "int8": build_engine(pipelined=False, impl="rexp", kv_dtype="int8",
                             device=device)[1],
    }
    donated = {k: pool_leaves(e) for k, e in engines.items()}
    out = []
    for spec in single_device_specs(donated):
        key = ("int8" if spec.name.endswith("int8")
               else "pipelined" if spec.policy == "lut2d" else "sync")
        out.append(check_run(spec, run_step(engines[key], spec.step)))
    return out


def tp_specs(regime: str, budget: dict, donated: int,
             donated_pipe: int) -> list[ContractSpec]:
    """The contracts of one regime on the 4-rank mesh."""
    topo = f"tp-{regime}"
    require = ("all_reduce",) if regime == "pages" else ()
    ag = (("all_gather", budget["ag_cap"]),)
    return [
        ContractSpec(
            name=f"{topo}/decode/rexp", topology=topo, step="decode",
            policy="rexp", min_donated=donated, lut_int_clean=True,
            max_collective_tensor_bytes=budget["partial_budget"],
            max_op_tensor_bytes=ag, require_collectives=require,
            notes="decode exchanges only (B, H, 1) partials, never "
                  "gathered KV"),
        ContractSpec(
            name=f"{topo}/prefill-chunk/rexp", topology=topo,
            step="prefill-chunk", policy="rexp", min_donated=donated,
            lut_int_clean=True, max_op_tensor_bytes=ag,
            notes="prefill chunks may reduce activations but never "
                  "gather the KV pool"),
        ContractSpec(
            name=f"{topo}/cow-copy", topology=topo, step="cow-copy",
            policy="rexp", min_donated=donated,
            max_collective_tensor_bytes=(budget["cow_budget"] // PERIODS
                                         if regime == "pages" else 0),
            max_op_tensor_bytes=ag,
            notes="COW copy moves at most the duplicated page of each "
                  "leaf: local in 'heads', sent across slabs in "
                  "'pages' — never the pool"),
        ContractSpec(
            name=f"{topo}/decode-sampled/rexp", topology=topo,
            step="decode-sampled", policy="rexp", min_donated=donated_pipe,
            lut_int_clean=True, forbid_logits_output=True,
            max_op_tensor_bytes=ag, require_collectives=require,
            notes="sampling on the mesh: no KV-sized all-gather, token "
                  "vectors out"),
    ]


def tp_rank(mesh) -> list[dict] | None:
    """One rank of the TP half: the 'heads' (kvh 4) and 'pages' (kvh 1)
    engines, sync and pipelined; rank 0 runs each contract's program
    and checks it, the others follow its plans."""
    out = []
    for kvh, regime in ((4, "heads"), (1, "pages")):
        arch, eng = build_engine(pipelined=False, impl="rexp", mesh=mesh,
                                 kvh=kvh)
        _, pipe = build_engine(pipelined=True, impl="rexp", mesh=mesh,
                               kvh=kvh)
        specs = tp_specs(regime, tp_budgets(arch, eng, kvh),
                         pool_leaves(eng), pool_leaves(pipe))
        for e, these in ((eng, specs[:3]), (pipe, specs[3:])):
            if mesh.rank == 0:
                try:
                    for spec in these:
                        out.append(check_run(spec,
                                             run_step(e, spec.step)))
                finally:
                    e.close()
            else:
                e.follow()
    return [r.to_dict() for r in out] if mesh.rank == 0 else None


def tp_contracts(store_dir: str | None = None) -> list[dict]:
    """The TP half on 4 spawned gloo ranks on the CPU (as the reference
    self-spawns its 4-device CPU subprocess); rank 0's results as dicts.
    It stays on the CPU beside a card: gloo stages every collective of a
    CUDA tensor through the host, a synchronising copy by design, so the
    no-host-sync contract could not hold there."""
    from repro_torch.launch.mesh import start_ranks
    return start_ranks(tp_rank, 4, backend="gloo", device="cpu",
                       store_dir=store_dir).join()


# ---------------------------------------------------------------------------
# Kernel-level contracts (wrapping the static kernel guard's verdicts)
# ---------------------------------------------------------------------------


def kernel_contracts(report: dict | None = None) -> list[ContractResult]:
    """The kernel guard's verdicts as contracts, under the same report
    and ratchet as the engine steps'."""
    from repro_torch.analysis import kernel_guard
    rep = kernel_guard.check_kernels() if report is None else report
    out: list[ContractResult] = []
    for name, entry in sorted(rep["kernels"].items()):
        spec = ContractSpec(
            name=f"kernel/{name}", topology="kernel", step=entry["kind"],
            policy="all",
            notes="static kernel-guard verdict: shared memory, grid and "
                  "cluster coverage, pool-index clamps")
        info = {"geometries": sorted(entry["geometries"])}
        if entry["kind"] == "cuda":
            info["smem_bytes"] = entry["smem_bytes"]
            info["smem_limit"] = rep["smem_limit"]
        out.append(ContractResult(spec=spec,
                                  violations=list(entry["violations"]),
                                  info=info))
    for pname, p in sorted(rep["policies"].items()):
        spec = ContractSpec(
            name=f"kernel/policy/{pname}", topology="kernel", step="tables",
            policy=pname,
            notes="LUT byte census + integer-Σ overflow bound")
        out.append(ContractResult(
            spec=spec, violations=list(p["violations"]),
            info={"lut_bytes": p["lut_bytes"], "max_lk": p["max_lk"],
                  "margin": p["margin"]}))
    out.append(ContractResult(
        spec=ContractSpec(
            name="kernel/sigma-acc-limit", topology="kernel", step="global",
            policy="all",
            notes="declared Σ-accumulator types agree with the "
                  "SIGMA_ACC_LIMIT constant the bounds derive from"),
        violations=list(rep["violations"]),
        info={"sigma_acc_limit": rep["sigma_acc_limit"],
              "max_contexts": rep["max_contexts"]}))
    return out


# ---------------------------------------------------------------------------
# Report + ratchet
# ---------------------------------------------------------------------------


def build_report(results) -> dict:
    """A report of :class:`ContractResult` s (or their dicts)."""
    contracts = [r if isinstance(r, dict) else r.to_dict() for r in results]
    return {"version": REPORT_VERSION,
            "n_contracts": len(contracts),
            "n_violations": sum(len(c["violations"]) for c in contracts),
            "contracts": sorted(contracts, key=lambda d: d["name"])}


def merge_reports(*reports: dict) -> dict:
    return build_report([c for r in reports for c in r["contracts"]])


def ratchet_violations(committed: dict, fresh: dict) -> list[str]:
    """Regressions of ``fresh`` against the committed report: a contract
    may appear, stay ok or go from violating to ok — never grow its
    violation count or disappear."""
    old = {c["name"]: c for c in committed.get("contracts", ())}
    new = {c["name"]: c for c in fresh.get("contracts", ())}
    problems: list[str] = []
    for name, c_old in old.items():
        c_new = new.get(name)
        if c_new is None:
            problems.append(f"ratchet: contract {name!r} disappeared "
                            f"(was {c_old['status']})")
            continue
        n_old, n_new = len(c_old["violations"]), len(c_new["violations"])
        if n_new > n_old:
            problems.append(
                f"ratchet: {name} regressed {n_old} -> {n_new} "
                f"violation(s): {c_new['violations']}")
    return problems


def load_report(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def dump_report(report: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
