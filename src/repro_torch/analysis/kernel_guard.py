"""Static shared-memory / grid / overflow analysis of the port's CUDA
kernels — the counterpart of the JAX package's ``analysis/kernel_guard``
with Hopper's resources in place of VMEM.

Every kernel module exports a ``kernel_spec(geom)`` declaration (and
``kernel_spec_int8`` where it has an int8 entry point) built from the
kernels' OWN launch plans: the launchers take their grid, cluster,
threads and shared memory from ``csrc/launch_plan.h``, and the host C++
compiler builds the same header into ``build/kernels/liblaunch_plan.so``
(``kernels/build.py``: ``load_host``), so a kernel edit that widens a
ring, deepens a cache or re-splits the keys changes the declaration.
The row softmax plans on the host in Python (``lut_softmax.row_plan``);
its declaration is that plan, held to the launcher's own shared-memory
floor from the header.  If the host library does not build, the guard
raises.  From the declarations the guard derives:

(a) **Shared memory** — every launch at every geometry within 232 448 B
    (227 KB, a CTA's most on an H100); a dense split launch also within
    a multiprocessor's 228 KB over the CTAs it holds, less 1 KB a CTA
    (:func:`wave_cap`, from the guard's own H100 constants, not the
    plan's: its grid runs in one wave); the row kernel within its
    ``SMEM_LIMIT``.  A grid that runs in two waves is a violation unless
    :data:`KNOWN_TWO_WAVE` lists it: then the report keeps it under
    ``known_violations`` (counted in ``n_known``, not in
    ``n_violations``) and :func:`ratchet_violations` fails any known
    violation the committed report does not hold, so a new two-wave
    grid, or a known one that takes more, fails.

(b) **Integer-Σ overflow proof** — the kernels accumulate the integer Σ
    in f32 (declared per launch: ``sigma_acc`` / ``acc_dtype``), exact
    below 2^24; ``max_lk = limit // qmax`` per policy must cover every
    shipped context (:func:`shipped_max_contexts`).

(c) **Coverage** — every query row of every KV head and sequence in
    exactly one block (the kernels' ``block_rows``), every live page or
    tile in exactly one cluster rank's range (``unit_lo``), a cluster of
    at most 8 that divides ``grid.x``, block-table indices in ``[0,
    mp)`` and page ids in ``[0, n_pages)`` (``live_keys``,
    ``clamp_page``), each probed through the host library; the
    ``'pages'`` regime's page-id maps probed at slab boundaries; the
    shard_map kinds' partials within the ``(B, H, Lq)`` wire budget;
    every int8 operand beside its f32 scale operand.

(d) **LUT byte census** — per policy, entries × the paper's entry bytes
    within ``lut_builder.LUT_BYTE_BUDGET`` (1536 B).

``python -m repro_torch.analysis --check-kernels`` writes
``ANALYSIS_kernels_torch.json``; :func:`ratchet_violations` lets bounds
only improve and budgets not regress.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Callable, Mapping

import numpy as np

from repro_torch.core import lut_builder
from repro_torch.core.precision import (F32_EXACT_LIMIT, INT32_LIMIT,
                                        SIGMA_ACC_LIMIT)
from repro_torch.kernels import build

REPORT_VERSION = 1
REPORT_NAME = "ANALYSIS_kernels_torch.json"

#: the H100 SXM's multiprocessors, the count the plans are made for
N_SMS = 132
#: the most shared memory a CTA may take on an H100 (227 KB)
SMEM_LIMIT = 232448
#: an H100 multiprocessor's shared memory (228 KB), and what the system
#: reserves of it for each resident CTA (1 KB)
SM_SMEM_POOL = 233472
CTA_RESERVE = 1024
#: the largest thread-block cluster that is portable
MAX_CLUSTER = 8

#: the dense split grids known to run in two waves, (kernel, geometry,
#: launch) → why: at Qwen3-32B × decode_32k (B 128 × 8 KV heads = 1024
#: CTAs, 8 a multiprocessor, 28 160 B each for one wave) ``plan_dense``
#: reaches its last resort (one key slice, a ring of two stages, no
#: logits cache) in f32 and with the 2D-LUT tables in bf16, and that
#: still takes more
KNOWN_TWO_WAVE: dict[tuple[str, str, str], str] = {
    ("lut_attention", "smoke-qwen3-decode_32k", launch):
        "plan_dense's last resort exceeds 28 160 B a CTA at 1024 CTAs"
    for launch in ("float32/rexp/split", "float32/rexp_fused/split",
                   "float32/lut2d/split", "bfloat16/lut2d/split")
}

_DTYPE_BYTES = {"float32": 4, "int32": 4, "bfloat16": 2, "float16": 2,
                "int8": 1}

#: accumulator dtype → largest exactly-representable integer
ACC_LIMITS = {"float32": F32_EXACT_LIMIT, "int32": INT32_LIMIT}

#: the (method, precision) grid of shipped softmax policies
POLICIES = tuple((m, p) for m in ("rexp", "lut2d")
                 for p in ("int16", "uint8", "uint4", "uint2"))


# ---------------------------------------------------------------------------
# The declaration data model (kernel modules build these in kernel_spec())
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Operand:
    """One kernel operand: its logical shape and type; a table-indexed
    operand (the page pools) declares the valid range of its index."""

    name: str
    shape: tuple
    dtype: str = "float32"
    table_indexed: bool = False
    index_domain: tuple | None = None   # (lo, hi), hi exclusive
    notes: str = ""


@dataclasses.dataclass(frozen=True)
class Coverage:
    """What a launch's blocks and cluster ranks must cover: ``rows``
    query rows (G·C flattened) for each of ``kvh`` KV heads, ``rpb`` a
    block (``block_rows``); ``units`` live units (pages, or 32-key
    tiles) split over the cluster (``unit_lo``); for a paged launch the
    pool's ``n_pages`` and the block table's ``mp`` × ``ps``."""

    rows: int
    kvh: int
    rpb: int
    units: int = 0
    n_pages: int = 0
    mp: int = 0
    ps: int = 0
    paged: bool = False
    flat: bool = False   # rows over grid.x in blocks of rpb (one head a y)


@dataclasses.dataclass(frozen=True)
class LaunchSpec:
    """One launch of a CUDA kernel (the counterpart of a pallas_call
    pass): its grid, cluster, threads and shared memory, as the plan
    gives them, and what the guard checks them against."""

    name: str
    grid: tuple
    cluster: int
    threads: int
    smem: int
    inputs: tuple = ()
    outputs: tuple = ()
    coverage: Coverage | None = None
    sigma_acc: bool = False      # accumulates the integer Σ
    acc_dtype: str = "float32"   # the Σ accumulator's type
    smem_limit: int | None = None    # a kernel's own cap (row softmax)
    smem_floor: int = 0          # the least its launcher accepts
    one_wave: bool = False       # planned to run in one wave
    plan: Mapping | None = None  # the host library's plan
    notes: str = ""


@dataclasses.dataclass(frozen=True)
class Reduction:
    """A partial exchanged across ranks by a shard_map kind."""

    op: str                   # 'max' | 'sum'
    shape: tuple
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class ClampProbe:
    """A page-id map of a shard_map kind, probed numerically.

    ``fn(ids, lo, slab)`` maps physical page ids (an int32 numpy array)
    to slab-local rows.  ``mode='mask'``: every output must land in
    ``[0, slab)``.  ``mode='drop'``: non-local ids must map to exactly
    ``slab`` (the sink page past the slab), local ones to ``[0, slab)``.
    """

    name: str
    fn: Callable
    lo: int
    slab: int
    n_pages: int
    mode: str
    notes: str = ""


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One kernel module's static declaration."""

    name: str
    module: str
    kind: str                 # 'cuda' | 'shard_map'
    launches: tuple = ()      # cuda only
    reductions: tuple = ()    # shard_map cross-rank partials
    clamps: tuple = ()        # shard_map page-id probes
    wire_budget: int | None = None
    notes: str = ""


# ---------------------------------------------------------------------------
# Dispatch geometries
# ---------------------------------------------------------------------------

#: Every geometry the guard certifies: the reference's three (``test`` the
#: suite's and the contracts' scale, ``serve-default`` the serve CLI's
#: defaults, ``qwen3-32b-8k`` a production-shaped dispatch), then the
#: shapes ``chip_smoke.py`` launches.  ``lq`` / ``lk`` are the dense and
#: flash calls' rows and keys (and the row softmax's rows b·h·lq of lk
#: columns), ``chunk`` a prefill chunk, ``page_size`` × ``mp`` the block
#: table, ``lk`` also the paged calls' ``max_kv_len``.
GEOMETRIES: dict[str, dict] = {
    "test": dict(b=3, h=4, kvh=4, dh=16, lq=16, lk=64,
                 page_size=8, mp=8, n_pages=30, chunk=16, tp=4),
    "serve-default": dict(b=4, h=4, kvh=4, dh=64, lq=32, lk=256,
                          page_size=16, mp=16, n_pages=256, chunk=16, tp=4),
    "qwen3-32b-8k": dict(b=8, h=64, kvh=8, dh=128, lq=512, lk=8192,
                         page_size=16, mp=512, n_pages=4096, chunk=64, tp=4),
    # chip_smoke.py: the Qwen3-32B engine (4 slots, pages and chunks of
    # 16, prompts of up to 300 tokens + 32 new), its lockstep decode
    "smoke-qwen3-engine": dict(b=4, h=64, kvh=8, dh=128, lq=1, lk=332,
                               page_size=16, mp=32, n_pages=128, chunk=16,
                               tp=3),
    # the MoE decoders' widths (phase 5d)
    "smoke-deepseek-moe": dict(b=4, h=16, kvh=16, dh=128, lq=1, lk=332,
                               page_size=16, mp=32, n_pages=128, chunk=16,
                               tp=2),
    "smoke-granite-moe": dict(b=4, h=24, kvh=8, dh=64, lq=1, lk=332,
                              page_size=16, mp=32, n_pages=128, chunk=16,
                              tp=2),
    # Whisper-small's decoder: cross-attention decode over 1500 frames,
    # self-attention decode, and the encoder's 1500 × 1500 call
    "smoke-whisper-cross": dict(b=4, h=12, kvh=12, dh=64, lq=1, lk=1500,
                                page_size=16, mp=94, n_pages=400, chunk=16,
                                tp=2),
    "smoke-whisper-self": dict(b=4, h=12, kvh=12, dh=64, lq=1, lk=64,
                               page_size=16, mp=4, n_pages=16, chunk=16,
                               tp=2),
    "smoke-whisper-encoder": dict(b=4, h=12, kvh=12, dh=64, lq=1500,
                                  lk=1500, page_size=16, mp=94, n_pages=400,
                                  chunk=16, tp=2),
    # Jamba-v0.1-52B's prompt call (64 rows over a 96-position cache)
    "smoke-jamba": dict(b=4, h=32, kvh=8, dh=128, lq=64, lk=96,
                        page_size=16, mp=6, n_pages=32, chunk=16, tp=2),
    # the eval step's call (511 rows over 511 keys)
    "smoke-qwen3-eval": dict(b=4, h=64, kvh=8, dh=128, lq=511, lk=511,
                             page_size=16, mp=32, n_pages=160, chunk=16,
                             tp=2),
    # the reference's cells on the card: Qwen3-32B × decode_32k and
    # Jamba × long_500k, one decode step each
    "smoke-qwen3-decode_32k": dict(b=128, h=64, kvh=8, dh=128, lq=1,
                                   lk=32768, page_size=16, mp=2048,
                                   n_pages=262144, chunk=16, tp=2),
    "smoke-jamba-long_500k": dict(b=1, h=32, kvh=8, dh=128, lq=1,
                                  lk=524288, page_size=16, mp=32768,
                                  n_pages=32769, chunk=16, tp=2),
}


def kernel_registry(geom: Mapping) -> dict[str, KernelSpec]:
    """Every kernel module's declarations at one geometry (with
    ``kernel_spec_int8`` where a module has an int8 entry point)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.lut_attention import (lut_attention,
                                                   paged_decode,
                                                   paged_prefill,
                                                   sharded_decode,
                                                   sharded_paged)
    from repro_torch.kernels.lut_softmax import lut_softmax
    mods = (lut_attention, paged_decode, paged_prefill, sharded_decode,
            sharded_paged, lut_softmax, flash_attention)
    specs = [m.kernel_spec(geom) for m in mods]
    specs += [m.kernel_spec_int8(geom) for m in mods
              if hasattr(m, "kernel_spec_int8")]
    return {s.name: s for s in specs}


# ---------------------------------------------------------------------------
# Declaration helpers the kernel modules share
# ---------------------------------------------------------------------------

#: per method, the largest tables of its precisions (the most shared
#: memory a launch of the method takes): ``(n_main, aux_rows, aux_cols)``
def method_tables(method: str) -> tuple[int, int, int]:
    from repro_torch.kernels.common import policy_kernel_tables
    best = None
    for m, prec in POLICIES:
        if m != method:
            continue
        tables = (lut_builder.build_rexp_tables(prec) if m == "rexp"
                  else lut_builder.build_lut2d_tables(prec))
        main, aux = policy_kernel_tables(m, tables)[:2]
        aux = np.atleast_2d(aux)
        size = (int(np.size(main)), aux.shape[0], aux.shape[1])
        if best is None or size[0] + size[1] * size[2] > (
                best[0] + best[1] * best[2]):
            best = size
    return best


def launch_of(name: str, plan: Mapping, **kw) -> LaunchSpec:
    """A :class:`LaunchSpec` from a host-library plan."""
    return LaunchSpec(name=name, grid=(plan["grid_x"], plan["grid_y"],
                                       plan["grid_z"]),
                      cluster=plan["cluster"], threads=plan["threads"],
                      smem=plan["smem"], plan=dict(plan), **kw)


def paged_launches(kernel: str, geom: Mapping, int8: bool,
                   c: int) -> tuple:
    """The paged decode (``c`` 1) or prefill (a ``c``-row chunk)
    launches at ``geom``: f32 and bf16 queries, each method's largest
    tables, on f32/bf16 pools or (``int8``) an int8 pool with f32 scales;
    planned for ``lk`` live keys (the engine's ``max_kv_len``) and for
    the block table's whole width (none given)."""
    b, h, kvh, dh = geom["b"], geom["h"], geom["kvh"], geom["dh"]
    ps, mp, n_pages = geom["page_size"], geom["mp"], geom["n_pages"]
    out = []
    for dt, dname in ((0, "float32"), (1, "bfloat16")):
        kdt = "int8" if int8 else dname
        for method in ("rexp", "lut2d"):
            main, ar, ac = method_tables(method)
            for live in sorted({min(geom["lk"], mp * ps), 0}):
                ins = [dt, int(int8), b, h, kvh, c, dh, n_pages, ps, mp,
                       main, ar, ac, live, 0, N_SMS]
                plan = build.host_plan(kernel, ins)
                if plan is None:
                    raise ValueError(f"{kernel}: the launcher refuses {ins}")
                ops = [Operand("q", (b, h, c, dh), dname),
                       Operand("k_pages", (n_pages, ps, kvh, dh), kdt,
                               table_indexed=True,
                               index_domain=(0, n_pages)),
                       Operand("v_pages", (n_pages, ps, kvh, dh), kdt,
                               table_indexed=True,
                               index_domain=(0, n_pages)),
                       Operand("block_tables", (b, mp), "int32",
                               table_indexed=True, index_domain=(0, mp)),
                       Operand("kv_lens", (b,), "int32")]
                if int8:
                    ops += [Operand("k_scales", (n_pages, ps, kvh)),
                            Operand("v_scales", (n_pages, ps, kvh))]
                units = max(-(-(live or mp * ps) // ps), 1)
                out.append(launch_of(
                    f"{dname}/{method}/live{live or 'table'}", plan,
                    inputs=tuple(ops),
                    outputs=(Operand("out", (b, h, c, dh)),),
                    coverage=Coverage(rows=h // kvh * c, kvh=kvh,
                                      rpb=plan["rows_per_block"],
                                      units=units, n_pages=n_pages, mp=mp,
                                      ps=ps, paged=True),
                    sigma_acc=True, acc_dtype="float32"))
    return tuple(out)


# ---------------------------------------------------------------------------
# (a) shared memory, (c) coverage — through the host library
# ---------------------------------------------------------------------------


def _block_rows(y: int, kvh: int, rpb: int, rows: int) -> tuple:
    import ctypes
    out = (ctypes.c_int * 3)()
    build.load_host().launch_plan_block_rows(y, kvh, rpb, rows, out)
    return tuple(out)


def _smem_violations(kname: str, ls: LaunchSpec,
                     consts: Mapping) -> list[str]:
    out = []
    limit = min(SMEM_LIMIT, consts["smem_limit"])
    if ls.smem > limit:
        out.append(f"{kname}/{ls.name}: {ls.smem} B of shared memory "
                   f"exceeds a CTA's {limit} B")
    if ls.smem_limit is not None and ls.smem > ls.smem_limit:
        out.append(f"{kname}/{ls.name}: {ls.smem} B exceeds the kernel's "
                   f"own limit {ls.smem_limit} B")
    if ls.smem < ls.smem_floor:
        out.append(f"{kname}/{ls.name}: {ls.smem} B is below the "
                   f"{ls.smem_floor} B its launcher requires")
    if ls.one_wave and not fits_one_wave(ls):
        out.append(f"{kname}/{ls.name}: {ls.smem} B a CTA does not let "
                   f"{math.prod(ls.grid)} CTAs run in one wave (at most "
                   f"{wave_cap(ls)} B): two waves")
    return out


def wave_cap(ls: LaunchSpec) -> int:
    """The most shared memory a CTA of ``ls``'s grid may take for the
    grid to run in one wave on the H100's :data:`N_SMS` multiprocessors:
    a multiprocessor's pool over the CTAs each then holds, less what the
    system reserves for each."""
    per_sm = -(-math.prod(ls.grid) // N_SMS)
    return SM_SMEM_POOL // per_sm - CTA_RESERVE


def fits_one_wave(ls: LaunchSpec) -> bool:
    return ls.smem <= wave_cap(ls)


def _coverage_violations(kname: str, ls: LaunchSpec) -> list[str]:
    """Rows over blocks, units over cluster ranks, the cluster."""
    out = []
    if not 1 <= ls.cluster <= MAX_CLUSTER or ls.grid[0] % ls.cluster:
        out.append(f"{kname}/{ls.name}: cluster {ls.cluster} must be 1 … "
                   f"{MAX_CLUSTER} and divide grid.x {ls.grid[0]}")
    cov = ls.coverage
    if cov is None:
        return out
    if cov.flat:
        seen = np.zeros(cov.rows, np.int64)
        for x in range(ls.grid[0]):
            lo = x * cov.rpb
            seen[lo:min(lo + cov.rpb, cov.rows)] += 1
        if ls.grid[1] != cov.kvh or not (seen == 1).all():
            out.append(f"{kname}/{ls.name}: {int((seen != 1).sum())} of "
                       f"{cov.rows} rows not in exactly one block")
        return out
    seen = np.zeros((cov.kvh, cov.rows), np.int64)
    for y in range(ls.grid[1]):
        head, row0, nrows = _block_rows(y, cov.kvh, cov.rpb, cov.rows)
        if nrows <= 0 or not 0 <= head < cov.kvh:
            out.append(f"{kname}/{ls.name}: block {y} serves KV head "
                       f"{head}, {nrows} rows")
            break
        seen[head, row0:row0 + nrows] += 1
    if not (seen == 1).all():
        out.append(f"{kname}/{ls.name}: {int((seen != 1).sum())} (KV head, "
                   f"row) pairs not in exactly one block")
    ns = ls.cluster
    for nu in sorted({0, 1, ns - 1, ns, ns + 1, cov.units}):
        if nu < 0:
            continue
        bounds = [build.load_host().launch_plan_unit_lo(r, nu, ns)
                  for r in range(ns + 1)]
        if bounds[0] != 0 or bounds[-1] != nu or any(
                a > b for a, b in zip(bounds, bounds[1:])):
            out.append(f"{kname}/{ls.name}: the cluster's ranges "
                       f"{bounds} do not split {nu} units once each")
    if cov.paged:
        out += _page_violations(kname, ls.name, cov)
    return out


def _page_violations(kname: str, lname: str, cov: Coverage) -> list[str]:
    """Block-table entries clamped into the pool, live keys into the
    table: probed at the domains' edges and past them."""
    out = []
    host = build.load_host()
    n = cov.n_pages
    for pid in (-(1 << 31), -1, 0, n - 1, n, (1 << 31) - 1):
        got = host.launch_plan_clamp_page(pid, n)
        if not 0 <= got < n:
            out.append(f"{kname}/{lname}: page id {pid} reads page {got} "
                       f"outside [0, {n})")
    cap = cov.mp * cov.ps
    for kv in (-(1 << 31), -1, 0, 1, cap - 1, cap, cap + 1, (1 << 31) - 1):
        live = host.launch_plan_live_keys(kv, cov.mp, cov.ps)
        last = (live - 1) // cov.ps if live else 0
        if not 0 <= live <= cap or not 0 <= last < cov.mp:
            out.append(f"{kname}/{lname}: kv_len {kv} walks {live} keys, "
                       f"table entry {last} outside [0, {cov.mp})")
    return out


def _operand_violations(kname: str, ls: LaunchSpec) -> list[str]:
    out = []
    scales = {op.name for op in ls.inputs
              if op.dtype == "float32" and "scale" in op.name}
    for op in ls.inputs:
        if op.table_indexed and op.index_domain is None:
            out.append(f"{kname}/{ls.name}: input {op.name!r} is "
                       f"table-indexed but declares no index_domain")
        if op.dtype == "int8":
            want = op.name.split("_")[0] + "_scales"
            if want not in scales:
                out.append(f"{kname}/{ls.name}: int8 operand {op.name!r} "
                           f"has no float32 scale operand {want!r}")
    return out


def probe_ids(probe: ClampProbe) -> list[int]:
    """The page ids a probe is evaluated at: the slab's edges and middle,
    its neighbours, and the pool's first and last page."""
    lo, slab, n = probe.lo, probe.slab, probe.n_pages
    return sorted({i for i in (0, lo - 1, lo, lo + slab // 2, lo + slab - 1,
                               lo + slab, n - 1) if 0 <= i < n})


def clamp_rows(probe: ClampProbe) -> list[int]:
    """A probe's rows at :func:`probe_ids`."""
    ids = np.asarray(probe_ids(probe), np.int32)
    return np.asarray(probe.fn(ids, probe.lo, probe.slab)).tolist()


def _clamp_violations(kname: str, probe: ClampProbe) -> list[str]:
    """Probe a shard_map page-id map at slab boundaries."""
    lo, slab = probe.lo, probe.slab
    out: list[str] = []
    for i, g in zip(probe_ids(probe), clamp_rows(probe)):
        local = lo <= i < lo + slab
        if local and not 0 <= g < slab:
            out.append(f"{kname}/{probe.name}: local page {i} maps to "
                       f"row {g} outside the slab [0, {slab})")
        elif not local:
            if probe.mode == "drop" and g != slab:
                out.append(f"{kname}/{probe.name}: non-local page {i} maps "
                           f"to row {g}, want the sink row {slab}")
            if probe.mode == "mask" and not 0 <= g < slab:
                out.append(f"{kname}/{probe.name}: non-local page {i} maps "
                           f"to row {g} outside [0, {slab}) — masked reads "
                           f"must still hit a real row")
    return out


# ---------------------------------------------------------------------------
# (b) integer-Σ overflow proof  +  (d) LUT byte census
# ---------------------------------------------------------------------------


def declared_acc_limit(registries) -> int:
    """The narrowest Σ accumulator any declared launch uses."""
    limits = [ACC_LIMITS[ls.acc_dtype]
              for reg in registries for ks in reg.values()
              for ls in ks.launches if ls.sigma_acc]
    return min(limits) if limits else SIGMA_ACC_LIMIT


def shipped_max_contexts() -> dict[str, int]:
    """Every serving configuration's max keys a row, by source: the
    engine's default cache, the contract suite's, and the serving
    benchmark's pool geometry (10 pages of 8)."""
    from repro_torch.analysis import contracts
    from repro_torch.runtime.paged_cache import PagedCacheConfig
    return {
        "engine-default": PagedCacheConfig().max_context,
        "contracts-suite": PagedCacheConfig(**contracts.CACHE).max_context,
        "bench-serving": 10 * 8,
    }


def policy_ledger(acc_limit: int,
                  max_contexts: Mapping[str, int] | None = None) -> dict:
    """Per-policy LUT census + derived max-Lk overflow bound + verdicts."""
    ctxs = dict(max_contexts if max_contexts is not None
                else shipped_max_contexts())
    need = max(ctxs.values())
    ledger: dict[str, dict] = {}
    for method, prec in POLICIES:
        tables = (lut_builder.build_rexp_tables(prec) if method == "rexp"
                  else lut_builder.build_lut2d_tables(prec))
        census = lut_builder.table_census(tables)
        max_lk = acc_limit // census["qmax"]
        violations: list[str] = []
        if census["lut_bytes"] > lut_builder.LUT_BYTE_BUDGET:
            violations.append(
                f"{method}/{prec}: LUT census {census['lut_bytes']} B "
                f"exceeds the paper budget {lut_builder.LUT_BYTE_BUDGET} B")
        if max_lk < need:
            violations.append(
                f"{method}/{prec}: integer-Σ overflow bound max_lk="
                f"{max_lk} is below a shipped max_context "
                f"({ {k: v for k, v in ctxs.items() if v > max_lk} })")
        ledger[f"{method}/{prec}"] = {
            **census,
            "method": method,
            "max_lk": max_lk,
            "margin": max_lk - need,
            "violations": violations,
        }
    return ledger


# ---------------------------------------------------------------------------
# Per-kernel checks + the report
# ---------------------------------------------------------------------------


def check_kernel(ks: KernelSpec, consts: Mapping | None = None,
                 geometry: str = "") -> tuple[list, list, dict]:
    """(violations, known violations, info) of one kernel declaration at
    ``geometry`` (:data:`KNOWN_TWO_WAVE` names its known ones)."""
    consts = build.plan_constants() if consts is None else consts
    violations: list[str] = []
    known: list[str] = []
    info: dict = {"kind": ks.kind}
    if ks.kind == "cuda":
        launches: dict[str, dict] = {}
        for ls in ks.launches:
            launches[ls.name] = {"smem": ls.smem, "grid": list(ls.grid),
                                 "cluster": ls.cluster,
                                 "threads": ls.threads}
            listed = (ks.name, geometry, ls.name) in KNOWN_TWO_WAVE
            found = _smem_violations(ks.name, ls, consts)
            if ls.one_wave and not fits_one_wave(ls):
                launches[ls.name]["waves"] = 2
                if listed:
                    waves = [v for v in found if v.endswith("two waves")]
                    known += waves
                    found = [v for v in found if v not in waves]
            elif listed:
                found.append(f"{ks.name}/{ls.name}: KNOWN_TWO_WAVE lists "
                             f"it, yet it runs in one wave: take it off "
                             f"the list")
            violations += found
            violations += _coverage_violations(ks.name, ls)
            violations += _operand_violations(ks.name, ls)
        info["smem_bytes"] = max((v["smem"] for v in launches.values()),
                                 default=0)
        info["launches"] = launches
    elif ks.kind == "shard_map":
        wire = sum(math.prod(r.shape) * _DTYPE_BYTES[r.dtype]
                   for r in ks.reductions)
        info["wire_bytes"] = wire
        info["reductions"] = [f"{r.op}{list(r.shape)}" for r in ks.reductions]
        if ks.wire_budget is not None and wire > ks.wire_budget:
            violations.append(
                f"{ks.name}: reduction partials {wire} B exceed the "
                f"(B, H, Lq) wire budget {ks.wire_budget} B — a KV-sized "
                f"tensor is crossing the mesh")
        for probe in ks.clamps:
            violations += _clamp_violations(ks.name, probe)
        info["clamps"] = [p.name for p in ks.clamps]
    else:
        violations.append(f"{ks.name}: unknown kernel kind {ks.kind!r}")
    return violations, known, info


def check_kernels(geometries: Mapping[str, Mapping] | None = None) -> dict:
    """Run the full guard; returns the ``ANALYSIS_kernels_torch.json``
    report.  Raises when the host plan library does not build."""
    geoms = dict(geometries if geometries is not None else GEOMETRIES)
    consts = build.plan_constants()
    registries = {name: kernel_registry(g) for name, g in geoms.items()}
    acc_limit = declared_acc_limit(registries.values())
    violations_total: list[str] = []
    if acc_limit != SIGMA_ACC_LIMIT:
        violations_total.append(
            f"declared Σ-accumulator limit {acc_limit} disagrees with "
            f"core.precision.SIGMA_ACC_LIMIT={SIGMA_ACC_LIMIT} — a kernel "
            f"changed its accumulator type; update the constant and the "
            f"committed bounds deliberately")
    if consts["smem_limit"] != SMEM_LIMIT:
        violations_total.append(
            f"the kernels' kSmemLimit {consts['smem_limit']} is not the "
            f"H100's {SMEM_LIMIT} B a CTA")
    if (consts["sm_pool"], consts["cta_reserve"]) != (SM_SMEM_POOL,
                                                      CTA_RESERVE):
        violations_total.append(
            f"the kernels' kSmPool / kCtaReserve {consts['sm_pool']} / "
            f"{consts['cta_reserve']} are not the H100's {SM_SMEM_POOL} / "
            f"{CTA_RESERVE} B")

    ctxs = shipped_max_contexts()
    policies = policy_ledger(acc_limit, ctxs)

    kernels: dict[str, dict] = {}
    for gname, reg in registries.items():
        for kname, ks in reg.items():
            entry = kernels.setdefault(
                kname, {"kind": ks.kind, "geometries": {}, "violations": [],
                        "known_violations": []})
            v, known, info = check_kernel(ks, consts, gname)
            entry["geometries"][gname] = info
            entry["violations"] += [f"[{gname}] {x}" for x in v]
            entry["known_violations"] += [f"[{gname}] {x}" for x in known]
    for entry in kernels.values():
        entry["status"] = "ok" if not entry["violations"] else "violation"
        if entry["kind"] == "cuda":
            entry["smem_bytes"] = max(
                g.get("smem_bytes", 0) for g in entry["geometries"].values())

    n_viol = (len(violations_total)
              + sum(len(p["violations"]) for p in policies.values())
              + sum(len(k["violations"]) for k in kernels.values()))
    return {
        "version": REPORT_VERSION,
        "n_sms": N_SMS,
        "sigma_acc_limit": acc_limit,
        "smem_limit": SMEM_LIMIT,
        "plan_constants": dict(consts),
        "lut_byte_budget": lut_builder.LUT_BYTE_BUDGET,
        "max_contexts": ctxs,
        "policies": policies,
        "kernels": kernels,
        "violations": violations_total,
        "n_violations": n_viol,
        "n_known": sum(len(k["known_violations"]) for k in kernels.values()),
    }


# ---------------------------------------------------------------------------
# Ratchet + (de)serialization
# ---------------------------------------------------------------------------


def ratchet_violations(committed: dict, fresh: dict) -> list[str]:
    """Regressions of ``fresh`` against the committed kernels report.

    Bounds may only improve, budgets may not regress: policies and
    kernels may not disappear, per-policy ``max_lk`` may not decrease and
    ``lut_bytes`` may not grow, a kernel's largest shared memory may not
    grow, ok may not become violation, no known violation may appear
    that the committed report does not hold (a new two-wave grid, or a
    known one that takes more), and the shared-memory / LUT budgets may
    not shrink under the committed guarantees."""
    out: list[str] = []
    for field in ("smem_limit", "lut_byte_budget", "sigma_acc_limit"):
        if fresh.get(field, 0) < committed.get(field, 0):
            out.append(f"kernel-ratchet: {field} shrank "
                       f"{committed[field]} -> {fresh[field]}")
    old_ctx = committed.get("max_contexts", {})
    for name, ctx in fresh.get("max_contexts", {}).items():
        if name in old_ctx and ctx > old_ctx[name]:
            out.append(f"kernel-ratchet: max_context[{name}] grew "
                       f"{old_ctx[name]} -> {ctx}; re-record with --update "
                       f"after checking the per-policy margins")
    for name, old in committed.get("policies", {}).items():
        new = fresh.get("policies", {}).get(name)
        if new is None:
            out.append(f"kernel-ratchet: policy {name!r} disappeared")
            continue
        if new["max_lk"] < old["max_lk"]:
            out.append(f"kernel-ratchet: {name} overflow bound regressed "
                       f"max_lk {old['max_lk']} -> {new['max_lk']}")
        if new["lut_bytes"] > old["lut_bytes"]:
            out.append(f"kernel-ratchet: {name} LUT census grew "
                       f"{old['lut_bytes']} -> {new['lut_bytes']} B")
        if len(new["violations"]) > len(old["violations"]):
            out.append(f"kernel-ratchet: {name} regressed to "
                       f"{new['violations']}")
    for name, old in committed.get("kernels", {}).items():
        new = fresh.get("kernels", {}).get(name)
        if new is None:
            out.append(f"kernel-ratchet: kernel {name!r} disappeared")
            continue
        if old.get("status") == "ok" and new.get("status") != "ok":
            out.append(f"kernel-ratchet: kernel {name} went ok -> "
                       f"violation: {new['violations'][:3]}")
        for v in sorted(set(new.get("known_violations", ()))
                        - set(old.get("known_violations", ()))):
            out.append(f"kernel-ratchet: kernel {name} has a known "
                       f"violation the committed report does not: {v}")
        if new.get("smem_bytes", 0) > old.get("smem_bytes", 0):
            out.append(f"kernel-ratchet: kernel {name} shared memory grew "
                       f"{old['smem_bytes']} -> {new['smem_bytes']} B")
        for gname in old.get("geometries", {}):
            if gname not in new.get("geometries", {}):
                out.append(f"kernel-ratchet: kernel {name} geometry "
                           f"{gname!r} disappeared")
    return out


def load_report(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def dump_report(report: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
