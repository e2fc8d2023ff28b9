"""Meshes over ``torch.distributed``: the placement rules of the weights,
the batch and the page pools, and the collectives.

The counterpart of the JAX package's ``runtime/partitioning.py``.  JAX
runs a mesh from one controller and lets ``shard_map`` / XLA run the
per-device programs; here each rank is a process of its own over a
``torch.distributed`` process group, and a :class:`Mesh` is one rank's
view of it: the named axes ``('data', 'model')`` (serving is
``data = 1``) or ``('pipe',)`` (GPipe), this rank's index on each, and a
process group per axis.  Ranks are laid out in the JAX package's
row-major device order, rank = ``d · model + m``.  ``tp``, ``rank`` and
``group`` are the ``'model'`` axis's view, the one the serving path
reads.  For serving, rank 0 owns the scheduler and sends each device
program's host plan to the other ranks (:func:`send_plan` /
:func:`recv_plan`), so the ranks run the same programs in the same order
and meet at the same collectives.

Placement, as in the JAX package:

* :func:`param_pspec` is the JAX package's whole rule table (``_RULES``
  resolved by ``_resolve``): ``'F'`` slots take ``'data'`` (FSDP, with
  ``fsdp=True``), ``'M'`` slots ``'model'``, each only where its
  dimension divides the axis; an MoE's stacked experts take ``'model'``
  on the expert dim when the expert count divides it, else on each
  expert's ``d_expert`` (``"EPTP"``); any other matrix takes ``'data'``
  and ``'model'`` on its last two dims.
* :func:`shard_pspec` is the cut this port makes of a leaf: the rule's
  ``'data'`` slots, and its ``'model'`` slots on the leaves whose
  layers compute on a cut (:data:`TP_LEAVES`; attention only when both
  head counts divide ``tp`` — the ``'heads'`` regime — else its leaves
  stay whole).  :func:`shard_params` cuts a tree by it: the serving
  weights with ``fsdp=False``, the training state with ``fsdp=True``
  (:class:`Layout`, which also gathers a leaf's ``'data'`` cut just
  before the leaf is used).
* :func:`batch_pspec`: a batch's rows over ``'data'`` when it divides.
* the page pools split their KV-head axis over the ``'model'`` ranks
  when the arch's KV-head count divides ``tp`` (the ``'heads'``
  regime), else their physical-page axis (``'pages'``: each rank owns a
  slab of ``n_pages / tp`` pages, plus one sink page here that takes the
  writes of pages it does not own — see :func:`local_pool_specs`); an
  int8 pool's scales shard with their pages.

Every collective goes through the helpers below, which record each
op's site, kind, shape and bytes in the mesh's :class:`CollectiveLog` —
the port's counterpart of the JAX package's check of the collectives in
the compiled HLO.  Training differentiates through them with the
autograd operators :func:`copy_to` (identity forward, all-reduce
backward), :func:`reduce_from` (all-reduce forward, identity backward)
and :func:`gather_from` (all-gather forward; backward the rank's slice,
summed over the axis first for a weight gathered over ``'data'``).
With the ``gloo`` backend a CUDA tensor is staged through the host
explicitly (gloo works on host memory); ``nccl`` works on the device
tensors.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import pickle

import numpy as np
import torch
import torch.distributed as dist

Tensor = torch.Tensor

BACKENDS = ("nccl", "gloo")


# ---------------------------------------------------------------------------
# The mesh and its collective log
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Collective:
    """One recorded collective: where it ran (``site``), what it was
    (``kind``), the shape and dtype of the tensor that crossed, and its
    bytes (an all-gather counts its gathered output, an all-reduce the
    reduced tensor, a send or receive the page it moved)."""

    site: str
    kind: str
    shape: tuple[int, ...]
    dtype: str
    nbytes: int


class CollectiveLog:
    """The collectives a rank ran, in order (``records``); ``plans``
    counts the host plans sent or received."""

    def __init__(self):
        self.records: list[Collective] = []
        self.plans = 0

    def add(self, site: str, kind: str, x: Tensor) -> None:
        self.records.append(Collective(site, kind, tuple(x.shape),
                                       str(x.dtype).removeprefix("torch."),
                                       x.numel() * x.element_size()))

    def clear(self) -> None:
        self.records.clear()
        self.plans = 0

    def nbytes(self, *sites: str) -> int:
        """Bytes of the records at ``sites`` (every record without)."""
        return sum(r.nbytes for r in self.records
                   if not sites or r.site in sites)

    def by_site(self) -> dict[str, int]:
        """Bytes by site, in the order the sites first ran."""
        out: dict[str, int] = {}
        for r in self.records:
            out[r.site] = out.get(r.site, 0) + r.nbytes
        return out


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a mesh.

    ``tp`` / ``rank`` / ``group`` are the ``'model'`` axis: its size,
    this rank's index on it and the group of ranks that differ only
    there (``backend``: ``nccl`` or ``gloo``).  ``data`` / ``data_rank``
    / ``data_group`` are the ``'data'`` axis; ``pipe > 0`` makes a
    ``('pipe',)`` mesh of that many stages instead (``tp`` and ``data``
    are then 1).  ``plan_group`` is a gloo group for the serving host
    plans.  An axis of size 1 has no group: nothing is cut over it and
    no collective runs."""

    tp: int
    rank: int
    device: torch.device
    backend: str
    group: object = None
    plan_group: object = None
    log: CollectiveLog = dataclasses.field(default_factory=CollectiveLog)
    data: int = 1
    data_rank: int = 0
    data_group: object = None
    pipe: int = 0
    pipe_rank: int = 0
    pipe_group: object = None

    @property
    def axis_names(self) -> tuple[str, ...]:
        return ("pipe",) if self.pipe else ("data", "model")

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes by name (the JAX mesh's ``shape``)."""
        if self.pipe:
            return {"pipe": self.pipe}
        return {"data": self.data, "model": self.tp}

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's index along ``axis`` (``axis_index``)."""
        return {"data": self.data_rank, "model": self.rank,
                "pipe": self.pipe_rank}[axis]

    def group_of(self, axis: str):
        return {"data": self.data_group, "model": self.group,
                "pipe": self.pipe_group}[axis]

    @property
    def world_rank(self) -> int:
        """Row-major rank: ``d · model + m`` (the pipe index on a pipe
        mesh)."""
        return self.pipe_rank if self.pipe else (
            self.data_rank * self.tp + self.rank)


def mesh_model_tp(mesh: Mesh | None) -> int:
    """Tensor-parallel degree of a mesh: 1 without one — the single guard
    shared by every TP consumer (pool placement, the paged dispatch
    regime, the scheduler's slab interleave, pool-shape padding)."""
    return 1 if mesh is None else int(mesh.tp)


def divides(mesh: Mesh | None, dim: int) -> bool:
    """True when ``dim`` splits evenly over a mesh of ``tp > 1`` ranks —
    the divisibility guard of every placement rule."""
    tp = mesh_model_tp(mesh)
    return tp > 1 and dim % tp == 0


# ---------------------------------------------------------------------------
# Active-mesh context (read by the layers)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Scope:
    """What the layers read of the mesh they run under: the mesh, whether
    the weights are this rank's cut (``cut``: ``shard_params``), whether
    the batch's rows are cut over ``'data'`` (``tokens``: an MoE then
    routes over the global token groups), and the training
    :class:`Layout` whose ``'data'`` cuts are gathered before use."""

    mesh: Mesh | None = None
    cut: bool = False
    tokens: bool = False
    layout: "Layout | None" = None


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("active_scope",
                                                         default=Scope())


def set_active_mesh(mesh: Mesh | None) -> None:
    """Make ``mesh`` the active mesh of this thread's context."""
    _ACTIVE.set(Scope(mesh))


def active_mesh() -> Mesh | None:
    return _ACTIVE.get().mesh


def active_scope() -> Scope:
    return _ACTIVE.get()


@contextlib.contextmanager
def mesh_scope(mesh: Mesh | None, *, cut: bool = False,
               tokens: bool = False, layout: "Layout | None" = None):
    """``mesh`` active inside the block (with :class:`Scope`'s flags),
    the previous scope restored after (a single-device engine in the
    same process is unaffected)."""
    token = _ACTIVE.set(Scope(mesh, cut, tokens, layout))
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def keep_scope(fn):
    """``fn`` that runs under the scope active now, wherever it is called
    from: a remat's recomputation runs in the backward, on autograd's
    thread, where the caller's context is not."""
    scope = active_scope()

    def run(*args):
        token = _ACTIVE.set(scope)
        try:
            return fn(*args)
        finally:
            _ACTIVE.reset(token)
    return run


# ---------------------------------------------------------------------------
# Page-pool placement
# ---------------------------------------------------------------------------


def _regime(mesh: Mesh | None, n_kv_heads: int) -> str | None:
    """``ops.paged_mesh_regime``'s answer, for the placement rules here."""
    tp = mesh_model_tp(mesh)
    if tp <= 1:
        return None
    return "heads" if n_kv_heads % tp == 0 else "pages"


def paged_pool_pspec(mesh: Mesh | None, n_kv_heads: int,
                     scales: bool = False) -> tuple:
    """Spec of one layer's page-major pool ``(n_pages, ps, KVH, Dh)`` —
    for ``scales`` its f32 scale leaf ``(n_pages, ps, KVH)`` — written as
    the JAX package's ``PartitionSpec``: the axis that ``'model'`` (the
    ranks) splits.  ``()`` is replicated."""
    regime = _regime(mesh, n_kv_heads)
    if regime is None:
        return ()
    if regime == "heads":
        return (None, None, "model") if scales else (None, None, "model",
                                                      None)
    return ("model", None, None) if scales else ("model", None, None, None)


def local_pool_specs(specs: dict[str, tuple[tuple, str]], mesh: Mesh | None,
                     n_kv_heads: int) -> dict[str, tuple[tuple, str]]:
    """This rank's share of ``paged_cache.pool_leaf_specs(..., tp=tp)``
    (global shapes, the page axis padded to a multiple of ``tp``).

    ``'heads'``: every page, the rank's ``KVH / tp`` KV heads.
    ``'pages'``: the rank's slab of ``n_pages / tp`` pages, every KV head,
    and one **sink page** past the slab: a write to a page another rank
    owns lands there (:func:`scatter_page_ids` maps it to index
    ``slab``), so a scatter needs no data-dependent filtering; nothing
    ever reads the sink.
    """
    regime = _regime(mesh, n_kv_heads)
    if regime is None:
        return dict(specs)
    tp = mesh.tp
    out = {}
    for name, (shape, dt) in specs.items():
        shape = list(shape)
        if regime == "heads":
            shape[2] //= tp
        else:
            shape[0] = shape[0] // tp + 1
        out[name] = (tuple(shape), dt)
    return out


def slab_of(mesh: Mesh, n_pages_local: int) -> tuple[int, int]:
    """``(lo, slab)``: the first global page id of this rank's slab and
    the slab's length, from its local pool's page count (slab + sink)."""
    slab = n_pages_local - 1
    return mesh.rank * slab, slab


def gather_page_ids(bt: Tensor, lo: int, slab: int):
    """(local mask, slab-local rows) for reading a rank's page slab.

    Pages of other ranks clamp to local row 0 — a real row of the slab
    whose keys the ``local`` mask hides, so the read is safe and the
    value never contributes (``sharded_paged._gather_page_ids``)."""
    local = (bt >= lo) & (bt < lo + slab)
    return local, torch.where(local, bt - lo, torch.zeros_like(bt))


def scatter_page_ids(ph: Tensor, lo: int, slab: int) -> Tensor:
    """Slab-local rows for writing into a rank's page slab: pages of other
    ranks map to ``slab``, the sink page one past the slab, where the JAX
    package's ``mode='drop'`` discards them
    (``sharded_paged._scatter_page_ids``)."""
    local = (ph >= lo) & (ph < lo + slab)
    return torch.where(local, ph - lo, torch.full_like(ph, slab))


def page_owner(page: int, slab: int) -> int:
    """Rank that owns global page ``page`` in the ``'pages'`` regime."""
    return page // slab


# ---------------------------------------------------------------------------
# Weight placement: the JAX package's rule table
# ---------------------------------------------------------------------------

#: (name suffix, trailing ndim) → spec over the trailing dims; 'F' is
#: the FSDP axis ('data'), 'M' the tensor axis ('model'), "EPTP" the
#: third slot of an expert weight, which takes 'model' only when the
#: expert dim could not (the JAX package's ``_RULES``, letter for letter)
_RULES: list[tuple[str, int, tuple]] = [
    ("embed/table", 2, ("M", "F")),
    ("head/w", 2, ("F", "M")),
    # attention
    ("wq", 2, ("F", "M")),
    ("wk", 2, ("F", "M")),
    ("wv", 2, ("F", "M")),
    ("wo", 2, ("M", "F")),
    # dense mlp (2-D)
    ("w_gate", 2, ("F", "M")),
    ("w_up", 2, ("F", "M")),
    ("w_down", 2, ("M", "F")),
    # moe experts (3-D): EP on the expert dim, else intra-expert TP
    ("w_gate", 3, ("M", "F", "EPTP")),
    ("w_up", 3, ("M", "F", "EPTP")),
    ("w_down", 3, ("M", "EPTP", "F")),
    ("router", 2, ("F", None)),
    # mamba
    ("in_proj", 2, ("F", "M")),
    ("conv_w", 2, (None, "M")),
    ("x_proj", 2, ("M", None)),
    ("dt_proj", 2, (None, "M")),
    ("a_log", 2, ("M", None)),
    ("out_proj", 2, ("M", "F")),
    # xlstm
    ("up_proj", 2, ("F", "M")),
    ("down_proj", 2, ("M", "F")),
    ("w_igate", 2, ("F", None)),
    ("w_fgate", 2, ("F", None)),
    ("w_in", 2, ("F", "M")),
    ("r_z", 3, (None, None, None)),
    ("r_i", 3, (None, None, None)),
    ("r_f", 3, (None, None, None)),
    ("r_o", 3, (None, None, None)),
]


def _axes(mesh) -> tuple[tuple[str, ...], dict]:
    if mesh is None:
        return (), {}
    return tuple(mesh.axis_names), dict(mesh.shape)


def _resolve(sym, dim: int, mesh, used: set[str], ep_possible: bool,
             fsdp: bool = True) -> str | None:
    if sym is None:
        return None
    if sym == "F" and not fsdp:
        return None
    if sym == "EPTP":
        if ep_possible:
            return None
        sym = "M"
    axis = {"F": "data", "M": "model"}[sym]
    names, shape = _axes(mesh)
    if axis not in names or axis in used:
        return None
    if dim % shape[axis] != 0:
        return None
    used.add(axis)
    return axis


def param_pspec(path: str, shape: tuple[int, ...], mesh,
                fsdp: bool = False) -> tuple:
    """Spec of one parameter leaf (period-stacked aware): the JAX
    package's ``param_pspec(path, shape, mesh, fsdp)`` as a tuple, for
    any ``mesh`` with ``axis_names`` and ``shape`` (None: no axes).
    ``fsdp=False`` (the default here: serving) drops the 'F' slots."""
    ndim = len(shape)
    names, sizes = _axes(mesh)
    for suffix, rule_nd, spec in _RULES:
        if not path.endswith(suffix) and f"/{suffix}/" not in path + "/":
            continue
        stacked = 0
        if ndim == rule_nd + 1:
            stacked = 1
        elif ndim != rule_nd:
            continue
        dims = shape[stacked:]
        ep_possible = (rule_nd == 3 and spec[0] == "M" and "model" in names
                       and dims[0] % sizes["model"] == 0)
        used: set[str] = set()
        out = [_resolve(sym, dim, mesh, used, ep_possible, fsdp)
               for sym, dim in zip(spec, dims)]
        return (None,) * stacked + tuple(out)
    if ndim >= 2:
        used = set()
        tail = (_resolve("F", shape[-2], mesh, used, False, fsdp),
                _resolve("M", shape[-1], mesh, used, False, fsdp))
        return (None,) * (ndim - 2) + tail
    return ()


def batch_pspec(mesh, batch_size: int) -> tuple:
    """The JAX package's ``batch_pspec``: a batch's rows over ``'data'``
    when the axis divides them (``('data',)``), else replicated
    (``()``)."""
    names, sizes = _axes(mesh)
    if ("data" in names and batch_size % sizes["data"] == 0
            and batch_size >= sizes["data"]):
        return ("data",)
    return ()


#: the leaves whose layers compute on a 'model' cut: the vocabulary of
#: the embedding and the head, the projections' heads (and their
#: biases) and the MLPs' and experts' hidden units or experts
TP_LEAVES = ("embed/table", "head/w", "wq", "wk", "wv", "wo", "bq", "bk",
             "bv", "w_gate", "w_up", "w_down")
#: the attention leaves, whole unless both head counts divide tp
ATTENTION_LEAVES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


def attention_cut(cfg, mesh) -> bool:
    """Whether the attention's weights are cut over ``'model'``: only
    when ``tp > 1`` divides both ``n_heads`` and ``n_kv_heads`` (the
    paged path's ``'heads'`` regime)."""
    tp = mesh_model_tp(mesh)
    return tp > 1 and cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0


def shard_pspec(path: str, shape: tuple[int, ...], mesh, cfg,
                fsdp: bool = False) -> tuple:
    """The spec this port cuts a leaf by: :func:`param_pspec`'s
    ``'data'`` slots (with ``fsdp``) and its ``'model'`` slots on
    :data:`TP_LEAVES` only — on the attention leaves only when
    :func:`attention_cut`.  A projection bias (1-D a period, which the
    rules replicate) is cut with its weight's output columns."""
    spec = param_pspec(path, shape, mesh, fsdp)
    name = path.rsplit("/", 1)[-1]
    tp_leaf = any(path.endswith(s) for s in TP_LEAVES)
    if name in ATTENTION_LEAVES and not attention_cut(cfg, mesh):
        tp_leaf = False
    if name in ("bq", "bk", "bv") and tp_leaf:
        stacked = len(shape) - 1
        return (None,) * stacked + ("model",)
    if tp_leaf:
        return spec
    return tuple(None if a == "model" else a for a in spec)


@functools.lru_cache(maxsize=None)
def full_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """Every parameter leaf's whole shape by path, from an init on the
    meta device (no memory)."""
    from repro_torch.models import build_model
    from repro_torch.models.convert import tree_flatten
    params = build_model(cfg).init(torch.Generator(), "meta")
    return {p: tuple(x.shape) for p, x in tree_flatten(params)}


def local_shape(shape: tuple[int, ...], spec: tuple, mesh) -> tuple:
    """A leaf's shape on one rank under ``spec``."""
    sizes = dict(mesh.shape) if mesh is not None else {}
    return tuple(d // sizes[a] if a else d
                 for d, a in zip(shape, spec + (None,) * len(shape)))


def _take(x, axis: int, index: int, parts: int):
    """A copy of part ``index`` of ``parts`` of ``x`` along ``axis`` (its
    own storage, so the whole leaf can be freed)."""
    n = x.shape[axis] // parts
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(index * n, (index + 1) * n)
    part = x[tuple(sl)]
    return part.clone() if isinstance(part, Tensor) else np.array(part)


def cut_leaf(x, spec: tuple, mesh):
    """This rank's part of the whole leaf ``x`` under ``spec``."""
    for dim, axis in enumerate(spec):
        if axis and mesh.size(axis) > 1:
            x = _take(x, dim, mesh.index(axis), mesh.size(axis))
    return x


def _walk(tree, fn, path=""):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, f"{path}/{i}")
                          for i, v in enumerate(tree))
    return fn(path, tree)


def shard_params(params, cfg, mesh: Mesh | None, fsdp: bool = False):
    """Rank ``mesh``'s part of a parameter tree (numpy arrays or
    tensors) under :func:`shard_pspec`: a cut leaf is a copy of the
    rank's part, every other leaf the input leaf itself.

    A leaf already cut to the rank's shape is kept, so a tree that was
    sharded on the way in (``convert.params_from_jax(..., mesh=)``)
    passes unchanged.  Serving (``fsdp=False``) cuts over ``'model'``
    only: the MoE's experts by their 3-D rows (a rank's
    ``E / tp`` experts, or every expert's ``d_expert / tp`` columns), the
    shared MLP and the dense MLP by the 2-D rows, the attention in the
    ``'heads'`` regime only; the router, norms and ``bo`` stay whole."""
    if mesh is None or mesh.tp * mesh.data <= 1:
        return params
    shapes = full_shapes(cfg)

    def leaf(path: str, x):
        full = shapes[path]
        spec = shard_pspec(path, full, mesh, cfg, fsdp)
        mine = local_shape(full, spec, mesh)
        if tuple(x.shape) == mine:
            return x
        if tuple(x.shape) != full:
            raise ValueError(f"{path}: {tuple(x.shape)} is neither the "
                             f"whole {full} nor this rank's {mine}")
        return cut_leaf(x, spec, mesh)

    return _walk(params, leaf)


def expert_split(mesh: Mesh | None, n_experts: int, d_model: int,
                 d_expert: int) -> tuple[str, int, int] | None:
    """How the 3-D expert rows cut an MoE's experts on this rank:
    ``("experts", lo, hi)`` — the experts ``[lo, hi)`` whole — or
    ``("columns", lo, hi)`` — every expert's ``d_expert`` columns
    ``[lo, hi)`` (``"EPTP"``) — or None (whole)."""
    spec = param_pspec("ffn/w_gate", (1, n_experts, d_model, d_expert),
                       mesh)[1:]
    tp = mesh_model_tp(mesh)
    if tp <= 1:
        return None
    if spec[0] == "model":
        n = n_experts // tp
        return "experts", mesh.rank * n, (mesh.rank + 1) * n
    if spec[2] == "model":
        n = d_expert // tp
        return "columns", mesh.rank * n, (mesh.rank + 1) * n
    return None


# ---------------------------------------------------------------------------
# Counted collectives
# ---------------------------------------------------------------------------

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _staged(x: Tensor, mesh: Mesh) -> Tensor:
    """The buffer a collective works on: a host copy of a CUDA tensor
    under gloo, else ``x`` itself (contiguous)."""
    if mesh.backend == "gloo" and x.is_cuda:
        return x.cpu()
    return x.contiguous()


def all_reduce(x: Tensor, mesh: Mesh, op: str = "sum", site: str = "",
               axis: str = "model") -> Tensor:
    """The element-wise ``op`` (``sum`` | ``max``) of ``x`` over
    ``axis``'s ranks, on ``x``'s device; the input is not kept."""
    buf = _staged(x, mesh)
    if buf is x:
        buf = x.clone()
    dist.all_reduce(buf, op=_REDUCE_OPS[op], group=mesh.group_of(axis))
    mesh.log.add(site, f"all_reduce_{op}", buf)
    return buf.to(x.device, non_blocking=True)


def all_gather(x: Tensor, mesh: Mesh, dim: int, site: str = "",
               axis: str = "model") -> Tensor:
    """Every ``axis`` rank's ``x`` concatenated along ``dim`` in rank
    order, on ``x``'s device."""
    buf = _staged(x, mesh)
    parts = [torch.empty_like(buf) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, buf, group=mesh.group_of(axis))
    out = torch.cat(parts, dim=dim)
    mesh.log.add(site, "all_gather", out)
    return out.to(x.device, non_blocking=True)


def send(x: Tensor, dst: int, mesh: Mesh, site: str = "") -> None:
    """Send ``x`` to rank ``dst`` (blocking)."""
    buf = _staged(x, mesh)
    dist.send(buf, dst=dst, group=mesh.group)
    mesh.log.add(site, "send", buf)


def recv_into(x: Tensor, src: int, mesh: Mesh, site: str = "") -> None:
    """Receive from rank ``src`` into ``x`` (blocking; ``x`` may be a
    strided view)."""
    host = mesh.backend == "gloo" and x.is_cuda
    buf = x if x.is_contiguous() and not host else torch.empty(
        x.shape, dtype=x.dtype, device="cpu" if host else x.device)
    dist.recv(buf, src=src, group=mesh.group)
    if buf is not x:
        x.copy_(buf)
    mesh.log.add(site, "recv", buf)


def send_plan(mesh: Mesh, plan) -> None:
    """Rank 0: send one device program's host plan (any picklable object
    of host data) to the other ranks."""
    data = pickle.dumps(plan, protocol=pickle.HIGHEST_PROTOCOL)
    size = torch.tensor([len(data)], dtype=torch.int64)
    dist.broadcast(size, src=0, group=mesh.plan_group)
    dist.broadcast(torch.frombuffer(bytearray(data), dtype=torch.uint8),
                   src=0, group=mesh.plan_group)
    mesh.log.plans += 1


def recv_plan(mesh: Mesh):
    """Ranks other than 0: the next plan rank 0 sent (plans are pickled
    by rank 0 of this program only)."""
    size = torch.zeros(1, dtype=torch.int64)
    dist.broadcast(size, src=0, group=mesh.plan_group)
    buf = torch.empty(int(size[0]), dtype=torch.uint8)
    dist.broadcast(buf, src=0, group=mesh.plan_group)
    mesh.log.plans += 1
    return pickle.loads(np.asarray(buf).tobytes())


# ---------------------------------------------------------------------------
# Collectives that autograd differentiates
# ---------------------------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    """Identity forward; the gradient summed over the axis backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis, site):
        ctx.args = (mesh, axis, site)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, site = ctx.args
        return (all_reduce(g, mesh, "sum", f"{site}.bwd", axis), None, None,
                None)


class _ReduceFrom(torch.autograd.Function):
    """The sum over the axis forward; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis, site):
        return all_reduce(x, mesh, "sum", site, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _GatherFrom(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward the rank's slice of the
    gradient, summed over the axis first when ``sum_grads`` (a weight
    gathered over 'data': each data rank's loss differs)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, site, sum_grads):
        ctx.args = (mesh, axis, dim, site, sum_grads, x.shape[dim])
        return all_gather(x, mesh, dim, site, axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, site, sum_grads, n = ctx.args
        if sum_grads:
            g = all_reduce(g, mesh, "sum", f"{site}.bwd", axis)
        i = mesh.index(axis)
        return (g.narrow(dim, i * n, n).contiguous(), None, None, None, None,
                None)


def copy_to(x: Tensor, mesh: Mesh | None, axis: str = "model",
            site: str = "") -> Tensor:
    """``x`` entering computation cut over ``axis`` (a column-parallel
    projection, a rank's experts): unchanged forward, its gradient
    summed over the axis backward.  ``x`` itself on an axis of one."""
    if mesh is None or mesh.size(axis) <= 1:
        return x
    return _CopyTo.apply(x, mesh, axis, site)


def reduce_from(x: Tensor, mesh: Mesh | None, axis: str = "model",
                site: str = "") -> Tensor:
    """The sum over ``axis`` of the ranks' partial ``x`` (a row-parallel
    projection's output); backward the gradient as it is."""
    if mesh is None or mesh.size(axis) <= 1:
        return x
    return _ReduceFrom.apply(x, mesh, axis, site)


def gather_from(x: Tensor, mesh: Mesh | None, dim: int,
                axis: str = "model", site: str = "",
                sum_grads: bool = False) -> Tensor:
    """The ranks' ``x`` concatenated along ``dim`` (vocabulary-cut
    logits; with ``sum_grads`` a weight's ``'data'`` cut)."""
    if mesh is None or mesh.size(axis) <= 1:
        return x
    return _GatherFrom.apply(x, mesh, axis, dim % x.ndim, site, sum_grads)


# ---------------------------------------------------------------------------
# The training layout: FSDP + tensor / expert parallelism
# ---------------------------------------------------------------------------


class Layout:
    """Where each leaf of a parameter tree lives on a ``('data',
    'model')`` mesh: :func:`shard_pspec` with ``fsdp=True``.  A rank
    holds its cut of every leaf (params, Adam moments, error feedback);
    the layers gather a leaf's ``'data'`` cut just before they use it
    (:func:`use_leaves`) and keep its ``'model'`` cut."""

    def __init__(self, cfg, mesh: Mesh):
        self.cfg, self.mesh = cfg, mesh
        self.shapes = full_shapes(cfg)
        self.specs = {p: shard_pspec(p, s, mesh, cfg, fsdp=True)
                      for p, s in self.shapes.items()}

    def axes(self, path: str) -> tuple[str, ...]:
        """The axes (of size > 1) leaf ``path`` is cut over."""
        return tuple(a for a in self.specs[path]
                     if a and self.mesh.size(a) > 1)

    def cut(self, params):
        """A rank's part of a whole parameter-shaped tree."""
        return _walk(params, lambda p, x: cut_leaf(x, self.specs[p],
                                                   self.mesh))

    def gather(self, params):
        """Whole leaves of a rank-cut parameter-shaped tree (every rank
        runs the gathers; no autograd)."""
        def leaf(path, x):
            with torch.no_grad():
                for dim, axis in enumerate(self.specs[path]):
                    if axis and self.mesh.size(axis) > 1:
                        x = all_gather(x, self.mesh, dim, site="gather",
                                       axis=axis)
            return x
        return _walk(params, leaf)

    def reduce_leaves(self, paths: list[str], vals: Tensor,
                      op: str) -> Tensor:
        """``vals[i]`` (one f32 number a leaf, e.g. a shard's sum of
        squares) reduced by ``op`` over the axes leaf ``paths[i]`` is cut
        over, and only those: one collective per set of axes."""
        out = vals.clone()
        groups: dict[tuple, list[int]] = {}
        for i, p in enumerate(paths):
            groups.setdefault(self.axes(p), []).append(i)
        for axes, idx in groups.items():
            sub = out[idx]
            for axis in axes:
                sub = all_reduce(sub, self.mesh, op, site="reduce",
                                 axis=axis)
            out[idx] = sub
        return out

    def use(self, path: str, x: Tensor, index: int | None = None) -> Tensor:
        """Leaf ``path`` as a layer uses it: its ``'data'`` cut gathered
        (its gradient summed over 'data' and cut again backward), then
        period ``index`` of a stacked leaf."""
        spec = self.specs[path]
        data = self.mesh.size("data") > 1
        if index is not None:
            if data and spec[0] == "data":
                x = gather_from(x, self.mesh, 0, "data", "fsdp", True)
            x, spec = x[index], spec[1:]
        if data and "data" in spec:
            x = gather_from(x, self.mesh, spec.index("data"), "data",
                            "fsdp", True)
        return x


def use_leaves(tree, prefix: str, index: int | None = None):
    """The leaves of the subtree at ``prefix`` as the layers use them:
    period ``index`` of stacked leaves, with the active training
    layout's ``'data'`` cuts gathered (:meth:`Layout.use`)."""
    layout = active_scope().layout
    if layout is None:
        if index is None:
            return tree
        return _walk(tree, lambda p, x: x[index])
    return _walk(tree, lambda p, x: layout.use(
        f"{prefix}/{p}" if p else prefix, x, index))
