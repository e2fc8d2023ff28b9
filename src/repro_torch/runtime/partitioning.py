"""Meshes over ``torch.distributed``: the placement rules of the weights,
the batch and the page pools, and the collectives.

The counterpart of the JAX package's ``runtime/partitioning.py``.  JAX
runs a mesh from one controller and lets ``shard_map`` / XLA run the
per-device programs; here each rank is a process of its own over a
``torch.distributed`` process group, and a :class:`Mesh` is one rank's
view of it: the named axes ``('data', 'model')`` (serving is
``data = 1``), ``('pod', 'data', 'model')`` (the two-pod production
mesh) or ``('pipe',)`` (GPipe), this rank's index on each, and a
process group per axis.  Ranks are laid out in the JAX package's
row-major device order, rank = ``(p · data + d) · model + m``.  ``tp``, ``rank`` and
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
* :func:`shard_pspec` is the cut a layer computes on: the rule's
  ``'model'`` slots on the leaves whose layers compute on a cut
  (:data:`TP_LEAVES`; attention only when both head counts divide
  ``tp`` — the ``'heads'`` regime, or, in the paged engines, wherever
  the rule cuts them; Mamba when ``tp`` divides its channels).  The
  layers ask the active :class:`Scope` whether they compute on a leaf's
  cut (:meth:`Scope.model_mesh`: the scope's :class:`Layout`'s
  ``compute``).
* :class:`Layout` stores every leaf as :func:`param_pspec` cuts it, no
  exception — with ``fsdp=True`` in training, lockstep serving on a
  mesh and the cells, with ``fsdp=False`` (the reference's serving
  spec) in the paged engines (:func:`shard_params`) — and gathers just
  before use every axis the storage cuts and the layer's compute does
  not (:meth:`Layout.use`).  A Mamba
  ``in_proj``'s columns are stored interleaved so that the rule's
  contiguous cut gives each rank its ``x`` and its ``z`` channels
  (:func:`in_proj_order`).
* :func:`batch_pspec`: a batch's rows over ``('pod', 'data')`` when
  both divide it, else over ``'data'`` when it does, else replicated.
* :func:`cache_pspec` / :func:`cache_specs`: a lockstep cache's rows
  as the batch's, its KV heads over ``'model'`` when they divide it,
  else its length (and under ``shard_kv_seq`` its length over
  ``'data'`` too); a recurrent state's channels over ``'model'`` where
  they divide it.
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

from repro_torch.kernels.lut_attention.ops import paged_mesh_regime

Tensor = torch.Tensor

#: ``fake`` (``torch.testing._internal.distributed.fake_pg``) is the dry
#: run's: a world of 256 or 512 ranks in one process, whose collectives
#: give tensors of the right shape and move nothing
BACKENDS = ("nccl", "gloo", "fake")


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
    there (``backend``: ``nccl``, ``gloo`` or ``fake``).  ``data`` /
    ``data_rank`` / ``data_group`` are the ``'data'`` axis; ``pod > 0``
    adds a ``'pod'`` axis of that many pods before it (``pod_rank`` /
    ``pod_group``); ``pipe > 0`` makes a ``('pipe',)`` mesh of that many
    stages instead (``tp`` and ``data`` are then 1).  ``plan_group`` is
    a gloo group for the serving host plans.  An axis of size 1 has no
    group: nothing is cut over it and no collective runs."""

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
    pod: int = 0
    pod_rank: int = 0
    pod_group: object = None

    @property
    def axis_names(self) -> tuple[str, ...]:
        if self.pipe:
            return ("pipe",)
        return ("pod", "data", "model") if self.pod else ("data", "model")

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes by name (the JAX mesh's ``shape``)."""
        if self.pipe:
            return {"pipe": self.pipe}
        pods = {"pod": self.pod} if self.pod else {}
        return {**pods, "data": self.data, "model": self.tp}

    def size(self, axis: str | tuple[str, ...]) -> int:
        """The size of ``axis``, or the product of several."""
        if isinstance(axis, tuple):
            return int(np.prod([self.size(a) for a in axis]))
        return self.shape.get(axis, 1)

    def index(self, axis: str | tuple[str, ...]) -> int:
        """This rank's index along ``axis`` (``axis_index``); along
        several axes, the row-major index over them (the first major)."""
        if isinstance(axis, tuple):
            i = 0
            for a in axis:
                i = i * self.size(a) + self.index(a)
            return i
        return {"data": self.data_rank, "model": self.rank,
                "pipe": self.pipe_rank, "pod": self.pod_rank}[axis]

    def group_of(self, axis: str):
        return {"data": self.data_group, "model": self.group,
                "pipe": self.pipe_group, "pod": self.pod_group}[axis]

    @property
    def world(self) -> int:
        """The number of ranks."""
        return self.size(self.axis_names)

    @property
    def world_rank(self) -> int:
        """Row-major rank: ``(p · data + d) · model + m`` (the pipe index
        on a pipe mesh)."""
        return self.index(self.axis_names)


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
    """What the layers read of the mesh they run under: the mesh, the
    cut each leaf's layer computes on (``compute``, path → spec:
    :func:`compute_specs`; None while the weights are whole), the axes
    the batch's rows are cut over (``tokens``, :func:`row_axes`: an MoE
    then routes over the global token groups; ``()`` when the rows are
    whole), and the :class:`Layout` whose storage cuts are gathered
    before use."""

    mesh: Mesh | None = None
    compute: dict | None = None
    tokens: tuple[str, ...] = ()
    layout: "Layout | None" = None

    @property
    def cut(self) -> bool:
        """Whether the weights are a rank's cut."""
        return self.compute is not None

    def model_mesh(self, path: str) -> Mesh | None:
        """The mesh when the layer of leaf ``path`` (its path in the
        parameter tree, e.g. ``periods/0/mixer/wq``) computes on the
        leaf's ``'model'`` cut — the scope's compute spec names
        ``'model'`` on it — else None."""
        if self.compute is not None and "model" in self.compute[path]:
            return self.mesh
        return None


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
def mesh_scope(mesh: Mesh | None, *, compute: dict | None = None,
               tokens: tuple[str, ...] = (),
               layout: "Layout | None" = None):
    """``mesh`` active inside the block (with :class:`Scope`'s fields;
    ``compute`` defaults to the ``layout``'s), the previous scope
    restored after (a single-device engine in the same process is
    unaffected)."""
    if compute is None and layout is not None:
        compute = layout.compute
    token = _ACTIVE.set(Scope(mesh, compute, tuple(tokens), layout))
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


def paged_pool_pspec(mesh: Mesh | None, n_kv_heads: int,
                     scales: bool = False) -> tuple:
    """Spec of one layer's page-major pool ``(n_pages, ps, KVH, Dh)`` —
    for ``scales`` its f32 scale leaf ``(n_pages, ps, KVH)`` — written as
    the JAX package's ``PartitionSpec``: the axis that ``'model'`` (the
    ranks) splits.  ``()`` is replicated."""
    regime = paged_mesh_regime(mesh, n_kv_heads)
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
    regime = paged_mesh_regime(mesh, n_kv_heads)
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


def batch_axes(mesh) -> tuple[str, ...]:
    """The mesh's batch axes: ``'pod'`` and ``'data'``, those it has."""
    names, _ = _axes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _entry(axes: tuple[str, ...]):
    """A spec entry: one axis by its name, several as a tuple."""
    return axes[0] if len(axes) == 1 else tuple(axes)


def entry_axes(entry) -> tuple[str, ...]:
    """The axes of a spec entry (None, a name or a tuple of names)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def batch_pspec(mesh, batch_size: int) -> tuple:
    """The JAX package's ``batch_pspec``: a batch's rows over every batch
    axis when their product divides them (``(('pod', 'data'),)``, or
    ``('data',)`` on a mesh without pods), else over ``'data'`` alone
    when it divides them (``('data',)``), else replicated (``()``)."""
    names, sizes = _axes(mesh)
    axes = batch_axes(mesh)
    size = int(np.prod([sizes[a] for a in axes])) if axes else 1
    if axes and batch_size % size == 0 and batch_size >= size:
        return (_entry(axes),)
    if ("data" in names and batch_size % sizes["data"] == 0
            and batch_size >= sizes["data"]):
        return ("data",)
    return ()


def row_axes(mesh, batch_size: int) -> tuple[str, ...]:
    """The axes of more than one rank that :func:`batch_pspec` cuts a
    batch of ``batch_size`` rows over (``()``: every rank has them
    all)."""
    if mesh is None:
        return ()
    spec = batch_pspec(mesh, batch_size)
    return tuple(a for a in entry_axes(spec[0] if spec else None)
                 if mesh.size(a) > 1)


def row_range(mesh, batch_size: int) -> tuple[int, int]:
    """``[lo, hi)``: this rank's rows of a batch of ``batch_size``."""
    axes = row_axes(mesh, batch_size)
    n = batch_size // (mesh.size(axes) if axes else 1)
    i = mesh.index(axes) if axes else 0
    return i * n, (i + 1) * n


def cache_pspec(mesh, batch_size: int, n_kv_heads: int,
                shard_kv_seq: bool = False) -> tuple:
    """The JAX package's ``cache_pspec``: the spec of a (B, KVH, L, Dh)
    lockstep cache.  The rows as :func:`batch_pspec`; the KV heads over
    ``'model'`` when they divide it, else the length over ``'model'``;
    with ``shard_kv_seq`` (long context, batch 1) the length over
    ``'data'`` too, when the rows do not take it."""
    names, sizes = _axes(mesh)
    bspec = batch_pspec(mesh, batch_size)
    b_axes = bspec[0] if bspec else None
    kv_axis = ("model" if "model" in names
               and n_kv_heads % sizes["model"] == 0 else None)
    seq_axes: list[str] = []
    if kv_axis is None and "model" in names:
        seq_axes.append("model")
    if (shard_kv_seq and "data" in names
            and "data" not in entry_axes(b_axes)):
        seq_axes.append("data")
    return (b_axes, kv_axis, tuple(seq_axes) if seq_axes else None, None)


#: the leaves whose layers compute on a 'model' cut wherever the rule
#: makes one: the vocabulary of the embedding and the head, the MLPs'
#: and experts' hidden units or experts
TP_LEAVES = ("embed/table", "head/w", "w_gate", "w_up", "w_down")
#: the attention leaves, computed on a cut only when both head counts
#: divide tp
ATTENTION_LEAVES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


def _mixer(path: str, cfg) -> str:
    """The mixer leaf ``path`` belongs to: a decoder block's
    (``periods/<i>/mixer/…``: ``attn``, ``mamba``, ``mlstm``, ``slstm``),
    ``attn`` for an encoder-decoder's self- and cross-attention, else
    ``''``."""
    parts = path.split("/")
    if len(parts) > 2 and parts[0] == "periods" and parts[2] == "mixer":
        return cfg.period[int(parts[1])].mixer
    if "self_attn" in parts or "cross_attn" in parts:
        return "attn"
    return ""


def mamba_channels(cfg) -> int:
    """A Mamba mixer's channel count ``DI`` (``ssm.EXPAND · d_model``)."""
    from repro_torch.models.ssm import EXPAND
    return EXPAND * cfg.d_model


def shard_pspec(path: str, shape: tuple[int, ...], mesh, cfg,
                paged_layers: bool = False) -> tuple:
    """The cut a layer computes leaf ``path`` on, over ``'model'`` only:
    :func:`param_pspec`'s ``'model'`` slots on :data:`TP_LEAVES`, on the
    attention leaves when ``tp > 1`` divides both head counts (the
    ``'heads'`` regime) — for ``paged_layers`` (the paged engines'
    attention, ``layers.apply_paged_attention``) wherever the rule cuts
    them, the ``'pages'`` regime's q/k/v on their columns and ``wo`` on
    its rows (``layers._local_qkv``) — and on every
    Mamba leaf when it divides the channels (``ssm.apply_mamba`` is then
    channel-parallel) — never on an mLSTM's or sLSTM's, which compute
    whole (an mLSTM's ``wq`` / ``wk`` / ``wv`` are not attention's) —
    and none at ``tp = 1``.  A projection bias (whole where the rule sees
    a vector) is cut with its weight's output columns."""
    spec = param_pspec(path, shape, mesh)
    name = path.rsplit("/", 1)[-1]
    mixer = _mixer(path, cfg)
    if mixer == "attn" and name in ATTENTION_LEAVES and paged_layers:
        cut = (divides(mesh, shape[-1]) if name in ("bq", "bk", "bv")
               else "model" in spec)
    elif mixer == "attn" and name in ATTENTION_LEAVES:
        cut = divides(mesh, cfg.n_heads) and divides(mesh, cfg.n_kv_heads)
    elif mixer == "mamba":
        cut = divides(mesh, mamba_channels(cfg))
    else:
        cut = (not mixer and mesh_model_tp(mesh) > 1
               and any(path.endswith(s) for s in TP_LEAVES))
    if cut and name in ("bq", "bk", "bv"):
        lead = spec[:len(shape) - 1] if len(spec) == len(shape) else (
            (None,) * (len(shape) - 1))
        return tuple(lead) + ("model",)
    if cut:
        return spec
    return tuple(None if a == "model" else a for a in spec)


def in_proj_order(path: str, x, mesh, cfg, inverse: bool = False):
    """A Mamba ``in_proj`` ``(…, D, 2·DI)`` (columns ``[x | z]``) with its
    columns in the order whose contiguous ``'model'`` cut gives rank
    ``r`` its channels of both halves, ``[x_r | z_r]`` — the shape the
    rule gives a rank, where the rule's own cut would give ranks below
    ``tp / 2`` only ``x`` columns; ``inverse`` puts them back.  Any other
    leaf, or a mesh that does not cut Mamba's channels, passes as it
    is."""
    if (not path.endswith("mixer/in_proj") or _mixer(path, cfg) != "mamba"
            or not divides(mesh, mamba_channels(cfg))):
        return x
    di, tp = mamba_channels(cfg), mesh_model_tp(mesh)
    c = di // tp
    order = np.concatenate([np.r_[r * c:(r + 1) * c, di + r * c:
                                  di + (r + 1) * c] for r in range(tp)])
    if inverse:
        order = np.argsort(order)
    if isinstance(x, Tensor):
        return x[..., torch.as_tensor(order, device=x.device)]
    return np.asarray(x)[..., order]


def map_cache(state, fn):
    """``state`` (a serving state: lists and tuples of caches — dataclasses
    of tensors — or of tensors) with every tensor leaf ``x`` replaced by
    ``fn(x, name, recurrent)``: ``name`` the leaf's field name (its index
    in a tuple), ``recurrent`` whether it is a recurrent mixer's state
    (``models/ssm.py``).  Other fields (a cache's ``length``) are kept."""
    from repro_torch.models import ssm
    return _map_cache(state, "", fn, (ssm.MambaCache, ssm.MLSTMCache,
                                      ssm.SLSTMCache))


def _map_cache(node, name, fn, recurrent_types):
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        rec = isinstance(node, recurrent_types)
        return dataclasses.replace(node, **{
            f.name: fn(getattr(node, f.name), f.name, rec)
            for f in dataclasses.fields(node)
            if isinstance(getattr(node, f.name), Tensor)})
    if isinstance(node, (list, tuple)):
        return type(node)(_map_cache(v, str(i), fn, recurrent_types)
                          for i, v in enumerate(node))
    if isinstance(node, Tensor):
        return fn(node, name, False)
    return node


def _cache_spec_fn(mesh, batch_size: int, n_kv_heads: int,
                   shard_kv_seq: bool, stacked: bool):
    names, sizes = _axes(mesh)
    kv = cache_pspec(mesh, batch_size, n_kv_heads, shard_kv_seq)
    bspec = batch_pspec(mesh, batch_size)
    b_axes = bspec[0] if bspec else None
    pre = (None,) if stacked else ()
    off = len(pre)

    def spec(x, name, recurrent):
        nd = x.dim()
        if nd == 4 + off and name in ("k", "v"):
            return pre + kv
        if nd >= 2 + off:
            x_axis = ("model" if "model" in names
                      and x.shape[off + 1] % sizes["model"] == 0 else None)
            return pre + (b_axes, x_axis) + (None,) * (nd - off - 2)
        return (None,) * nd

    return spec


def cache_specs(state, mesh, batch_size: int, n_kv_heads: int,
                shard_kv_seq: bool = False, stacked: bool = False):
    """The spec of every tensor leaf of a whole serving ``state``
    (:func:`map_cache`'s tree, each leaf replaced by its spec): the JAX
    package's ``make_cache_shardings``.

    * attention K/V ``(B, KVH, L, Dh)`` (fields ``k`` / ``v``):
      :func:`cache_pspec`;
    * any other leaf of two or more dims — an encoder-decoder's cross
      K/V ``(B, KVH, L_enc, Dh)``, a recurrent state ``(B, X, …)`` — its
      rows as the batch's and its channel ``X`` over ``'model'`` where it
      divides: Mamba's ``h`` ``(B, DI, N)`` by the channels the rank
      computes (``ssm.apply_mamba``); its conv tail ``(B, D_CONV − 1,
      DI)``, an mLSTM's or an sLSTM's state ``(B, H, …)`` by taps or
      heads where ``'model'`` divides them, gathered before the step
      and cut again after it (``ssm``: those mixers compute every
      channel);
    * smaller leaves whole.

    ``stacked``: the leaves carry a leading period axis, as the JAX
    package's decoder caches do (the port's are per layer)."""
    return map_cache(state, _cache_spec_fn(mesh, batch_size, n_kv_heads,
                                           shard_kv_seq, stacked))


def local_state(state, mesh, batch_size: int, n_kv_heads: int,
                shard_kv_seq: bool, make):
    """The port's (unstacked) ``state`` with its leaves at this rank's
    shapes under :func:`cache_specs`: ``make(x, shape, spec)`` gives each
    new leaf — an empty or zeroed tensor of the shape — and a cache whose
    length is cut names its axes (``AttnCache.seq_axes``)."""
    fn = _cache_spec_fn(mesh, batch_size, n_kv_heads, shard_kv_seq, False)

    def leaf(x, name, rec):
        sp = fn(x, name, rec)
        return make(x, local_shape(tuple(x.shape), sp, mesh), sp)

    seq = entry_axes(cache_pspec(mesh, batch_size, n_kv_heads,
                                 shard_kv_seq)[2])
    seq = tuple(a for a in seq if mesh.size(a) > 1)
    return _mark_seq_axes(map_cache(state, leaf), seq)


def _mark_seq_axes(state, seq: tuple[str, ...]):
    """``state`` with every attention cache's ``seq_axes`` set to
    ``seq``."""
    if hasattr(state, "seq_axes"):
        return dataclasses.replace(state, seq_axes=seq)
    if isinstance(state, (list, tuple)):
        return type(state)(_mark_seq_axes(x, seq) for x in state)
    return state


def local_caches(build, mesh, batch_size: int, n_kv_heads: int,
                 shard_kv_seq: bool, device):
    """This rank's zeroed cut of a whole serving state of ``batch_size``
    rows: :func:`local_state`'s leaves on ``device``.  ``build()`` gives
    the whole state's template on the meta device; it runs with the
    active dispatch modes (a dry run's counters) disabled, as it is a
    description of shapes, not memory a step uses."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        whole = build()
    return local_state(
        whole, mesh, batch_size, n_kv_heads, shard_kv_seq,
        lambda x, shape, sp: torch.zeros(shape, dtype=x.dtype,
                                         device=device))


@functools.lru_cache(maxsize=None)
def meta_params(cfg):
    """The whole parameter tree on the meta device (no memory)."""
    from repro_torch.models import build_model
    return build_model(cfg).init(torch.Generator(), "meta")


@functools.lru_cache(maxsize=None)
def full_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """Every parameter leaf's whole shape by path, from an init on the
    meta device (no memory)."""
    from repro_torch.models.convert import tree_flatten
    return {p: tuple(x.shape) for p, x in tree_flatten(meta_params(cfg))}


def local_shape(shape: tuple[int, ...], spec: tuple, mesh) -> tuple:
    """A leaf's shape on one rank under ``spec`` (an entry may name
    several axes)."""
    sizes = dict(mesh.shape) if mesh is not None else {}
    return tuple(
        d // int(np.prod([sizes.get(a, 1) for a in entry_axes(e)]))
        for d, e in zip(shape, tuple(spec) + (None,) * len(shape)))


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
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        if axes and mesh.size(axes) > 1:
            x = _take(x, dim, mesh.index(axes), mesh.size(axes))
    return x


def _walk(tree, fn, path=""):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, f"{path}/{i}")
                          for i, v in enumerate(tree))
    return fn(path, tree)


def shard_params(params, cfg, mesh: Mesh | None):
    """Rank ``mesh``'s part of a parameter tree (numpy arrays or
    tensors) as the paged engines store it: ``Layout(cfg, mesh,
    fsdp=False).cut`` — the JAX package's serving spec
    ``param_pspec(fsdp=False)`` on every leaf — or the tree itself
    without a mesh of more than one rank."""
    if mesh is None or mesh.world <= 1:
        return params
    return Layout(cfg, mesh, fsdp=False).cut(params)


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
               axis: str | tuple[str, ...] = "model") -> Tensor:
    """The element-wise ``op`` (``sum`` | ``max``) of ``x`` over
    ``axis``'s ranks (over several axes, one after the other), on
    ``x``'s device; the input is not kept."""
    if isinstance(axis, tuple):
        for a in axis:
            if mesh.size(a) > 1:
                x = all_reduce(x, mesh, op, site, a)
        return x
    buf = _staged(x, mesh)
    if buf is x:
        buf = x.clone()
    dist.all_reduce(buf, op=_REDUCE_OPS[op], group=mesh.group_of(axis))
    mesh.log.add(site, f"all_reduce_{op}", buf)
    return buf.to(x.device, non_blocking=True)


#: one output tensor for every rank's part (``all_gather_into_tensor``
#: in PyTorch releases before ``all_gather_single`` took its name)
_gather_single = (getattr(dist, "all_gather_single", None)
                  or dist.all_gather_into_tensor)


def all_gather(x: Tensor, mesh: Mesh, dim: int, site: str = "",
               axis: str | tuple[str, ...] = "model") -> Tensor:
    """Every ``axis`` rank's ``x`` concatenated along ``dim`` in rank
    order, on ``x``'s device; over several axes, in their row-major
    order (the last axis gathered first)."""
    if isinstance(axis, tuple):
        for a in reversed(axis):
            if mesh.size(a) > 1:
                x = all_gather(x, mesh, dim, site, a)
        return x
    buf = _staged(x, mesh)
    n = mesh.size(axis)
    if mesh.backend == "gloo":
        parts = [torch.empty_like(buf) for _ in range(n)]
        dist.all_gather(parts, buf, group=mesh.group_of(axis))
        out = torch.cat(parts, dim=dim)
    else:
        stacked = buf.new_empty((n,) + tuple(buf.shape))
        _gather_single(stacked, buf, group=mesh.group_of(axis))
        out = stacked.movedim(0, dim).flatten(dim, dim + 1)
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
    'model')`` (or ``('pod', 'data', 'model')``) mesh, and what the
    layers compute on.

    ``specs`` is the storage, the JAX package's
    ``param_pspec(path, shape, mesh, fsdp)`` with no exception: a rank
    holds that cut of every leaf (params, Adam moments, error feedback),
    a Mamba ``in_proj`` in :func:`in_proj_order` — ``fsdp=True`` in
    training and lockstep serving, ``fsdp=False`` in the paged engines
    (the reference's serving spec).  ``compute`` is the cut the layer
    works on (:func:`shard_pspec`'s ``'model'`` slots; its rule for the
    paged engines' attention with ``paged_layers``).  :meth:`use`
    gathers, just before the
    leaf is used, its ``'data'`` cut and every ``'model'`` cut the layer
    does not compute on (site ``tp_gather``), and cuts a leaf stored
    whole where the layer computes on a cut (a Whisper attention's 1-D
    biases)."""

    def __init__(self, cfg, mesh: Mesh, fsdp: bool = True,
                 paged_layers: bool = False):
        self.cfg, self.mesh = cfg, mesh
        self.shapes = full_shapes(cfg)
        self.specs = {p: _padded(param_pspec(p, s, mesh, fsdp=fsdp), s)
                      for p, s in self.shapes.items()}
        self.compute = compute_specs(cfg, mesh, paged_layers)

    def axes(self, path: str) -> tuple[str, ...]:
        """The axes (of size > 1) leaf ``path`` is stored cut over."""
        return tuple(a for a in self.specs[path]
                     if a and self.mesh.size(a) > 1)

    def cut(self, params):
        """A rank's part of a whole parameter-shaped tree; a leaf already
        of the rank's shape passes as it is (a tree cut on the way in:
        ``convert.params_from_jax(..., mesh=)``, a checkpoint)."""
        def leaf(path: str, x):
            full = self.shapes[path]
            mine = local_shape(full, self.specs[path], self.mesh)
            if tuple(x.shape) == mine:
                return x
            if tuple(x.shape) != full:
                raise ValueError(f"{path}: {tuple(x.shape)} is neither the "
                                 f"whole {full} nor this rank's {mine}")
            return self.cut_leaf(path, x)
        return _walk(params, leaf)

    def cut_leaf(self, path: str, x, one_period: bool = False):
        """A rank's part of the whole leaf ``path``; ``one_period``: ``x``
        is one period of a stacked leaf, cut on its other dims (its
        period axis is cut once the periods are stacked)."""
        spec = self.specs[path][1:] if one_period else self.specs[path]
        return cut_leaf(in_proj_order(path, x, self.mesh, self.cfg), spec,
                        self.mesh)

    def gather(self, params):
        """Whole leaves of a rank-cut parameter-shaped tree (every rank
        runs the gathers; no autograd)."""
        def leaf(path, x):
            with torch.no_grad():
                for dim, axis in enumerate(self.specs[path]):
                    if axis and self.mesh.size(axis) > 1:
                        x = all_gather(x, self.mesh, dim, site="gather",
                                       axis=axis)
                return in_proj_order(path, x, self.mesh, self.cfg,
                                     inverse=True)
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
        (its gradient summed over 'data' and cut again backward), period
        ``index`` of a stacked leaf, then each ``'model'`` cut the layer
        does not compute on gathered — every ``'model'`` rank computes
        the same whole product on the same rows, so the backward takes
        the rank's part of the gradient without a sum — and a leaf
        stored whole cut where the layer computes on a cut (its
        gradient summed over 'model' backward)."""
        mesh = self.mesh
        spec, comp = self.specs[path], self.compute[path]
        data = mesh.size("data") > 1
        if index is not None:
            if data and spec[0] == "data":
                x = gather_from(x, mesh, 0, "data", "fsdp", True)
            x, spec, comp = x[index], spec[1:], comp[1:]
        if data and "data" in spec:
            x = gather_from(x, mesh, spec.index("data"), "data", "fsdp",
                            True)
        if mesh.tp <= 1:
            return x
        for dim, (stored, used) in enumerate(zip(spec, comp)):
            if stored == "model" and used is None:
                x = gather_from(x, mesh, dim, "model", "tp_gather")
            elif used == "model" and stored is None:
                n = x.shape[dim] // mesh.tp
                x = copy_to(x, mesh, site="tp_cut").narrow(
                    dim, mesh.rank * n, n)
        return x


def _padded(spec: tuple, shape: tuple) -> tuple:
    """``spec`` with a None for every dim it does not name."""
    return tuple(spec) + (None,) * (len(shape) - len(spec))


def compute_specs(cfg, mesh, paged_layers: bool = False
                  ) -> dict[str, tuple]:
    """:func:`shard_pspec` of every leaf of ``cfg``'s parameter tree,
    by path, a None for every dim it does not name: what each layer
    computes on (:meth:`Scope.model_mesh`)."""
    return {p: _padded(shard_pspec(p, s, mesh, cfg, paged_layers), s)
            for p, s in full_shapes(cfg).items()}


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
