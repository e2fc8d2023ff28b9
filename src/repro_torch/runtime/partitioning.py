"""Tensor-parallel serving over ``torch.distributed``: the mesh, the
placement rules of the page pools and the weights, and the collectives.

The counterpart of the JAX package's ``runtime/partitioning.py`` for
serving.  JAX runs a mesh from one controller and lets ``shard_map`` run
the per-device bodies; here each rank is a process of its own over a
``torch.distributed`` process group, and a :class:`Mesh` is one rank's
view of that group: its rank, the degree ``tp``, its device and the
backend.  Rank 0 owns the scheduler and sends each device program's host
plan to the other ranks (:func:`send_plan` / :func:`recv_plan`), so the
ranks run the same programs in the same order and meet at the same
collectives.

Placement (``paged_pool_pspec``, ``param_pspec``), as in the JAX package:

* the page pools split their KV-head axis over the ranks when the
  arch's KV-head count divides ``tp`` (the ``'heads'`` regime), else
  their physical-page axis (``'pages'``: each rank owns a slab of
  ``n_pages / tp`` pages, plus one sink page here that takes the writes
  of pages it does not own — see :func:`local_pool_specs`); an int8
  pool's scales shard with their pages;
* under ``shard_params`` the decoder's weights follow the JAX package's
  tensor-parallel rules (``fsdp=False``): the q/k/v, gate and up
  projections by output column, ``wo`` and ``w_down`` by input row, the
  embedding and the LM head over the vocabulary — each only when its
  dimension divides ``tp``.  In the ``'pages'`` regime the attention
  projections stay replicated, since their heads cannot split on
  KV-head boundaries (:func:`shard_params`).

Every collective of the serving path goes through the helpers below,
which record each op's site, kind, shape and bytes in the mesh's
:class:`CollectiveLog` — the port's counterpart of the JAX package's
check of the collectives in the compiled HLO.  With the ``gloo``
backend a CUDA tensor is staged through the host explicitly (gloo works
on host memory); ``nccl`` works on the device tensors.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
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


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a tensor-parallel serving group.

    ``group`` carries the collectives of the model (``backend``:
    ``nccl`` or ``gloo``); ``plan_group`` is a gloo group for the host
    plans (the default group itself when ``backend`` is ``gloo``).
    ``tp == 1`` is a mesh of one rank with no group: nothing is sharded
    and no collective runs."""

    tp: int
    rank: int
    device: torch.device
    backend: str
    group: object = None
    plan_group: object = None
    log: CollectiveLog = dataclasses.field(default_factory=CollectiveLog)


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
# Active-mesh context (read by the paged attention layers)
# ---------------------------------------------------------------------------

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("active_mesh",
                                                         default=None)


def set_active_mesh(mesh: Mesh | None) -> None:
    """Make ``mesh`` the active mesh of this thread's context."""
    _ACTIVE.set(mesh)


def active_mesh() -> Mesh | None:
    return _ACTIVE.get()


@contextlib.contextmanager
def mesh_scope(mesh: Mesh | None):
    """``mesh`` active inside the block, the previous one restored after
    (a single-device engine in the same process is unaffected)."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


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
# Weight placement
# ---------------------------------------------------------------------------

#: the JAX package's tensor-parallel rules for the decoder's 2-D weights
#: (``_RULES`` with ``fsdp=False``: its 'F' slots replicate): the spec
#: over a leaf's trailing two dims.
_RULES: tuple[tuple[str, tuple], ...] = (
    ("embed/table", ("model", None)),
    ("head/w", (None, "model")),
    ("wq", (None, "model")),
    ("wk", (None, "model")),
    ("wv", (None, "model")),
    ("wo", ("model", None)),
    ("w_gate", (None, "model")),
    ("w_up", (None, "model")),
    ("w_down", ("model", None)),
)
#: the attention leaves, replicated in the 'pages' regime
ATTENTION_LEAVES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
#: projection biases split with their weight's output columns (the JAX
#: package leaves them to XLA; here a rank adds its own columns' bias)
_BIAS_OF = {"bq": "wq", "bk": "wk", "bv": "wv"}


def param_pspec(path: str, shape: tuple[int, ...],
                mesh: Mesh | None) -> tuple:
    """Spec of one decoder weight leaf (period-stacked aware), as the JAX
    package's ``param_pspec(..., fsdp=False)`` gives it for the nine
    rule leaves: ``'model'`` on the split dim when it divides ``tp``;
    ``()`` for every other leaf."""
    ndim = len(shape)
    for suffix, spec in _RULES:
        if not path.endswith(suffix):
            continue
        if ndim not in (2, 3):
            return ()
        stacked = ndim - 2
        out = tuple(ax if ax is None or divides(mesh, d) else None
                    for ax, d in zip(spec, shape[stacked:]))
        return (None,) * stacked + out
    return ()


def _split(x, axis: int, mesh: Mesh):
    """A copy of this rank's contiguous 1/tp of ``x`` along ``axis`` (its
    own storage, so the whole leaf can be freed)."""
    n = x.shape[axis] // mesh.tp
    index = [slice(None)] * x.ndim
    index[axis] = slice(mesh.rank * n, (mesh.rank + 1) * n)
    part = x[tuple(index)]
    return part.clone() if isinstance(part, Tensor) else np.array(part)


def _full_dims(cfg) -> dict[str, int]:
    """The unsplit size of each rule leaf's split dim."""
    dh = cfg.resolved_head_dim
    return {"embed/table": cfg.vocab_size, "head/w": cfg.vocab_size,
            "wq": cfg.n_heads * dh, "wk": cfg.n_kv_heads * dh,
            "wv": cfg.n_kv_heads * dh, "wo": cfg.n_heads * dh,
            "w_gate": cfg.d_ff, "w_up": cfg.d_ff, "w_down": cfg.d_ff}


def shard_params(params, cfg, mesh: Mesh | None):
    """Rank ``mesh.rank``'s shard of a decoder parameter tree (numpy
    arrays or tensors): a cut leaf is a copy of the rank's slice, every
    other leaf the input leaf itself.

    Each rule leaf is cut on its split dim when that dim divides ``tp``;
    a leaf already cut to ``full / tp`` is kept, so a tree that was
    sharded on the way in (``convert.params_from_jax(..., mesh=)``)
    passes unchanged.  In the ``'pages'`` regime the attention leaves
    stay whole.  Norms and ``bo`` are replicated."""
    if mesh_model_tp(mesh) <= 1:
        return params
    full = _full_dims(cfg)
    heads = _regime(mesh, cfg.n_kv_heads) == "heads"

    def leaf(path: str, x):
        name = path.rsplit("/", 1)[-1]
        if name in ATTENTION_LEAVES and not heads:
            return x
        if name in _BIAS_OF:
            rule, axis = _BIAS_OF[name], x.ndim - 1
        else:
            spec = param_pspec(path, tuple(x.shape), mesh)
            if "model" not in spec:
                return x
            rule = next(s for s, _ in _RULES if path.endswith(s))
            axis = spec.index("model")
        n = full[rule]
        if n % mesh.tp:
            return x
        if x.shape[axis] == n // mesh.tp:
            return x
        if x.shape[axis] != n:
            raise ValueError(f"{path}: dim {axis} of {tuple(x.shape)} is "
                             f"neither {n} nor {n // mesh.tp}")
        return _split(x, axis, mesh)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, f"{path}/{i}")
                              for i, v in enumerate(tree))
        return leaf(path, tree)

    return walk(params, "")


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


def all_reduce(x: Tensor, mesh: Mesh, op: str = "sum",
               site: str = "") -> Tensor:
    """The element-wise ``op`` (``sum`` | ``max``) of ``x`` over the
    ranks, on ``x``'s device; the input is not kept."""
    buf = _staged(x, mesh)
    dist.all_reduce(buf, op=_REDUCE_OPS[op], group=mesh.group)
    mesh.log.add(site, f"all_reduce_{op}", buf)
    return buf.to(x.device, non_blocking=True)


def all_gather(x: Tensor, mesh: Mesh, dim: int, site: str = "") -> Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order, on
    ``x``'s device."""
    buf = _staged(x, mesh)
    parts = [torch.empty_like(buf) for _ in range(mesh.tp)]
    dist.all_gather(parts, buf, group=mesh.group)
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
