"""The meshes — serving, training and pipeline — and the ranks that run
them.

The counterpart of the JAX package's ``launch/mesh.py``
(``make_serving_mesh``, ``make_host_mesh``).  JAX builds a mesh over one
process's devices; here a mesh is one rank's view of a
``torch.distributed`` process group, so a mesh of n ranks starts n
processes (:func:`start_ranks`), each of which joins the group over a
``file://`` store in a directory on the local disk — no network — and
builds its :class:`~repro_torch.runtime.partitioning.Mesh`:
:func:`make_serving_mesh` (``tp`` ranks over ``'model'``),
:func:`make_host_mesh` (``('data', 'model')``, training) or
:func:`make_pipe_mesh` (``('pipe',)``).

The backend is the caller's choice, never a fallback: ``nccl`` needs one
CUDA device a rank (rank r runs on ``cuda:r``) and raises when the host
has fewer; ``gloo`` runs every rank on the device it is given — the CPU,
or one card that all ranks share (a correctness run, not a parallel
one: gloo stages each collective through the host).
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.models.device import resolve_device
from repro_torch.runtime.partitioning import BACKENDS, Mesh

#: seconds a collective may wait for the other ranks before it fails
TIMEOUT_S = 600


def rank_device(backend: str, device, rank: int) -> torch.device:
    """The device of ``rank``: ``cuda:rank`` under nccl, else ``device``."""
    device = resolve_device(device)
    if backend == "nccl":
        return torch.device("cuda", rank)
    return device


def check_backend(tp: int, backend: str, device) -> None:
    """Raise unless ``backend`` can run ``tp`` ranks on ``device``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: expected one of "
                         f"{BACKENDS}")
    if tp < 1:
        raise ValueError(f"tp {tp} < 1")
    if backend == "nccl":
        if torch.device(device).type != "cuda":
            raise ValueError("the nccl backend runs on CUDA devices; use "
                             "gloo on the CPU")
        n = torch.cuda.device_count()
        if n < tp:
            raise ValueError(f"--tp {tp} over nccl needs one CUDA device a "
                             f"rank; the host has {n} (gloo can share one)")


def make_serving_mesh(tp: int, *, backend: str, device, rank: int = 0,
                      store: str | None = None) -> Mesh:
    """Join the ``tp``-rank process group as ``rank`` and return its mesh
    (``data = 1``).

    ``store`` is the path of the ``file://`` rendezvous file every rank
    names (unused at ``tp == 1``, which needs no group).  Under nccl the
    host plans travel over an extra gloo group; under gloo over the
    default group itself."""
    return make_host_mesh(1, tp, backend=backend, device=device, rank=rank,
                          store=store)


def _join(world: int, backend: str, rank: int, store: str | None):
    if store is None:
        raise ValueError("a mesh of more than one rank needs the path of "
                         "a file:// store")
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world, timeout=timeout)
    return timeout


def _groups(rows: list[list[int]], backend: str, timeout):
    """One group for each row of world ranks: every rank creates every
    group, in the same order (``new_group`` is collective), and keeps
    the one it is in."""
    if len(rows) == 1:
        return dist.group.WORLD
    mine = None
    for row in rows:
        g = dist.new_group(row, backend=backend, timeout=timeout)
        if dist.get_rank() in row:
            mine = g
    return mine


def make_host_mesh(data: int, model: int, *, backend: str, device,
                   rank: int = 0, store: str | None = None) -> Mesh:
    """Join a ``data · model``-rank process group as world ``rank`` and
    return its ``('data', 'model')`` mesh (the JAX package's
    ``make_host_mesh``): rank = ``d · model + m``, one group a row of
    the ``'model'`` axis and one a column of ``'data'``."""
    world = data * model
    check_backend(world, backend, device)
    dev = rank_device(backend, device, rank)
    d, m = divmod(rank, model)
    if world == 1:
        return Mesh(tp=1, rank=0, device=dev, backend=backend)
    if backend == "nccl":
        torch.cuda.set_device(dev)
    timeout = _join(world, backend, rank, store)
    model_rows = [[i * model + j for j in range(model)] for i in range(data)]
    data_rows = [[i * model + j for i in range(data)] for j in range(model)]
    group = _groups(model_rows, backend, timeout) if model > 1 else None
    data_group = _groups(data_rows, backend, timeout) if data > 1 else None
    plans = None
    if data == 1:
        plans = (group if backend == "gloo"
                 else dist.new_group(backend="gloo", timeout=timeout))
    return Mesh(tp=model, rank=m, device=dev, backend=backend, group=group,
                plan_group=plans, data=data, data_rank=d,
                data_group=data_group)


def make_pipe_mesh(stages: int, *, backend: str, device, rank: int = 0,
                   store: str | None = None) -> Mesh:
    """Join a ``stages``-rank process group as ``rank`` and return its
    ``('pipe',)`` mesh (GPipe, ``runtime/pipeline.py``)."""
    check_backend(stages, backend, device)
    dev = rank_device(backend, device, rank)
    if stages == 1:
        return Mesh(tp=1, rank=0, device=dev, backend=backend, pipe=1)
    if backend == "nccl":
        torch.cuda.set_device(dev)
    _join(stages, backend, rank, store)
    return Mesh(tp=1, rank=0, device=dev, backend=backend, pipe=stages,
                pipe_rank=rank, pipe_group=dist.group.WORLD)


def _make_mesh(axes, backend, device, rank, store):
    if "pipe" in axes:
        return make_pipe_mesh(axes["pipe"], backend=backend, device=device,
                              rank=rank, store=store)
    return make_host_mesh(axes.get("data", 1), axes.get("model", 1),
                          backend=backend, device=device, rank=rank,
                          store=store)


def _leave() -> None:
    """A rank's clean exit: every rank meets at a barrier, so none tears
    its group down while another still talks to it, then the group
    goes."""
    if dist.is_initialized():
        try:
            dist.barrier()
        finally:
            dist.destroy_process_group()


def _rank_main(rank, fn, axes, backend, device, store_dir, threads, args):
    if threads:
        torch.set_num_threads(threads)
    mesh = _make_mesh(axes, backend, device, rank,
                      os.path.join(store_dir, "store"))
    try:
        out = fn(mesh, *args)
        if rank == 0:
            with open(os.path.join(store_dir, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
    except BaseException:
        if dist.is_initialized():
            dist.destroy_process_group()
        raise
    _leave()


class Ranks:
    """``tp`` running rank processes; :meth:`join` waits for all of them
    and returns rank 0's result."""

    def __init__(self, context, store_dir: str):
        self._context = context
        self.store_dir = store_dir

    def join(self):
        while not self._context.join():
            pass
        with open(os.path.join(self.store_dir, "result.pkl"), "rb") as f:
            return pickle.load(f)  # written by rank 0 of this program


def start_ranks(fn, tp: int | None = None, *, backend: str,
                device="cuda", args=(), store_dir: str | None = None,
                threads: int = 1, axes: dict | None = None) -> Ranks:
    """Start ``fn(mesh, *args)`` in spawned processes, one a rank.

    The mesh is the serving mesh of ``tp`` ranks, or the one ``axes``
    names: ``{"data": d, "model": m}`` (``make_host_mesh``, ``d · m``
    ranks) or ``{"pipe": s}`` (``make_pipe_mesh``).  ``fn`` must be
    importable (a module-level function) and ``args`` picklable.  Rank
    0's return value is pickled into ``store_dir`` (a new temporary
    directory by default, which also holds the ``file://`` store) for
    :meth:`Ranks.join`.  A rank that raises makes ``join`` raise and
    ends the others; a rank that returns meets the others at a barrier
    and leaves its group.  ``threads`` caps each rank's intra-op
    threads (0: torch's default)."""
    if axes is None:
        axes = {"data": 1, "model": tp}
    elif tp is not None:
        raise ValueError("give tp or axes, not both")
    world = int(np.prod(list(axes.values())))
    check_backend(world, backend, device)
    store_dir = store_dir or tempfile.mkdtemp(prefix="tp_store_")
    os.makedirs(store_dir, exist_ok=True)
    context = mp.start_processes(
        _rank_main, args=(fn, dict(axes), backend, str(device),
                          str(store_dir), threads, tuple(args)),
        nprocs=world, join=False, start_method="spawn")
    return Ranks(context, str(store_dir))


def spawn_ranks(fn, tp: int, **kw):
    """:func:`start_ranks`, joined: rank 0's result."""
    return start_ranks(fn, tp, **kw).join()
