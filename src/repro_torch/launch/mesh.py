"""The tensor-parallel serving mesh, and the ranks that run it.

The counterpart of the JAX package's ``launch/mesh.make_serving_mesh``.
JAX builds a mesh over one process's devices; here a mesh is one rank's
view of a ``torch.distributed`` process group, so serving at ``tp`` ranks
starts ``tp`` processes (:func:`start_ranks`), each of which joins the
group over a ``file://`` store in a directory on the local disk — no
network — and builds its :class:`~repro_torch.runtime.partitioning.Mesh`
with :func:`make_serving_mesh`.

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
    """Join the ``tp``-rank process group as ``rank`` and return its mesh.

    ``store`` is the path of the ``file://`` rendezvous file every rank
    names (unused at ``tp == 1``, which needs no group).  Under nccl the
    host plans travel over an extra gloo group; under gloo over the
    default group itself."""
    check_backend(tp, backend, device)
    dev = rank_device(backend, device, rank)
    if tp == 1:
        return Mesh(tp=1, rank=0, device=dev, backend=backend)
    if store is None:
        raise ValueError("tp > 1 needs the path of a file:// store")
    if backend == "nccl":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=tp, timeout=timeout)
    group = dist.group.WORLD
    plans = (group if backend == "gloo"
             else dist.new_group(backend="gloo", timeout=timeout))
    return Mesh(tp=tp, rank=rank, device=dev, backend=backend, group=group,
                plan_group=plans)


def _rank_main(rank, fn, tp, backend, device, store_dir, threads, args):
    if threads:
        torch.set_num_threads(threads)
    mesh = make_serving_mesh(tp, backend=backend, device=device, rank=rank,
                             store=os.path.join(store_dir, "store"))
    try:
        out = fn(mesh, *args)
        if rank == 0:
            with open(os.path.join(store_dir, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


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


def start_ranks(fn, tp: int, *, backend: str, device="cuda", args=(),
                store_dir: str | None = None, threads: int = 1) -> Ranks:
    """Start ``fn(mesh, *args)`` in ``tp`` spawned processes, one a rank.

    ``fn`` must be importable (a module-level function) and ``args``
    picklable.  Rank 0's return value is pickled into ``store_dir`` (a
    new temporary directory by default, which also holds the ``file://``
    store) for :meth:`Ranks.join`.  A rank that raises makes ``join``
    raise and ends the others.  ``threads`` caps each rank's intra-op
    threads (0: torch's default)."""
    check_backend(tp, backend, device)
    store_dir = store_dir or tempfile.mkdtemp(prefix="tp_store_")
    os.makedirs(store_dir, exist_ok=True)
    context = mp.start_processes(
        _rank_main, args=(fn, tp, backend, str(device), str(store_dir),
                          threads, tuple(args)),
        nprocs=tp, join=False, start_method="spawn")
    return Ranks(context, str(store_dir))


def spawn_ranks(fn, tp: int, **kw):
    """:func:`start_ranks`, joined: rank 0's result."""
    return start_ranks(fn, tp, **kw).join()
