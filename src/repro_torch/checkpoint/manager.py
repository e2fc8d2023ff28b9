"""Checkpoint manager: keep-N rotation, latest-resume, async save.

The JAX package's ``checkpoint/manager.py`` in torch.  ``save`` copies
every leaf to the host before it returns (``ckpt.host_array``), so an
async save writes the values of the step it was called at even when the
next optimizer step overwrites the tensors in place (on the CPU,
``t.cpu()`` is ``t`` itself); only the disk writes run on the worker
thread.  ``wait()`` drains a pending save — call it before shutdown and
in tests.

A sharded training state is saved whole (``save(..., mesh=)``: rank 0
writes what the ranks gathered) and restored whole, then cut for the
mesh it continues on (``train_loop.shard_train_state``): the files do
not know the mesh, as the JAX package's do not.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any

import torch.distributed as dist

from repro_torch.checkpoint.ckpt import (checkpoint_step, host_array,
                                         restore_pytree, save_pytree)
from repro_torch.models.convert import tree_flatten, tree_unflatten

Tree = Any

_STEP_RE = re.compile(r"^step_(\d{8})$")


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3,
                 async_save: bool = False):
        self.directory = directory
        self.keep_n = keep_n
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- discovery --------------------------------------------------------

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_path(self) -> str | None:
        steps = self.all_steps()
        if not steps:
            return None
        return os.path.join(self.directory, f"step_{steps[-1]:08d}")

    # -- save / restore ---------------------------------------------------

    def save(self, tree: Tree, step: int, meta: dict | None = None, *,
             mesh=None) -> None:
        """Save ``tree``.  With a ``mesh`` of more than one rank every
        rank calls this with the same whole tree (a sharded
        ``TrainState`` reassembled by ``train_loop.gather_train_state``):
        rank 0 writes it and the others wait at a barrier until the
        files are there, so the checkpoint restores on any mesh."""
        if mesh is not None and mesh.tp * mesh.data > 1:
            if mesh.world_rank == 0:
                CheckpointManager(self.directory, self.keep_n).save(
                    tree, step, meta)
            dist.barrier()
            return
        host_tree = tree_unflatten(tree, [host_array(p, leaf)
                                          for p, leaf in tree_flatten(tree)])

        def work():
            save_pytree(self.directory, host_tree, step, meta)
            self._gc()

        if self.async_save:
            self.wait()
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def restore_latest(self, like: Tree) -> tuple[Tree, int] | None:
        path = self.latest_path()
        if path is None:
            return None
        return restore_pytree(path, like), checkpoint_step(path)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- retention --------------------------------------------------------

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
