"""Atomic checkpoints in the JAX package's on-disk format.

Layout (``checkpoint/ckpt.py`` of the JAX package, letter for letter)::

    <dir>/step_00000100.tmp-<nonce>/   ← written first
        index.json                     ← step, meta, and per leaf its
                                         path, file, shape and dtype
        a00000.npy … aNNNNN.npy        ← one file per leaf
    <dir>/step_00000100/               ← atomic rename on completion

Leaf paths are the JAX package's strings (``models.convert.
tree_flatten``): a ``TrainState`` writes ``.params/embed/table``,
``.params/periods/0/ffn/w_down``, ``.opt/.step``, ``.opt/.m/…``,
``.opt/.v/…`` and, under grad compression, ``.ef/…`` — so either
package restores the other's checkpoints.  Leaves are float32 or int32,
as the JAX package's f32 masters and int32 step are; any other dtype (a
bf16 serving copy, say) is refused rather than written in a type the
other package would not read back the same.
"""

from __future__ import annotations

import json
import os
import secrets
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.models.convert import tree_flatten, tree_unflatten

Tree = Any

INDEX = "index.json"
LEAF_DTYPES = ("float32", "int32")


def host_array(path: str, leaf) -> np.ndarray:
    """``leaf`` on the host: a tensor on any device is copied, so later
    in-place writes to it do not reach the copy; an array is taken as
    it is.  Raises on a dtype other than float32 or int32."""
    dtype = str(leaf.dtype).removeprefix("torch.")
    if dtype not in LEAF_DTYPES:
        raise TypeError(f"checkpoint leaf {path!r} is {dtype}; "
                        f"checkpoints hold float32 and int32 leaves only "
                        f"(save the f32 masters, not a cast copy)")
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def save_pytree(directory: str, tree: Tree, step: int,
                meta: dict | None = None) -> str:
    """Write an atomic checkpoint of ``tree``; returns its final path."""
    final = os.path.join(directory, f"step_{step:08d}")
    leaves = [(p, host_array(p, leaf)) for p, leaf in tree_flatten(tree)]
    tmp = final + f".tmp-{secrets.token_hex(4)}"
    os.makedirs(tmp, exist_ok=True)
    index = {"step": step, "meta": meta or {}, "leaves": []}
    for i, (p, arr) in enumerate(leaves):
        fname = f"a{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        index["leaves"].append({"path": p, "file": fname,
                                "shape": list(arr.shape),
                                "dtype": str(arr.dtype)})
    with open(os.path.join(tmp, INDEX), "w") as f:
        json.dump(index, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def restore_pytree(path: str, like: Tree) -> Tree:
    """Restore into the structure of ``like``: each leaf of the
    checkpoint at ``like``'s leaf's path, in the checkpoint's dtype, on
    ``like``'s leaf's device (the CPU for an array), requiring grad
    where it does.  A missing leaf raises ``KeyError``, a shape that
    differs ``ValueError``."""
    with open(os.path.join(path, INDEX)) as f:
        index = json.load(f)
    by_path = {e["path"]: e for e in index["leaves"]}
    out = []
    for p, leaf in tree_flatten(like):
        if p not in by_path:
            raise KeyError(f"checkpoint missing leaf {p!r}")
        e = by_path[p]
        arr = np.load(os.path.join(path, e["file"]))
        want = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != want:
            raise ValueError(f"shape mismatch for {p}: ckpt {arr.shape} "
                             f"vs model {want}")
        t = torch.from_numpy(arr.astype(np.dtype(e["dtype"])))
        if isinstance(leaf, torch.Tensor):
            t = t.to(leaf.device).requires_grad_(leaf.requires_grad)
        out.append(t)
    return tree_unflatten(like, out)


def checkpoint_step(path: str) -> int:
    with open(os.path.join(path, INDEX)) as f:
        return int(json.load(f)["step"])


def checkpoint_meta(path: str) -> dict:
    with open(os.path.join(path, INDEX)) as f:
        return json.load(f)["meta"]
