"""Helpers shared by the port's training tests: the JAX package's
checkpoint path strings of a tree, a leaf-by-leaf comparison by path, and
the scaled-down JAX / port model pairs with their numpy batches."""

import jax
import numpy as np
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import build_model as jax_build
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.models import build_model as torch_build
from repro_torch.models.convert import tree_flatten

VOCAB = 128


def jax_paths(tree):
    """(path, numpy leaf) in the JAX checkpoint's spelling."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), np.asarray(leaf)) for path, leaf in flat]


def close_by_path(got, ref, tol, what, floor=0.0):
    """Every leaf of the port's tree ``got`` within ``tol`` of the largest
    entry of the JAX tree ``ref``'s leaf at the same path — or of
    ``floor`` times the tree's largest entry, where that is larger."""
    ref = dict(jax_paths(ref))
    got = dict(tree_flatten(got))
    assert sorted(got) == sorted(ref), what
    top = max(float(np.abs(r).max()) for r in ref.values())
    for path, r in ref.items():
        g = got[path].detach().float().numpy()
        assert g.shape == r.shape, (what, path)
        scale = max(float(np.abs(r).max()), floor * top, 1e-30)
        np.testing.assert_allclose(g, r, rtol=0, atol=tol * scale,
                                   err_msg=f"{what}: {path}")


FAMILIES = {"qwen3-32b": dict(n_periods=2),
            "granite-moe-3b-a800m": dict(n_periods=2),
            "jamba-v0.1-52b": dict(n_periods=1),
            "xlstm-125m": dict(n_periods=1),
            "whisper-small": dict(n_periods=1)}


def pair(name, seed=0, d_model=64, vocab=VOCAB):
    """The JAX and the port's model of ``name`` scaled down, with the JAX
    init's numpy parameters."""
    kw = dict(d_model=d_model, n_heads=4, vocab=vocab, **FAMILIES.get(
        name, dict(n_periods=2)))
    jarch = JARCHS[name].scaled_down(**kw)
    jm = jax_build(jarch)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    tm = torch_build(TARCHS[name].scaled_down(**kw))
    return jm, tm, jp


def make_batch(arch, b, s, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, arch.vocab_size, (b, s + 1))
             .astype(np.int32)}
    if arch.encoder_layers:
        batch["encoder_input"] = rng.normal(
            0, 1, (b, arch.encoder_seq, arch.d_model)).astype(np.float32)
    return batch


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}
