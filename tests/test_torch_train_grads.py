"""Gradients of the port's training forward against ``jax.value_and_grad``.

* ``Model.train_logits`` through the loss (``make_loss_fn``: cross
  entropy plus 0.05 × the MoE load-balance loss) and its backward, f32,
  against the JAX package's loss and ``jax.value_and_grad`` on the same
  numpy weights and tokens: the loss within 1e-5 relative and each
  gradient leaf, by its checkpoint path, within ``GRAD_TOL`` (1e-4) of
  its largest entry, for Qwen3 (dense, qk-norm), Granite-MoE (tied
  embeddings, the routing backward through the gates and the aux
  loss), Jamba and xLSTM (one period, d_model 64: the Mamba, mLSTM and
  sLSTM step loops under autograd) and Whisper (encoder-decoder, the
  same numpy ``encoder_input``) — with ``run.remat`` on and off.
* ``apply_moe(..., return_aux=True)``'s load-balance loss and router
  entropy against the JAX ``apply_moe``'s, with and without a padded
  tail group; ``train_logits``' ``aux`` sums them over the MoE blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRun
from repro.models import moe as JMOE
from repro.runtime import train_loop as JTL
from repro_torch.configs import RunConfig as TRun
from repro_torch.models import moe as TMOE
from repro_torch.models.convert import (params_from_jax, tree_flatten,
                                        tree_unflatten)
from repro_torch.runtime import train_loop as TTL
from torch_train_util import FAMILIES, close_by_path, make_batch, pair, \
    torch_batch

torch.set_num_threads(1)

GRAD_TOL = 1e-4         # of each gradient leaf's largest entry
ZERO_GRAD_FLOOR = 1e-3  # ... or of this share of the tree's largest entry


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_train_logits_gradients_match_jax(name):
    jm, tm, jp = pair(name)
    batch = make_batch(jm.cfg, 2, 12, seed=1)
    jrun = JRun(dtype="float32", attention_backend="naive", remat=True,
                moe_aux_weight=0.05)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        JTL.make_loss_fn(jm, jrun), has_aux=True))(
        jp, jax.tree_util.tree_map(jnp.asarray, batch))
    for remat in (True, False):
        trun = TRun(dtype="float32", remat=remat, moe_aux_weight=0.05)
        tp = params_from_jax(jp, device="cpu")
        for _, p in tree_flatten(tp):
            p.requires_grad_(True)
        loss, _ = TTL.make_loss_fn(tm, trun)(tp, torch_batch(batch))
        loss.backward()
        assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
        grads = tree_unflatten(tp, [p.grad for _, p in tree_flatten(tp)])
        # a key bias's gradient is 0 in exact arithmetic (the softmax
        # ignores a constant added to a query's every logit): both
        # packages give roundoff there, held to ZERO_GRAD_FLOOR of the
        # tree's largest entry
        close_by_path(grads, jg, GRAD_TOL, f"{name} grads remat={remat}",
                      floor=ZERO_GRAD_FLOOR)


def test_moe_aux_losses_match_jax():
    """The load-balance loss and router entropy, also over a padded tail
    group (the JAX package counts its padding rows as expert 0)."""
    rng = np.random.default_rng(4)
    d, e, k = 32, 8, 2
    jp = jax.tree_util.tree_map(np.asarray, JMOE.init_moe(
        jax.random.PRNGKey(1), d, 16, e, 0))
    tp = params_from_jax(jp, device="cpu")
    for t, group in ((24, 4096), (21, 8)):
        x = rng.normal(size=(1, t, d)).astype(np.float32)
        kn = dict(n_experts=e, top_k=k, group_size=group)
        jout, jaux = JMOE.apply_moe(jp, jnp.asarray(x), **kn)
        tout, taux = TMOE.apply_moe(tp, torch.from_numpy(x),
                                    return_aux=True, **kn)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                                   atol=1e-5 * np.abs(jout).max())
        for key in ("load_balance_loss", "router_entropy"):
            assert float(taux[key]) == pytest.approx(float(jaux[key]),
                                                     rel=1e-5), key


def test_train_logits_aux_sums_moe_blocks():
    jm, tm, jp = pair("granite-moe-3b-a800m")
    toks = make_batch(jm.cfg, 2, 10, seed=2)["tokens"][:, :-1]
    jrun = JRun(dtype="float32", attention_backend="naive")
    jl, jaux = jm.train_logits(jp, jnp.asarray(toks), jrun)
    tl, taux = tm.train_logits(params_from_jax(jp, device="cpu"),
                               torch.from_numpy(toks), TRun(dtype="float32"))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=0,
                               atol=1e-5 * np.abs(jl).max())
    assert float(taux["load_balance_loss"]) == pytest.approx(
        float(jaux["load_balance_loss"]), rel=1e-5)
    assert float(taux["load_balance_loss"]) > 0


