"""GPipe in the port against the JAX package's ``gpipe_forward``.

The port's counterpart of ``test_gpipe_forward_matches_sequential``
(``tests/test_multidevice.py``): 4 stages of ``tanh(x @ w)``, 6
microbatches of 3 × 16.  The port runs one spawned gloo rank a stage
(``repro_torch.launch.mesh.start_ranks`` with a ``('pipe',)`` mesh; no
network); the JAX package's ``gpipe_forward`` runs in a subprocess on 4
forced host devices, on the same numpy weights and inputs.  The output
is held within rtol 1e-5 / atol 1e-6, and the gradients of ``Σ out²``
within rtol 1e-4 / atol 1e-5, against the JAX pipeline and the
sequential loop.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import start_ranks
from repro_torch.runtime.pipeline import make_stage_fn

import torch_multirank_ranks as M

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STAGES, N_MICRO, MB, D = 4, 6, 3, 16

_JAX_GPIPE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.compat import make_mesh
from repro.runtime.pipeline import gpipe_forward
data = np.load(sys.argv[1])
ws, x = jnp.asarray(data['ws']), jnp.asarray(data['x'])
mesh = make_mesh((ws.shape[0],), ('pipe',))
stage = lambda w, h: jnp.tanh(h @ w)
out = gpipe_forward(stage, ws, x, mesh, axis='pipe')
g = jax.grad(lambda w: jnp.sum(gpipe_forward(stage, w, x, mesh,
                                             axis='pipe') ** 2))(ws)
np.savez(sys.argv[2], out=np.asarray(out), g=np.asarray(g))
"""


@pytest.fixture(scope="module")
def piped(tmp_path_factory):
    rng = np.random.default_rng(0)
    ws = (rng.normal(size=(N_STAGES, D, D)) * 0.3).astype(np.float32)
    x = rng.normal(size=(N_MICRO, MB, D)).astype(np.float32)
    tmp = tmp_path_factory.mktemp("gpipe")
    np.savez(tmp / "in.npz", ws=ws, x=x)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{N_STAGES}")
    jax_run = subprocess.Popen(
        [sys.executable, "-c", _JAX_GPIPE, str(tmp / "in.npz"),
         str(tmp / "out.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    ranks = start_ranks(M.gpipe, backend="gloo", device="cpu",
                        axes={"pipe": N_STAGES}, args=(ws, x),
                        store_dir=str(tmp / "store"))
    try:
        _, err = jax_run.communicate(timeout=300)
        assert jax_run.returncode == 0, err
        port = ranks.join()
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
    ref = np.load(tmp / "out.npz")

    def seq(w):
        r = jnp.asarray(x)
        for s in range(N_STAGES):
            r = jnp.tanh(r @ w[s])
        return r
    return dict(port=port, jax=(ref["out"], ref["g"]),
                seq=(np.asarray(seq(jnp.asarray(ws))),
                     np.asarray(jax.grad(lambda w: jnp.sum(seq(w) ** 2))(
                         jnp.asarray(ws)))))


@pytest.mark.parametrize("against", ["jax", "seq"])
def test_gpipe_forward_matches(piped, against):
    out, _ = piped["port"]
    np.testing.assert_allclose(out, piped[against][0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("against", ["jax", "seq"])
def test_gpipe_gradients_match(piped, against):
    _, grads = piped["port"]
    np.testing.assert_allclose(grads, piped[against][1], rtol=1e-4,
                               atol=1e-5)


def test_make_stage_fn_scans_its_periods():
    """A stage of two periods applies them in order, as the JAX
    package's scan does."""
    w = torch.randn(2, 4, 4, generator=torch.Generator().manual_seed(1))
    x = torch.randn(3, 4, generator=torch.Generator().manual_seed(2))
    stage = make_stage_fn(lambda p, h: torch.tanh(h @ p["w"]), 2)
    want = torch.tanh(torch.tanh(x @ w[0]) @ w[1])
    assert torch.equal(stage({"w": w}, x), want)
