"""The port's Σe^x calibration (``core/calibration.py``) against the JAX
package's.

* ``row_exp_sums`` on the same numpy logits, f32, along the last and a
  middle axis, with causal −inf masks, whole −inf rows, +inf and NaN
  entries (the non-finite guard): within 1e-6 relative, equal where
  the JAX package's are 0.
* ``SumCollector``: the cap (an offer cut at ``max_samples``, later
  offers dropped), ``result()``'s count, mean, percentiles, max and
  histogram (counts and edges) against the JAX collector fed the same
  logits, the recommendations (``recommend_alpha_len``,
  ``recommend_sigma_cols``, default and other headroom) equal, and the
  empty collector's error; ``calibrate_from_logits`` and
  ``calibrate_model``.
* The samples a model offers: a scaled-down Qwen3 (2 layers, GQA) and a
  scaled-down Jamba (one attention layer among the Mamba ones) through
  the port's ``prefill`` and ``train_logits`` with a collector, against
  the JAX package's ``transformer.prefill`` / ``train_logits`` with its
  collector on the same weights and tokens: the same count, values
  within ``MODEL_TOL`` (1e-5) relative — the first layer's within 3e-7,
  later layers' carrying the f32 roundoff of the layers before them (the
  two packages sum their products in other orders).  The collector
  changes nothing else: the prefill's logits equal a prefill without
  one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRun
from repro.core import calibration as JCAL
from repro.models import transformer as JTF
from repro_torch.configs import RunConfig as TRun
from repro_torch.core import calibration as TCAL
from repro_torch.models.convert import params_from_jax
from torch_train_util import pair

torch.set_num_threads(1)

TOL = 1e-6
MODEL_TOL = 1e-5


def _logits(seed, shape=(2, 3, 9, 9), causal=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 4, shape).astype(np.float32)
    if causal:
        x = np.where(np.tril(np.ones(shape[-2:], bool)), x, -np.inf)
    return x.astype(np.float32)


def test_row_exp_sums_matches_jax():
    x = _logits(0)
    x[0, 0, 3] = -np.inf                   # a fully masked row
    x[1, 2, 5, 0] = np.inf
    x[1, 1, 4, 2] = np.nan
    for axis in (-1, 2):
        ref = np.asarray(JCAL.row_exp_sums(jnp.asarray(x), axis))
        got = TCAL.row_exp_sums(torch.from_numpy(x), axis).numpy()
        assert got.shape == ref.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=0)
    got = TCAL.row_exp_sums(torch.from_numpy(x)).numpy()
    assert got[0, 0, 3] == 0.0 and np.isfinite(got).all()
    # bf16 logits are summed in f32
    xb = torch.from_numpy(_logits(1, causal=False)).to(torch.bfloat16)
    np.testing.assert_allclose(
        TCAL.row_exp_sums(xb).numpy(),
        np.asarray(JCAL.row_exp_sums(jnp.asarray(xb.float().numpy()))),
        rtol=TOL)


def test_collector_cap():
    c = TCAL.SumCollector(max_samples=10)
    c.offer(torch.from_numpy(_logits(2, shape=(1, 1, 7, 7))))
    c.offer(torch.from_numpy(_logits(3, shape=(1, 1, 7, 7))))
    c.offer(torch.from_numpy(_logits(4, shape=(1, 1, 7, 7))))
    j = JCAL.SumCollector(max_samples=10)
    for seed in (2, 3, 4):
        j.offer(jnp.asarray(_logits(seed, shape=(1, 1, 7, 7))))
    assert c.result().count == j.result().count == 10
    np.testing.assert_allclose(c.samples(), np.concatenate(j._chunks),
                               rtol=TOL)
    with pytest.raises(ValueError, match="no Σe"):
        TCAL.SumCollector().result()


@pytest.mark.parametrize("hist", [dict(), dict(hist_bins=7,
                                               hist_range=(0.0, 4.0))])
def test_result_and_recommendations_match_jax(hist):
    xs = [_logits(s, shape=(2, 4, 33, 33)) for s in range(3)]
    got = TCAL.calibrate_from_logits([torch.from_numpy(x) for x in xs],
                                     **hist)
    ref = JCAL.calibrate_from_logits([jnp.asarray(x) for x in xs], **hist)
    assert got.count == ref.count == 3 * 2 * 4 * 33
    for f in ("mean", "p50", "p99", "p999", "max"):
        assert getattr(got, f) == pytest.approx(getattr(ref, f), rel=TOL), f
    np.testing.assert_array_equal(got.hist_counts, ref.hist_counts)
    np.testing.assert_array_equal(got.hist_edges, ref.hist_edges)
    assert got.hist_edges[0] == hist.get("hist_range", (0.0, 500.0))[0]
    for h in (1.25, 1.0, 2.0):
        assert got.recommend_alpha_len(h) == ref.recommend_alpha_len(h)
        assert got.recommend_sigma_cols(h) == ref.recommend_sigma_cols(h)
    assert got.recommend_sigma_cols() >= 2


def test_calibrate_model_runs_apply_fn():
    xs = [torch.from_numpy(_logits(s)) for s in range(2)]
    seen = []

    def apply_fn(x, collector):
        seen.append(x)
        collector.offer(x)

    res = TCAL.calibrate_model(apply_fn, xs)
    assert len(seen) == 2 and res.count == 2 * 2 * 3 * 9


@pytest.mark.parametrize("name", ["qwen3-32b", "jamba-v0.1-52b"])
def test_model_samples_match_jax(name):
    jm, tm, jp = pair(name, seed=1, d_model=64, vocab=128)
    tokens = np.random.default_rng(2).integers(0, 128, (2, 11)).astype(
        np.int32)
    jrun = JRun(dtype="float32", attention_backend="naive")
    trun = TRun(dtype="float32")
    tp = params_from_jax(jp, device="cpu")
    n_attn = jm.cfg.n_periods * sum(s.mixer == "attn" for s in jm.cfg.period)

    j = JCAL.SumCollector()
    JTF.prefill(jp, jnp.asarray(tokens), jm.cfg, jrun, 11, collector=j)
    t = TCAL.SumCollector()
    logits, _ = tm.prefill(tp, torch.from_numpy(tokens), trun, 11,
                           collector=t)
    assert t.result().count == j.result().count == n_attn * 11
    np.testing.assert_allclose(t.samples(), np.concatenate(j._chunks),
                               rtol=MODEL_TOL)
    plain, _ = tm.prefill(tp, torch.from_numpy(tokens), trun, 11)
    assert torch.equal(logits, plain)

    j = JCAL.SumCollector()
    JTF.train_logits(jp, jnp.asarray(tokens), jm.cfg, jrun, collector=j)
    t = TCAL.SumCollector()
    tm.train_logits(tp, torch.from_numpy(tokens), trun, collector=t)
    assert t.result().count == j.result().count
    np.testing.assert_allclose(t.samples(), np.concatenate(j._chunks),
                               rtol=MODEL_TOL)


def test_encdec_prefill_refuses_collector():
    _, tm, jp = pair("whisper-small", seed=0, d_model=64, vocab=128)
    with pytest.raises(ValueError, match="decoder-only"):
        tm.prefill(params_from_jax(jp, device="cpu"),
                   torch.zeros((1, 3), dtype=torch.int32),
                   TRun(dtype="float32"), 3,
                   encoder_input=torch.zeros((1, 32, 64)),
                   collector=TCAL.SumCollector())
