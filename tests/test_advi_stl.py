"""Sticking-the-landing (STL) ELBO gradient estimator (ADVI.fit(estimator=)).

STL (Roeder, Wu & Duvenaud, NeurIPS 2017) evaluates log q at stopped
variational parameters so the ELBO gradient keeps only the path derivative.
Properties pinned here:

- same loss VALUE as the analytic-entropy estimator (v == eps identically);
- same gradient EXPECTATION (both are unbiased reparameterized estimators);
- gradient variance -> 0 as q -> p (the whole point): at the exact optimum
  the STL gradient is ~0 per-draw while the analytic one is MC-noisy;
- end-to-end: polishing a warm start with STL lands far below the analytic
  estimator's variance floor at the same learning rate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from gsmvi_jax import ADVI
from gsmvi_jax.models import dense_gaussian


def _params_at(t):
    loc = jnp.asarray(t.mean)
    l = jnp.tril(jnp.linalg.cholesky(jnp.asarray(t.cov)))
    return loc, l


def _grad(advi, params, key, batch_size, estimator):
    return jax.grad(
        lambda p: advi.neg_elbo(p, key, batch_size, estimator))(params)


def _gnorm(g):
    return float(jnp.sqrt(jnp.sum(g[0] ** 2) + jnp.sum(jnp.tril(g[1]) ** 2)))


def test_stl_loss_value_matches_analytic():
    t = dense_gaussian(jax.random.PRNGKey(3), 8)
    advi = ADVI(D=8, lp=t.lp)
    loc, l = _params_at(t)
    loc = loc + 0.3
    key = jax.random.PRNGKey(0)
    va = advi.neg_elbo((loc, l), key, 16, "analytic")
    vs = advi.neg_elbo((loc, l), key, 16, "stl")
    np.testing.assert_allclose(float(vs), float(va), rtol=1e-8)


def test_stl_gradient_vanishes_at_optimum():
    """At q == p the analytic estimator's gradient is O(1/sqrt(B)) noise;
    STL's is ~0 per-draw (exactly 0 in exact arithmetic for a Gaussian
    target: the path term cancels the score term sample-by-sample)."""
    t = dense_gaussian(jax.random.PRNGKey(3), 16)
    advi = ADVI(D=16, lp=t.lp)
    params = _params_at(t)
    norms = {"analytic": [], "stl": []}
    for s in range(4):
        key = jax.random.PRNGKey(100 + s)
        for est in norms:
            norms[est].append(_gnorm(_grad(advi, params, key, 16, est)))
    assert np.mean(norms["stl"]) < 1e-3 * np.mean(norms["analytic"])


def test_stl_gradient_same_expectation():
    """Both estimators are unbiased for the same ELBO: their gradient
    expectations agree within MC error at a non-optimal point."""
    t = dense_gaussian(jax.random.PRNGKey(5), 4)
    advi = ADVI(D=4, lp=t.lp)
    loc, l = _params_at(t)
    params = (loc + 0.5, 0.8 * l)
    keys = jax.random.split(jax.random.PRNGKey(0), 4000)

    def mean_grad(est):
        g = jax.vmap(lambda k: _grad(advi, params, k, 8, est))(keys)
        return (jnp.mean(g[0], 0), jnp.mean(jnp.tril(g[1]), 0))

    ga, gs = mean_grad("analytic"), mean_grad("stl")
    scale = float(jnp.abs(ga[0]).max()) + float(jnp.abs(ga[1]).max())
    np.testing.assert_allclose(np.asarray(gs[0]), np.asarray(ga[0]),
                               atol=0.05 * scale)
    np.testing.assert_allclose(np.asarray(gs[1]), np.asarray(ga[1]),
                               atol=0.05 * scale)


def test_stl_polish_beats_analytic_floor():
    """Started exactly AT the optimum, the analytic estimator diffuses away
    to its stationary variance floor (Adam keeps taking ~lr-sized steps on
    MC-noisy gradients) while STL stays pinned — the 'polish' phase of the
    two-phase recipe (docs/DERIVATIONS.md §7) in its purest form."""
    d = 12
    t = dense_gaussian(jax.random.PRNGKey(7), d)
    errs = {}
    for est in ("analytic", "stl"):
        advi = ADVI(D=d, lp=t.lp)
        mean, cov, _ = advi.fit(jax.random.PRNGKey(2), optax.adam(5e-3),
                                mean=jnp.asarray(t.mean),
                                cov=jnp.asarray(t.cov), batch_size=16,
                                niter=2000, verbose=False,
                                return_losses=False, estimator=est)
        scale = max(1.0, float(np.abs(np.asarray(t.cov)).max()))
        errs[est] = (np.abs(np.asarray(mean) - np.asarray(t.mean)).max()
                     + np.abs(np.asarray(cov) - np.asarray(t.cov)).max()
                     / scale)
    assert errs["stl"] < 0.1 * errs["analytic"], errs


def test_stl_under_mesh_runs():
    """estimator='stl' composes with the data mesh (the triangular solve is
    per-row independent, so GSPMD shards it with the batch)."""
    from gsmvi_jax.parallel.mesh import make_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs multiple (virtual) devices")
    mesh = make_mesh()
    t = dense_gaussian(jax.random.PRNGKey(1), 6)
    advi = ADVI(D=6, lp=t.lp, mesh=mesh)
    mean, cov, _ = advi.fit(jax.random.PRNGKey(0), optax.adam(1e-2),
                            batch_size=16, niter=40, verbose=False,
                            estimator="stl")
    assert np.all(np.isfinite(np.asarray(mean)))
    assert np.all(np.isfinite(np.asarray(cov)))


def test_bad_estimator_raises():
    t = dense_gaussian(jax.random.PRNGKey(1), 4)
    advi = ADVI(D=4, lp=t.lp)
    with pytest.raises(ValueError, match="estimator"):
        advi.neg_elbo(_params_at(t), jax.random.PRNGKey(0), 8, "bogus")
