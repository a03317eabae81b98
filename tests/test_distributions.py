"""Native MVN primitives vs scipy.stats and analytic identities."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import stats

from gsmvi_jax.distributions import (Gaussian, mvn_entropy, mvn_kl,
                                     mvn_logpdf, mvn_sample, safe_cholesky)


def make_mvn(rng, d):
    mean = rng.normal(size=d)
    l = rng.normal(size=(d, d))
    cov = l @ l.T + np.eye(d)
    return mean, cov


def test_logpdf_matches_scipy(rng):
    mean, cov = make_mvn(rng, 6)
    x = rng.normal(size=(11, 6))
    chol = safe_cholesky(jnp.asarray(cov))
    ours = np.asarray(mvn_logpdf(jnp.asarray(x), jnp.asarray(mean), chol))
    ref = stats.multivariate_normal(mean, cov).logpdf(x)
    np.testing.assert_allclose(ours, ref, rtol=1e-10)


def test_logpdf_batch_shapes(rng):
    mean, cov = make_mvn(rng, 4)
    chol = safe_cholesky(jnp.asarray(cov))
    x3 = rng.normal(size=(2, 5, 4))
    out = mvn_logpdf(jnp.asarray(x3), jnp.asarray(mean), chol)
    assert out.shape == (2, 5)
    single = mvn_logpdf(jnp.asarray(x3[0, 0]), jnp.asarray(mean), chol)
    np.testing.assert_allclose(single, out[0, 0], rtol=1e-12)


def test_sample_moments(rng):
    mean, cov = make_mvn(rng, 5)
    chol = safe_cholesky(jnp.asarray(cov))
    draws = np.asarray(
        mvn_sample(jax.random.PRNGKey(0), jnp.asarray(mean), chol, 400_000))
    np.testing.assert_allclose(draws.mean(0), mean, atol=2e-2 * np.abs(mean).max() + 2e-2)
    np.testing.assert_allclose(np.cov(draws.T), cov, atol=0.12 * np.abs(cov).max())


def test_kl_identities(rng):
    mean, cov = make_mvn(rng, 7)
    chol = safe_cholesky(jnp.asarray(cov))
    assert float(mvn_kl(mean, chol, mean, chol)) == pytest.approx(0.0, abs=1e-10)
    mean2, cov2 = make_mvn(rng, 7)
    chol2 = safe_cholesky(jnp.asarray(cov2))
    kl = float(mvn_kl(mean, chol, mean2, chol2))
    assert kl > 0
    # Cross-check against the trace/logdet formula computed naively.
    p1 = np.linalg.inv(cov2)
    ref = 0.5 * (np.trace(p1 @ cov) + (mean2 - mean) @ p1 @ (mean2 - mean)
                 - 7 + np.linalg.slogdet(cov2)[1] - np.linalg.slogdet(cov)[1])
    assert kl == pytest.approx(ref, rel=1e-8)


def test_entropy_matches_scipy(rng):
    mean, cov = make_mvn(rng, 5)
    chol = safe_cholesky(jnp.asarray(cov))
    ref = stats.multivariate_normal(mean, cov).entropy()
    assert float(mvn_entropy(chol)) == pytest.approx(ref, rel=1e-10)


def test_safe_cholesky_nan_on_indefinite():
    bad = jnp.asarray(np.diag([1.0, -1.0]))
    assert bool(jnp.any(jnp.isnan(safe_cholesky(bad))))


def test_gaussian_wrapper(rng):
    mean, cov = make_mvn(rng, 4)
    g = Gaussian(mean, cov)
    x = rng.normal(size=(3, 4))
    ref = stats.multivariate_normal(mean, cov).logpdf(x)
    np.testing.assert_allclose(np.asarray(g.log_prob(x)), ref, rtol=1e-9)
    s = g.sample(jax.random.PRNGKey(1), (10,))
    assert s.shape == (10, 4)
    assert g.sample(jax.random.PRNGKey(1)).shape == (4,)
