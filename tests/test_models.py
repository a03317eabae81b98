"""Target-model zoo: score consistency (autodiff vs finite differences),
sampler moments, and fitter convergence on non-Gaussian targets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsmvi_jax import GSM
from gsmvi_jax.models import (banana, dense_gaussian, funnel,
                              gaussian_mixture, ill_conditioned_gaussian,
                              logistic_regression, make_target)

TARGETS = {
    "dense": lambda: dense_gaussian(jax.random.PRNGKey(0), 6),
    "ill": lambda: ill_conditioned_gaussian(jax.random.PRNGKey(0), 6, 1e3),
    "funnel": lambda: funnel(5),
    "banana": lambda: banana(5),
    "gmm": lambda: gaussian_mixture(jax.random.PRNGKey(0), 4, 3),
    "logreg": lambda: logistic_regression(jax.random.PRNGKey(0), 5),
}


@pytest.mark.parametrize("name", sorted(TARGETS))
def test_score_matches_finite_difference(name, rng):
    t = TARGETS[name]()
    x = jnp.asarray(rng.normal(size=(3, t.d)) * 0.5)
    g = np.asarray(t.lp_g(x))
    eps = 1e-6
    for b in range(3):
        for j in range(t.d):
            xp = x.at[b, j].add(eps)
            xm = x.at[b, j].add(-eps)
            fd = (float(t.lp(xp)) - float(t.lp(xm))) / (2 * eps)
            assert g[b, j] == pytest.approx(fd, rel=1e-4, abs=1e-4)


@pytest.mark.parametrize("name", ["dense", "ill", "funnel", "banana", "gmm"])
def test_sampler_mean(name):
    t = TARGETS[name]()
    draws = np.asarray(t.ref_samples(jax.random.PRNGKey(1), 200_000))
    if t.mean is not None:
        scale = np.abs(np.asarray(t.mean)).max() + 1.0
        np.testing.assert_allclose(draws.mean(0), t.mean, atol=0.05 * scale)
    else:
        assert np.isfinite(draws).all()


def test_gmm_analytic_cov():
    t = TARGETS["gmm"]()
    draws = np.asarray(t.ref_samples(jax.random.PRNGKey(2), 400_000))
    np.testing.assert_allclose(np.cov(draws.T), t.cov,
                               atol=0.05 * np.abs(np.asarray(t.cov)).max())


def test_ill_conditioned_recovery():
    """BASELINE config 5 (scaled down for CI): GSM on an ill-conditioned
    Gaussian recovers moments."""
    t = ill_conditioned_gaussian(jax.random.PRNGKey(4), 16, 1e3)
    gsm = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    mean, cov = gsm.fit(jax.random.PRNGKey(99), niter=2000, batch_size=32,
                        verbose=False)
    np.testing.assert_allclose(mean, t.mean, atol=0.05)
    rel = np.abs(np.asarray(cov - t.cov)).max() / np.abs(np.asarray(t.cov)).max()
    assert rel < 0.05


def test_funnel_fit_stays_finite():
    """Non-Gaussian target: KL can't reach 0, but the fit must stay valid."""
    t = funnel(5)
    gsm = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    state = gsm.fit(jax.random.PRNGKey(0), niter=500, batch_size=32,
                    verbose=False, return_state=True)
    assert np.isfinite(np.asarray(state.cov)).all()
    assert np.all(np.linalg.eigvalsh(np.asarray(state.cov)) > 0)


def test_make_target_convention(rng):
    """lp is batch-summed; lp_g is the per-sample score (reference convention
    examples/example_gsm.py:34-35)."""
    t = make_target(lambda x: -0.5 * jnp.sum(x**2, -1), 3)
    x = jnp.asarray(rng.normal(size=(4, 3)))
    assert np.asarray(t.lp(x)).shape == ()
    np.testing.assert_allclose(t.lp_g(x), -x, atol=1e-12)


def test_student_t_target():
    from gsmvi_jax.models import student_t

    t = student_t(jax.random.PRNGKey(0), 5, df=6.0)
    # score vs finite differences
    x = jnp.asarray(np.random.default_rng(1).normal(size=(2, 5)))
    g = np.asarray(t.lp_g(x))
    eps = 1e-6
    fd = (float(t.lp(x.at[0, 2].add(eps))) - float(t.lp(x.at[0, 2].add(-eps)))) / (2 * eps)
    assert g[0, 2] == pytest.approx(fd, rel=1e-4, abs=1e-4)
    # sampler moments match analytic mean/cov
    draws = np.asarray(t.ref_samples(jax.random.PRNGKey(2), 400_000))
    np.testing.assert_allclose(draws.mean(0), t.mean, atol=0.05)
    np.testing.assert_allclose(np.cov(draws.T), t.cov,
                               atol=0.1 * np.abs(np.asarray(t.cov)).max())


def test_gsm_on_student_t_stays_valid():
    from gsmvi_jax import GSM
    from gsmvi_jax.models import student_t

    t = student_t(jax.random.PRNGKey(0), 5, df=6.0)
    gsm = GSM(D=5, lp=t.lp, lp_g=t.lp_g)
    state = gsm.fit(jax.random.PRNGKey(1), niter=800, batch_size=32,
                    verbose=False, return_state=True)
    assert np.all(np.linalg.eigvalsh(np.asarray(state.cov)) > 0)
    np.testing.assert_allclose(np.asarray(state.mean), t.mean, atol=0.2)
