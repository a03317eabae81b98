"""Failure-path robustness: pathological targets must not crash or corrupt
state — bad updates revert (reference behavior: host check + revert,
``gsmvi/gsm.py:125-129``; BaM retries, ``gsmvi/bam.py:188-206``)."""

import jax
import jax.numpy as jnp
import numpy as np

from gsmvi_jax import BaM, FactorGSM, GSM, Regularizers
from gsmvi_jax.models import dense_gaussian


def _explosive_lp_g(scale):
    """Score that pushes covariance indefinite (huge outward gradients)."""

    def lp_g(x):
        return scale * x

    return lp_g


def test_gsm_survives_explosive_scores():
    """Scores of a non-normalizable 'density' exp(+scale*x^2/2): the GSM
    update's rho-damping keeps proposals PD, and whatever happens the state
    must stay finite and PD (accepted or reverted)."""
    gsm = GSM(D=6, lp=None, lp_g=_explosive_lp_g(50.0))
    state = gsm.fit(jax.random.PRNGKey(0), niter=50, batch_size=4,
                    verbose=False, return_state=True)
    assert np.isfinite(np.asarray(state.cov)).all()
    assert np.all(np.linalg.eigvalsh(np.asarray(state.cov)) > 0)


def test_gsm_survives_nan_scores():
    def lp_g(x):
        return x * jnp.nan

    gsm = GSM(D=4, lp=None, lp_g=lp_g)
    mean, cov = gsm.fit(jax.random.PRNGKey(0), niter=20, batch_size=4,
                        verbose=False)
    np.testing.assert_array_equal(np.asarray(mean), np.zeros(4))
    np.testing.assert_array_equal(np.asarray(cov), np.eye(4))


def test_factor_gsm_survives_nan_scores():
    def lp_g(x):
        return x * jnp.nan

    fg = FactorGSM(D=4, lp=None, lp_g=lp_g, refresh_every=0)
    state = fg.fit(jax.random.PRNGKey(0), niter=20, batch_size=4,
                   verbose=False, return_state=True)
    assert int(state.n_rejected) == 21
    np.testing.assert_array_equal(np.asarray(state.factor), np.eye(4))


def test_bam_retries_then_reverts_on_nan():
    def lp_g(x):
        return x * jnp.nan

    bam = BaM(D=4, lp=None, lp_g=lp_g)
    state = bam.fit(jax.random.PRNGKey(0), regf=Regularizers().constant(1.0),
                    niter=5, batch_size=4, verbose=False, retries=2,
                    return_state=True)
    assert int(state.n_rejected) == 6
    np.testing.assert_array_equal(np.asarray(state.cov), np.eye(4))


def test_gsm_recovers_after_transient_bad_scores():
    """A target whose score is broken only far from the mode: fit still
    converges once the iterate enters the good region."""
    t = dense_gaussian(jax.random.PRNGKey(3), 5)

    def lp_g(x):
        good = t.lp_g(x)
        # corrupt scores at points far outside the target's support
        bad = jnp.linalg.norm(x, axis=-1, keepdims=True) > 1e3
        return jnp.where(bad, jnp.nan, good)

    gsm = GSM(D=5, lp=t.lp, lp_g=lp_g)
    mean, cov = gsm.fit(jax.random.PRNGKey(0), niter=400, batch_size=8,
                        verbose=False)
    np.testing.assert_allclose(mean, t.mean, atol=5e-3)


def test_huge_initial_covariance():
    t = dense_gaussian(jax.random.PRNGKey(3), 5)
    gsm = GSM(D=5, lp=t.lp, lp_g=t.lp_g)
    mean, cov = gsm.fit(jax.random.PRNGKey(0), cov=1e6 * np.eye(5),
                        niter=800, batch_size=16, verbose=False)
    np.testing.assert_allclose(mean, t.mean, atol=0.05)


def test_tiny_initial_covariance():
    t = dense_gaussian(jax.random.PRNGKey(3), 5)
    gsm = GSM(D=5, lp=t.lp, lp_g=t.lp_g)
    mean, cov = gsm.fit(jax.random.PRNGKey(0), cov=1e-6 * np.eye(5),
                        niter=800, batch_size=16, verbose=False)
    np.testing.assert_allclose(mean, t.mean, atol=0.05)
