"""Property tests (SURVEY.md §4c): invariants of the update kernels, plus
statistical fixed points at the true target."""

import jax
import jax.numpy as jnp
import numpy as np

from gsmvi_jax.config import FitConfig, enable_x64
from gsmvi_jax.ops.bam import bam_update
from gsmvi_jax.ops.gsm import gsm_update


def test_gsm_covariance_stays_spd_along_fit():
    """Accepted covariances are SPD at every step (accept_or_revert invariant)."""
    from gsmvi_jax import GSM
    from gsmvi_jax.models import dense_gaussian

    t = dense_gaussian(jax.random.PRNGKey(17), 8)
    gsm = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    state = gsm.fit(jax.random.PRNGKey(0), niter=200, batch_size=4,
                    verbose=False, return_state=True)
    evals = np.linalg.eigvalsh(np.asarray(state.cov))
    assert (evals > 0).all()
    assert float(jnp.max(jnp.abs(state.cov - state.cov.T))) == 0.0


def test_bam_statistical_fixed_point(rng):
    """At q == p with exact scores, the expected BaM update is the identity:
    with a large batch the update must stay near (mu*, Sigma*)."""
    d = 6
    mu = rng.normal(size=d)
    l = rng.normal(size=(d, d))
    cov = l @ l.T + np.eye(d)
    prec = np.linalg.inv(cov)
    b = 100_000
    x = rng.multivariate_normal(mu, cov, size=b)
    v = -(x - mu) @ prec
    mu_new, s_new = bam_update(x, v, mu, cov, reg=10.0)
    np.testing.assert_allclose(mu_new, mu, atol=5e-2)
    np.testing.assert_allclose(s_new, cov, atol=0.1 * np.abs(cov).max())


def test_gsm_scale_equivariance(rng):
    """GSM update is equivariant under coordinate scaling x -> c x
    (scores scale as 1/c, covariance as c^2)."""
    d, b, c = 5, 4, 3.7
    mu0 = rng.normal(size=d)
    l = rng.normal(size=(d, d))
    s0 = l @ l.T + np.eye(d)
    x = rng.normal(size=(b, d))
    v = rng.normal(size=(b, d))
    mu1, s1 = gsm_update(x, v, mu0, s0)
    mu2, s2 = gsm_update(c * x, v / c, c * mu0, c * c * s0)
    np.testing.assert_allclose(np.asarray(mu2), c * np.asarray(mu1), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(s2), c * c * np.asarray(s1), rtol=1e-9)


def test_gsm_rotation_equivariance(rng):
    """GSM update is equivariant under orthogonal maps x -> Q x."""
    d, b = 5, 4
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    mu0 = rng.normal(size=d)
    l = rng.normal(size=(d, d))
    s0 = l @ l.T + np.eye(d)
    x = rng.normal(size=(b, d))
    v = rng.normal(size=(b, d))
    mu1, s1 = gsm_update(x, v, mu0, s0)
    mu2, s2 = gsm_update(x @ q.T, v @ q.T, q @ mu0, q @ s0 @ q.T)
    np.testing.assert_allclose(np.asarray(mu2), q @ np.asarray(mu1), atol=1e-9)
    np.testing.assert_allclose(np.asarray(s2), q @ np.asarray(s1) @ q.T,
                               atol=1e-9)


def test_fit_config_kwargs():
    cfg = FitConfig(batch_size=8, niter=100)
    kw = cfg.fit_kwargs()
    assert kw == {"batch_size": 8, "niter": 100, "nprint": 10, "verbose": True}


def test_enable_x64_toggle():
    enable_x64(True)
    assert jnp.zeros(1).dtype == jnp.float64
    enable_x64(False)
    assert jnp.zeros(1).dtype == jnp.float32
    enable_x64(True)  # restore conftest default
