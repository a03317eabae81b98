"""Posterior serving wrapper."""

import jax
import numpy as np
import pytest

from gsmvi_jax import GSM, FactorGSM, Posterior
from gsmvi_jax.models import dense_gaussian
from scipy import stats


def test_from_fit_sample_and_logprob(rng):
    mean = rng.normal(size=5)
    l = rng.normal(size=(5, 5))
    cov = l @ l.T + np.eye(5)
    post = Posterior.from_fit(mean, cov)
    xs = np.asarray(post.sample(jax.random.PRNGKey(0), 200_000))
    np.testing.assert_allclose(xs.mean(0), mean, atol=0.05)
    ref = stats.multivariate_normal(mean, cov)
    np.testing.assert_allclose(np.asarray(post.log_prob(xs[:10])),
                               ref.logpdf(xs[:10]), rtol=1e-6)
    assert float(post.entropy()) == pytest.approx(ref.entropy(), rel=1e-6)


def test_from_state_both_kinds():
    t = dense_gaussian(jax.random.PRNGKey(1), 4)
    s1 = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g).fit(
        jax.random.PRNGKey(0), niter=50, batch_size=8, verbose=False,
        return_state=True)
    s2 = FactorGSM(D=t.d, lp=t.lp, lp_g=t.lp_g).fit(
        jax.random.PRNGKey(0), niter=50, batch_size=8, verbose=False,
        return_state=True)
    p1, p2 = Posterior.from_state(s1), Posterior.from_state(s2)
    assert float(p1.kl_to(p2)) < 0.5
    m, sd = p1.marginal([0, 2])
    assert m.shape == (2,) and sd.shape == (2,)


def test_marginal_matches_cov_diag(rng):
    mean = rng.normal(size=4)
    l = rng.normal(size=(4, 4))
    cov = l @ l.T + np.eye(4)
    post = Posterior.from_fit(mean, cov)
    _, sd = post.marginal()
    np.testing.assert_allclose(np.asarray(sd) ** 2, np.diag(cov), rtol=1e-8)


def test_posterior_save_load_roundtrip(tmp_path):
    import jax

    from gsmvi_jax import Posterior
    from gsmvi_jax.models import dense_gaussian

    t = dense_gaussian(jax.random.PRNGKey(0), 6)
    post = Posterior.from_fit(t.mean, t.cov)
    p = str(tmp_path / "post.npz")
    post.save(p)
    back = Posterior.load(p)
    np.testing.assert_allclose(np.asarray(back.mean), np.asarray(post.mean))
    np.testing.assert_allclose(np.asarray(back.chol), np.asarray(post.chol))
    x = back.sample(jax.random.PRNGKey(1), 8)
    np.testing.assert_allclose(np.asarray(back.log_prob(x)),
                               np.asarray(post.log_prob(x)), rtol=1e-6)
