"""LBFGS / MAP initializers (reference gsmvi/initializers.py parity)."""

import jax
import numpy as np
import pytest

from gsmvi_jax import GSM, KLMonitor, lbfgs_init, map_init
from gsmvi_jax.models import dense_gaussian


@pytest.fixture(scope="module")
def target():
    return dense_gaussian(jax.random.PRNGKey(13), 6)


def test_lbfgs_finds_map(target):
    t = target
    mu, cov, res = lbfgs_init(np.ones(t.d), t.lp, t.lp_g)
    np.testing.assert_allclose(mu, np.asarray(t.mean), atol=1e-3)
    assert cov.shape == (t.d, t.d)
    assert np.all(np.linalg.eigvalsh(cov) > 0)
    assert res.nfev > 0


def test_lbfgs_without_grad(target):
    t = target
    mu, _, _ = lbfgs_init(np.zeros(t.d), t.lp, lp_g=None, maxiter=2000)
    np.testing.assert_allclose(mu, np.asarray(t.mean), atol=1e-3)


def test_lbfgs_chains_into_gsm(target):
    """The init -> monitor-offset -> fit chain of
    examples/example_initializers.py:80-86."""
    t = target
    mu0, cov0, res = lbfgs_init(np.ones(t.d), t.lp, t.lp_g)
    mon = KLMonitor(batch_size_kl=32, checkpoint=50, offset_evals=res.nfev)
    gsm = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    mean, cov = gsm.fit(jax.random.PRNGKey(99), mean=mu0, cov=cov0, niter=200,
                        batch_size=4, verbose=False, monitor=mon)
    assert mon.nevals[0] == res.nfev + 1
    np.testing.assert_allclose(mean, t.mean, atol=1e-2)


def test_map_init_on_device(target):
    t = target
    mu, cov, nevals = map_init(jax.random.PRNGKey(0), t.lp, t.d, lr=0.05,
                               niter=2000)
    np.testing.assert_allclose(mu, np.asarray(t.mean), atol=0.05)
    assert nevals == 2000
