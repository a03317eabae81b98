"""Zero-dependency numpy GSM path: kernel equivalence with the jax kernel and
end-to-end recovery with an int seed (reference gsmvi/gsm_numpy.py parity)."""

import numpy as np

from gsmvi_jax.compat.gsm_numpy import GSM as NumpyGSM
from gsmvi_jax.compat.gsm_numpy import gsm_update as gsm_update_np
from gsmvi_jax.ops.gsm import gsm_update as gsm_update_jax


def test_numpy_kernel_equals_jax_kernel(rng):
    """The two implementations pin each other down (SURVEY.md §4b)."""
    d, b = 9, 4
    mu0 = rng.normal(size=d)
    l = rng.normal(size=(d, d))
    s0 = l @ l.T + np.eye(d)
    x = rng.normal(size=(b, d))
    v = rng.normal(size=(b, d))
    mu_np, s_np = gsm_update_np(x, v, mu0, s0)
    mu_jx, s_jx = gsm_update_jax(x, v, mu0, s0)
    np.testing.assert_allclose(mu_np, mu_jx, atol=1e-12)
    np.testing.assert_allclose(s_np, s_jx, atol=1e-12)


def test_numpy_fit_recovers_mvn():
    """Reference numpy config: D=5-10 MVN, 500 iters, int seed
    (examples/example_gsm_numpy.py:38-46)."""
    rng = np.random.default_rng(42)
    d = 5
    mean = rng.random(d)
    l = rng.normal(size=(d, d))
    cov = l @ l.T + 1e-3 * np.eye(d)
    prec = np.linalg.inv(cov)

    def lp(x):
        diff = np.atleast_2d(x) - mean
        return -0.5 * np.einsum("bi,ij,bj->b", diff, prec, diff).sum()

    def lp_g(x):
        return -(np.atleast_2d(x) - mean) @ prec

    gsm = NumpyGSM(D=d, lp=lp, lp_g=lp_g)
    mean_fit, cov_fit = gsm.fit(key=99, niter=500, batch_size=8, verbose=False)
    np.testing.assert_allclose(mean_fit, mean, atol=1e-2)
    np.testing.assert_allclose(cov_fit, cov, atol=0.2)
