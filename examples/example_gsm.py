"""Fit a dense-covariance Gaussian target with GSM.

Mirrors the reference example (examples/example_gsm.py in modichirag/GSM-VI):
build a random MVN target, fit 500 iterations, compare means.  No numpyro
needed — the target zoo provides the model; to use numpyro instead, see
``gsmvi_jax.models.numpyro_compat``.

Run: python examples/example_gsm.py
"""

import jax
import numpy as np

from gsmvi_jax import GSM
from gsmvi_jax.models import dense_gaussian

if __name__ == "__main__":
    D = 10
    target = dense_gaussian(jax.random.PRNGKey(3), D)

    niter = 500
    key = jax.random.PRNGKey(99)
    gsm = GSM(D=D, lp=target.lp, lp_g=target.lp_g)
    mean_fit, cov_fit = gsm.fit(key, niter=niter)

    print("\nTrue mean : ", np.asarray(target.mean))
    print("Fit mean  : ", np.asarray(mean_fit))
    print("\nmax |mean error| :", float(np.abs(mean_fit - target.mean).max()))
    print("max |cov  error| :", float(np.abs(cov_fit - target.cov).max()))
