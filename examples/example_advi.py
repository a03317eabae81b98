"""Fit a Gaussian target with ADVI / ELBO maximization.

Mirrors the reference examples/example_advi.py: D=4, adam(1e-2), batch 16 —
then polishes the fit with the STL (sticking-the-landing) gradient
estimator, which keeps contracting below the default estimator's Adam
variance floor (docs/DERIVATIONS.md section 7).

Run: python examples/example_advi.py
"""

import jax
import numpy as np
import optax

from gsmvi_jax import ADVI
from gsmvi_jax.models import dense_gaussian

if __name__ == "__main__":
    D = 4
    target = dense_gaussian(jax.random.PRNGKey(7), D)

    niter = 10_000
    key = jax.random.PRNGKey(99)
    opt = optax.adam(learning_rate=1e-2)
    advi = ADVI(D=D, lp=target.lp)
    mean_fit, cov_fit, losses = advi.fit(key, opt, batch_size=16, niter=niter)

    print("\nTrue mean : ", np.asarray(target.mean))
    print("Fit mean  : ", np.asarray(mean_fit))
    print("neg-ELBO  : ", losses[0], "->", losses[-1])

    # Two-phase accuracy recipe: warm-start an STL polish from the bulk fit.
    mean_stl, cov_stl, _ = advi.fit(
        jax.random.PRNGKey(100), optax.adam(2e-3), mean=mean_fit,
        cov=cov_fit, batch_size=16, niter=4000, estimator="stl",
        verbose=False)
    err = np.abs(np.asarray(cov_fit) - np.asarray(target.cov)).max()
    err_stl = np.abs(np.asarray(cov_stl) - np.asarray(target.cov)).max()
    print("max cov err: ", err, "-> (STL polish)", err_stl)
