"""Fit a Gaussian target with Batch-and-Match, low-rank updates.

Mirrors the reference examples/example_bam.py config: D=5, 100 iterations,
batch 2, custom regularizer 100/(1+i), validated with np.allclose — but runs
fully on device on any backend (the reference needs a host sqrtm).

Run: python examples/example_bam.py
"""

import jax
import numpy as np

from gsmvi_jax import BaM, Regularizers
from gsmvi_jax.models import dense_gaussian

if __name__ == "__main__":
    D = 5
    target = dense_gaussian(jax.random.PRNGKey(5), D)
    mean, cov = np.asarray(target.mean), np.asarray(target.cov)

    niter = 100
    batch_size = 2
    regularizer = Regularizers()
    # Other schedules: regularizer.constant(100), regularizer.linear(100)
    regf = regularizer.custom(lambda i: 100 / (1 + i))

    bam = BaM(D=D, lp=target.lp, lp_g=target.lp_g, use_lowrank=True)
    key = jax.random.PRNGKey(99)
    mean_fit, cov_fit = bam.fit(key, regf=regf, niter=niter,
                                batch_size=batch_size)

    print()
    print("True mean : ", mean)
    print("Fit mean  : ", np.asarray(mean_fit))
    print()
    print("Check mean fit:", np.allclose(mean, mean_fit, atol=1e-3))
    print("Check cov fit :", np.allclose(cov, cov_fit, atol=1e-2))
