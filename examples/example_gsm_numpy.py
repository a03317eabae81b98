"""Zero-dependency GSM fit in pure numpy (reference examples/example_gsm_numpy.py).

Uses only numpy: hand-written Gaussian log-prob/score and the vectorized
numpy GSM from ``gsmvi_jax.compat`` (int-seed API).

Run: python examples/example_gsm_numpy.py
"""

import numpy as np

from gsmvi_jax.compat.gsm_numpy import GSM


def setup_model(d=10, seed=42):
    rng = np.random.default_rng(seed)
    mean = rng.random(d)
    l = rng.normal(size=(d, d))
    cov = l @ l.T + 1e-3 * np.eye(d)
    prec = np.linalg.inv(cov)

    def log_prob(x):
        diff = np.atleast_2d(x) - mean
        return -0.5 * float(np.einsum("bi,ij,bj->", diff, prec, diff))

    def log_prob_grad(x):
        return -(np.atleast_2d(x) - mean) @ prec

    return mean, cov, log_prob, log_prob_grad


if __name__ == "__main__":
    D = 10
    mean, cov, lp, lp_g = setup_model(D)

    gsm = GSM(D=D, lp=lp, lp_g=lp_g)
    mean_fit, cov_fit = gsm.fit(key=99, niter=500)

    print("\nTrue mean : ", mean)
    print("Fit mean  : ", mean_fit)
    print("\nmax |mean error| :", float(np.abs(mean_fit - mean).max()))
