"""Zero-dependency numpy GSM: the reference's vanilla path, vectorized.

Surface parity with reference ``gsmvi/gsm_numpy.py``: ``GSM(D, lp, lp_g)``,
``fit(key=<int seed>, ...)`` (the key is a plain integer here, unlike the jax
fitters — matching ``gsmvi/gsm_numpy.py:82,105``), numpy arrays in and out,
nothing imported beyond numpy.

The math is the same Gram-matrix batch formulation as ops/gsm.py (the
reference's numpy twin instead loops Python-level over the batch building
(B, D, D) outer-product stacks, ``gsmvi/gsm_numpy.py:44-55``) — so this twin
doubles as an independent-of-jax oracle for the on-device update.
"""

from __future__ import annotations

import numpy as np


def gsm_update(samples, vs, mu0, S0):
    """Batched GSM update, pure numpy; same contract as ops/gsm.py.

    samples, vs: (B, D); mu0: (D,); S0: (D, D).  Returns (mu, S).
    """
    samples = np.asarray(samples)
    vs = np.asarray(vs)
    if samples.ndim != 2 or vs.ndim != 2:
        raise ValueError("samples and vs must be (batch, dim) arrays")
    b = samples.shape[0]
    a = mu0 - samples
    t = vs @ S0
    vsv = np.einsum("bi,bi->b", vs, t)
    mv = np.einsum("bi,bi->b", a, vs)
    rho = 0.5 * (np.sqrt(1.0 + 4.0 * (vsv + mv * mv)) - 1.0)
    eps0 = t - a
    w = np.einsum("bi,bi->b", vs, eps0)
    dmu_b = (eps0 - a * (w / (1.0 + rho + mv))[:, None]) / (1.0 + rho)[:, None]
    bm = a + dmu_b
    ds = (a.T @ a - bm.T @ bm) / b
    ds = 0.5 * (ds + ds.T)
    return mu0 + dmu_b.mean(axis=0), S0 + ds


class GSM:
    """Numpy GSM fitter; drop-in for reference ``gsmvi/gsm_numpy.py:60-146``."""

    def __init__(self, D, lp, lp_g):
        self.D = D
        self.lp = lp
        self.lp_g = lp_g

    def fit(self, key, mean=None, cov=None, batch_size=2, niter=5000,
            nprint=10, verbose=True, check_goodness=True, monitor=None):
        """``key`` is an integer RNG seed (parity: ``gsmvi/gsm_numpy.py:82``).

        Returns (mean, cov) as numpy arrays.
        """
        rng = np.random.default_rng(int(key))
        mean = np.zeros(self.D) if mean is None else np.array(mean, float)
        cov = np.identity(self.D) if cov is None else np.array(cov, float)
        chol = np.linalg.cholesky(cov)

        print_every = max(1, niter // min(nprint, max(niter, 1))) if nprint else 0
        nevals = 1
        for i in range(niter + 1):
            if verbose and print_every and i % print_every == 0:
                print(f"Iteration {i} of {niter}")
            checkpoint = getattr(monitor, "checkpoint", None) \
                if monitor is not None else None
            if checkpoint and i % checkpoint == 0:
                monitor(i, [mean, cov], self.lp, i, nevals=nevals)
                nevals = 0
            # Sample from the maintained Cholesky factor (one gemm; the
            # reference re-factorizes inside np.random.multivariate_normal
            # every iteration, gsmvi/gsm_numpy.py:116).
            eps = rng.standard_normal((batch_size, self.D))
            samples = mean + eps @ chol.T
            vs = np.asarray(self.lp_g(samples))
            mean_new, cov_new = gsm_update(samples, vs, mean, cov)
            nevals += batch_size
            try:
                chol_new = np.linalg.cholesky(cov_new)
                good = np.isfinite(chol_new).all()
            except np.linalg.LinAlgError:
                good = False
            if good:
                mean, cov, chol = mean_new, cov_new, chol_new
            elif verbose:
                print("Bad update for covariance matrix. Revert")
        if monitor is not None:
            monitor(niter, [mean, cov], self.lp, niter, nevals=nevals)
        return mean, cov
