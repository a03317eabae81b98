"""Gaussian targets — the reference examples' model family, plus hard variants.

``dense_gaussian`` reproduces the construction used by every reference example
(``examples/example_gsm.py:17-24``): random mean, covariance ``L L^T + 1e-3 I``
with normal ``L``.  ``ill_conditioned_gaussian`` is the BASELINE "D>=512
ill-conditioned target" — log-spaced spectrum with a random rotation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..distributions import full_f32, mvn_logpdf, mvn_sample, safe_cholesky
from .base import Target, make_target


def _gaussian_target(mean, cov, name: str) -> Target:
    """Gaussian target with *analytic* matmul-form density and score.

    The generic route (autodiff through the triangular-solve logpdf) runs a
    panel-sequential triangular solve per evaluation; precomputing the
    precision matrix (in f64 on host, cast once) turns both lp and the score
    into single matmuls:

        lp(x)  = -0.5 (x-m)^T P (x-m) + 0.5 logdet P - D/2 log 2pi
        score  = (m - x) @ P
    """
    import math

    import numpy as np

    mean = jnp.asarray(mean)
    cov = jnp.asarray(cov)
    d = mean.shape[-1]
    chol = safe_cholesky(cov)
    prec64 = np.linalg.inv(np.asarray(cov, np.float64))
    logdet_p = float(np.linalg.slogdet(prec64)[1])
    prec = jnp.asarray(prec64, mean.dtype)
    const = 0.5 * logdet_p - 0.5 * d * math.log(2.0 * math.pi)

    @full_f32
    def log_prob(x):
        diff = x - mean
        maha = jnp.sum((diff @ prec) * diff, axis=-1)
        return -0.5 * maha + const

    lp = jax.jit(lambda x: jnp.sum(log_prob(x)))
    lp_g = jax.jit(full_f32(lambda x: (mean - x) @ prec))
    t = Target(d=d, lp=lp, lp_g=lp_g, name=name, mean=mean, cov=cov)
    t.sample = lambda key, n: mvn_sample(key, mean, chol, n)
    return t


@full_f32
def dense_gaussian(key, d: int, scale: float = 1.0) -> Target:
    """Random dense-covariance MVN (reference ``setup_model``,
    ``examples/example_gsm.py:17-24``)."""
    key_m, key_l = jax.random.split(key)
    mean = jax.random.uniform(key_m, (d,))
    l = scale * jax.random.normal(key_l, (d, d))
    cov = l @ l.T + 1e-3 * jnp.eye(d)
    return _gaussian_target(mean, cov, f"dense_gaussian_d{d}")


@full_f32
def ill_conditioned_gaussian(key, d: int, condition: float = 1e4) -> Target:
    """MVN with log-spaced eigenvalues spanning ``condition`` and a random
    rotation (BASELINE.json config 5)."""
    key_m, key_q = jax.random.split(key)
    mean = jax.random.normal(key_m, (d,))
    evals = jnp.logspace(0.0, jnp.log10(condition), d)
    q, _ = jnp.linalg.qr(jax.random.normal(key_q, (d, d)))
    cov = (q * evals) @ q.T
    cov = 0.5 * (cov + cov.T)
    return _gaussian_target(mean, cov, f"ill_gaussian_d{d}_k{condition:g}")
