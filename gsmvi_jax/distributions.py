"""Native multivariate-normal primitives (no numpyro dependency).

The reference library leans on ``numpyro.distributions.MultivariateNormal`` for
q-density evaluation (reference ``gsmvi/monitors.py:107``, ``gsmvi/advi.py:38-44``)
and on host-side ``np.random.multivariate_normal`` for sampling (reference
``gsmvi/gsm.py:118-119``).  Here everything is a pure jittable function over a
*Cholesky factor* so that sampling, densities, and KL estimates stay on device
and fuse into the surrounding computation:

- ``mvn_sample``    — reparameterized draw ``x = mean + eps @ chol.T`` (one matmul;
  replaces the per-iteration host round-trip of the reference).
- ``mvn_logpdf``    — density via a triangular solve against the Cholesky factor.
- ``mvn_kl``        — analytic KL(N0 || N1) between two dense Gaussians (used by
  tests and the KL monitor's exact mode).

All functions accept a leading batch axis on ``x`` and are dtype-polymorphic.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

_LOG_2PI = math.log(2.0 * math.pi)


def safe_cholesky(cov, jitter: float = 0.0):
    """Cholesky factor of ``cov`` (+ optional ``jitter * I``).

    Returns NaNs (never raises) when ``cov`` is not positive definite, which is
    what the on-device goodness check keys off (cf. the reference's host-side
    try/except around ``np.linalg.cholesky``, ``gsmvi/gsm.py:136-150``).
    """
    d = cov.shape[-1]
    if jitter:
        cov = cov + jitter * jnp.eye(d, dtype=cov.dtype)
    return jnp.linalg.cholesky(cov)


def full_f32(fn):
    """Wrap ``fn`` so every matmul it traces runs in full float32.

    On NVIDIA GPUs an unpinned float32 product runs in TF32 (about three
    decimal digits), which corrupts ill-conditioned covariances, precision
    matrices and scores.  The fitters' compiled steps pin the precision
    themselves; this covers the helpers and targets called outside them."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)

    return wrapped


@full_f32
def mvn_sample(key, mean, chol, batch_size: int):
    """Draw ``batch_size`` samples from N(mean, chol @ chol.T) on device.

    Shape: (batch_size, D).  ``x = mean + eps @ chol.T`` with standard-normal
    ``eps`` — a single (B,D)x(D,D) matmul instead of the reference's host
    ``np.random.multivariate_normal`` (which re-factorizes the covariance via
    SVD on every call, ``gsmvi/gsm.py:119``).
    """
    d = mean.shape[-1]
    eps = jax.random.normal(key, (batch_size, d), dtype=mean.dtype)
    return mean + eps @ chol.T


@full_f32
def mvn_logpdf(x, mean, chol):
    """Log density of N(mean, chol @ chol.T) at ``x``; batched over leading axes.

    Uses ``solve_triangular`` so no explicit inverse/determinant of the dense
    covariance is ever formed.
    """
    d = mean.shape[-1]
    diff = x - mean
    # Solve L Y = diff^T => Y = L^{-1} diff^T; logpdf uses the column norms.
    # Leading batch axes are flattened so a single triangular solve covers
    # any batch shape.
    batch_shape = diff.shape[:-1]
    y = solve_triangular(chol, diff.reshape(-1, d).T, lower=True)
    maha = jnp.sum(y * y, axis=0).reshape(batch_shape)
    logdet = jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1)
    return -0.5 * (d * _LOG_2PI + maha) - logdet


def mvn_entropy(chol):
    """Differential entropy of N(·, chol @ chol.T)."""
    d = chol.shape[-1]
    logdet = jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1)
    return 0.5 * d * (1.0 + _LOG_2PI) + logdet


@full_f32
def mvn_kl(mean0, chol0, mean1, chol1):
    """Analytic KL( N(mean0, S0) || N(mean1, S1) ) from Cholesky factors.

    KL = 0.5 * ( tr(S1^-1 S0) + (m1-m0)^T S1^-1 (m1-m0) - D + logdet S1 - logdet S0 )
    computed entirely with triangular solves.
    """
    d = mean0.shape[-1]
    # M = L1^{-1} L0  =>  tr(S1^{-1} S0) = ||M||_F^2
    m = solve_triangular(chol1, chol0, lower=True)
    tr = jnp.sum(m * m)
    diff = mean1 - mean0
    y = solve_triangular(chol1, diff, lower=True)
    maha = jnp.sum(y * y)
    logdet0 = jnp.sum(jnp.log(jnp.diagonal(chol0)))
    logdet1 = jnp.sum(jnp.log(jnp.diagonal(chol1)))
    return 0.5 * (tr + maha - d) + logdet1 - logdet0


class Gaussian:
    """Lightweight dense-covariance Gaussian with a numpyro-like surface.

    Provides the ``.log_prob`` / ``.sample`` methods the reference examples get
    from ``numpyro.distributions.MultivariateNormal`` (e.g. reference
    ``examples/example_gsm.py:23,34``) without the numpyro dependency.
    """

    def __init__(self, loc, cov=None, scale_tril=None):
        self.loc = jnp.asarray(loc)
        if scale_tril is None:
            if cov is None:
                cov = jnp.eye(self.loc.shape[-1], dtype=self.loc.dtype)
            scale_tril = safe_cholesky(jnp.asarray(cov))
        self.scale_tril = jnp.asarray(scale_tril)

    @property
    @full_f32
    def covariance_matrix(self):
        return self.scale_tril @ self.scale_tril.T

    def log_prob(self, x):
        return mvn_logpdf(x, self.loc, self.scale_tril)

    def sample(self, key, sample_shape=()):
        n = int(math.prod(sample_shape)) if sample_shape else 1
        draws = mvn_sample(key, self.loc, self.scale_tril, n)
        if sample_shape:
            return draws.reshape(*sample_shape, self.loc.shape[-1])
        return draws[0]
