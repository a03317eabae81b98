"""Multivariate Student-t target (heavy tails — stresses score-based fits)."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..distributions import full_f32, safe_cholesky
from .base import Target, make_target


@full_f32
def student_t(key, d: int, df: float = 5.0, scale: float = 1.0) -> Target:
    """Multivariate t with ``df`` degrees of freedom and random scale matrix.

    Heavy-tailed benchmark: the optimal Gaussian q underestimates the tails,
    so GSM/BaM must settle at the KL-optimal Gaussian rather than an exact
    match.  Analytic moments: mean = loc; cov = df/(df-2) * Sigma (df > 2).
    """
    key_m, key_l = jax.random.split(key)
    loc = jax.random.normal(key_m, (d,))
    l = scale * jax.random.normal(key_l, (d, d)) / math.sqrt(d)
    sigma = l @ l.T + jnp.eye(d)
    chol = safe_cholesky(sigma)
    prec = jnp.linalg.inv(sigma)
    _, logdet = jnp.linalg.slogdet(sigma)
    const = (jax.scipy.special.gammaln((df + d) / 2.0)
             - jax.scipy.special.gammaln(df / 2.0)
             - 0.5 * d * math.log(df * math.pi) - 0.5 * logdet)

    @full_f32
    def log_prob(x):
        diff = x - loc
        maha = jnp.sum((diff @ prec) * diff, axis=-1)
        return const - 0.5 * (df + d) * jnp.log1p(maha / df)

    t = make_target(log_prob, d, name=f"student_t_d{d}_df{df:g}",
                    mean=loc, cov=df / (df - 2.0) * sigma if df > 2 else None)

    @full_f32
    def sample(key, n):
        kz, kg = jax.random.split(key)
        z = jax.random.normal(kz, (n, d)) @ chol.T
        g = jax.random.gamma(kg, df / 2.0, (n, 1)) * 2.0 / df
        return loc + z / jnp.sqrt(g)

    t.sample = sample
    return t
