"""Bayesian logistic-regression posterior target (non-analytic, real-world-shaped)."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..distributions import full_f32
from .base import Target, make_target


@full_f32
def logistic_regression(key, d: int, n_data: int = 200,
                        prior_scale: float = 2.0) -> Target:
    """Posterior over weights of a logistic regression on synthetic data.

    Data is generated from a ground-truth weight vector; the target is
    log p(w | X, y) up to a constant = log-likelihood + N(0, prior_scale^2 I)
    prior.  No analytic moments; use MCMC-free diagnostics (ELBO/KL monitors).
    """
    kw, kx, ky = jax.random.split(key, 3)
    w_true = jax.random.normal(kw, (d,))
    x = jax.random.normal(kx, (n_data, d)) / jnp.sqrt(d)
    logits = x @ w_true
    y = (jax.random.uniform(ky, (n_data,)) < jax.nn.sigmoid(logits)).astype(
        jnp.float32)

    @full_f32
    def log_prob(w):
        # w: (B, D) batch of weight vectors
        z = w @ x.T                                   # (B, N)
        loglik = jnp.sum(y * z - jax.nn.softplus(z), axis=-1)
        logprior = -0.5 * jnp.sum((w / prior_scale) ** 2, axis=-1)
        return loglik + logprior

    return make_target(log_prob, d, name=f"logreg_d{d}_n{n_data}")
