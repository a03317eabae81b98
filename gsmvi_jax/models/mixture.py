"""Gaussian-mixture target (multi-modal benchmark)."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..distributions import full_f32, mvn_logpdf
from .base import Target, make_target


@full_f32
def gaussian_mixture(key, d: int, n_components: int = 3,
                     separation: float = 3.0) -> Target:
    """Equal-weight mixture of ``n_components`` spherical Gaussians.

    Component means are drawn at ``separation`` scale; log-prob is a stable
    logsumexp over component densities.
    """
    means = separation * jax.random.normal(key, (n_components, d))
    chol = jnp.eye(d)

    def log_prob(x):
        # (B, K) component log-densities
        comp = jax.vmap(lambda m: mvn_logpdf(x, m, chol))(means)  # (K, B)
        return jax.scipy.special.logsumexp(comp, axis=0) - jnp.log(n_components)

    # Analytic moments of an equal-weight mixture with identity components.
    mix_mean = jnp.mean(means, axis=0)
    dev = means - mix_mean
    mix_cov = jnp.eye(d) + dev.T @ dev / n_components

    t = make_target(log_prob, d, name=f"gmm_d{d}_k{n_components}",
                    mean=mix_mean, cov=mix_cov)

    def sample(key, n):
        kc, kz = jax.random.split(key)
        idx = jax.random.randint(kc, (n,), 0, n_components)
        z = jax.random.normal(kz, (n, d))
        return means[idx] + z

    t.sample = sample
    return t
