"""Neal's funnel target: x0 ~ N(0, sigma^2), x_i | x0 ~ N(0, exp(x0))."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .base import Target, make_target


def funnel(d: int, sigma: float = 3.0) -> Target:
    """Neal's funnel in ``d`` dims (one scale coordinate + d-1 latents).

    Non-Gaussian benchmark: the optimal Gaussian q is well defined but KL
    cannot reach zero, exercising BaM's regularized updates off the
    Gaussian-exact path.
    """

    def log_prob(x):
        x0 = x[..., 0]
        rest = x[..., 1:]
        lp0 = -0.5 * (x0 / sigma) ** 2 - 0.5 * jnp.log(2 * jnp.pi * sigma**2)
        var = jnp.exp(x0)
        lpr = -0.5 * jnp.sum(rest**2, -1) / var \
            - 0.5 * (d - 1) * (x0 + jnp.log(2 * jnp.pi))
        return lp0 + lpr

    t = make_target(log_prob, d, name=f"funnel_d{d}")

    def sample(key, n):
        k0, k1 = jax.random.split(key)
        x0 = sigma * jax.random.normal(k0, (n, 1))
        rest = jnp.exp(x0 / 2) * jax.random.normal(k1, (n, d - 1))
        return jnp.concatenate([x0, rest], -1)

    t.sample = sample
    return t
