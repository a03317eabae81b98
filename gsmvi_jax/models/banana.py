"""Rosenbrock/banana-warped Gaussian target."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .base import Target, make_target


def banana(d: int, curvature: float = 0.5, scale: float = 2.0) -> Target:
    """Banana target: standard normal warped by x1 -> x1 + b*(x0^2 - s^2).

    The warp is volume-preserving, so the density is a pushforward of
    N(0, diag(s^2, 1, ..., 1)) with an exact log-prob and sampler.
    """

    def unwarp(x):
        x0 = x[..., 0]
        x1 = x[..., 1] - curvature * (x0**2 - scale**2)
        return jnp.stack([x0, x1], -1), x[..., 2:]

    def log_prob(x):
        head, tail = unwarp(x)
        lp_head = -0.5 * (head[..., 0] / scale) ** 2 \
            - 0.5 * jnp.log(2 * jnp.pi * scale**2) \
            - 0.5 * head[..., 1] ** 2 - 0.5 * jnp.log(2 * jnp.pi)
        lp_tail = -0.5 * jnp.sum(tail**2, -1) \
            - 0.5 * (d - 2) * jnp.log(2 * jnp.pi)
        return lp_head + lp_tail

    t = make_target(log_prob, d, name=f"banana_d{d}")

    def sample(key, n):
        z = jax.random.normal(key, (n, d))
        x0 = scale * z[:, 0]
        x1 = z[:, 1] + curvature * (x0**2 - scale**2)
        return jnp.concatenate([x0[:, None], x1[:, None], z[:, 2:]], -1)

    t.sample = sample
    return t
