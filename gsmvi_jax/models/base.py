"""Target container: the user-supplied adapter layer, made first-class.

The reference's contract is two callables — ``lp(x) -> scalar`` (summed over
the batch) and ``lp_g(x) -> (B, D)`` — hand-assembled in every example
(``examples/example_gsm.py:34-35``).  ``Target`` packages that contract with
the metadata tests and benchmarks need (dimension, true moments when known,
reference-sample draws).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..distributions import full_f32


@dataclass
class Target:
    """A VI target: jitted log-prob (batch-summed) and score callables."""

    d: int
    lp: Callable            # (B, D) -> scalar (sum over batch; reference convention)
    lp_g: Callable           # (B, D) -> (B, D)
    name: str = "target"
    mean: Optional[jax.Array] = None      # true mean, if analytic
    cov: Optional[jax.Array] = None       # true covariance, if analytic
    sample: Optional[Callable] = None     # (key, n) -> (n, D) exact sampler

    def ref_samples(self, key, n: int):
        if self.sample is None:
            raise ValueError(f"target {self.name!r} has no exact sampler")
        return self.sample(key, n)


def make_target(log_prob: Callable, d: int, name: str = "target",
                **kwargs) -> Target:
    """Build a Target from a per-sample ``log_prob((B, D)) -> (B,)`` callable.

    Applies the reference's batch-sum convention and autodiff score
    (``examples/example_gsm.py:34-35``): ``lp = jit(sum . log_prob)``,
    ``lp_g = jit(grad(lp))``.
    """
    lp = jax.jit(full_f32(lambda x: jnp.sum(log_prob(x))))
    lp_g = jax.jit(jax.grad(lp))
    return Target(d=d, lp=lp, lp_g=lp_g, name=name, **kwargs)
