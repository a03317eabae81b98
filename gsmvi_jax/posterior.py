"""Posterior: the serving-side wrapper around a finished fit.

The reference returns a bare ``(mean, cov)`` tuple and leaves sampling /
density evaluation to the user (via numpyro).  ``Posterior`` packages the
fitted Gaussian with jitted, batched primitives so downstream systems can
draw samples and score points at device speed:

    post = Posterior.from_fit(mean, cov)
    xs   = post.sample(key, 4096)          # (4096, D), one fused matmul
    lps  = post.log_prob(xs)               # (4096,)
    m, s = post.marginal(idx)              # marginal mean/std of coordinates

Also the bridge to checkpoints: ``Posterior.from_state`` accepts a ``VIState``
or ``FactorVIState``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .distributions import (full_f32, mvn_entropy, mvn_kl, mvn_logpdf,
                            mvn_sample, safe_cholesky)


class Posterior:
    """Immutable fitted Gaussian with jitted sample/log_prob."""

    def __init__(self, mean, chol):
        self.mean = jnp.asarray(mean)
        self.chol = jnp.asarray(chol)
        self._logpdf = jax.jit(lambda x: mvn_logpdf(x, self.mean, self.chol))

    @classmethod
    def from_fit(cls, mean, cov):
        return cls(mean, safe_cholesky(jnp.asarray(cov)))

    @classmethod
    def from_state(cls, state):
        """Accepts VIState (has .chol) or FactorVIState (has .factor)."""
        if hasattr(state, "chol"):
            return cls(state.mean, state.chol)
        return cls.from_fit(state.mean, state.cov)

    @property
    def d(self) -> int:
        return self.mean.shape[-1]

    @property
    @full_f32
    def cov(self):
        return self.chol @ self.chol.T

    def sample(self, key, n: int):
        return mvn_sample(key, self.mean, self.chol, n)

    def log_prob(self, x):
        return self._logpdf(jnp.asarray(x))

    def entropy(self):
        return mvn_entropy(self.chol)

    def kl_to(self, other: "Posterior"):
        """KL(self || other)."""
        return mvn_kl(self.mean, self.chol, other.mean, other.chol)

    def marginal(self, idx=None):
        """(mean, std) of the requested coordinates (all by default)."""
        std = jnp.sqrt(jnp.sum(self.chol * self.chol, axis=1))
        if idx is None:
            return self.mean, std
        idx = jnp.asarray(idx)
        return self.mean[idx], std[idx]

    # -- serialization (serving artifact: two arrays, no pickle) ------------
    def save(self, path: str) -> None:
        """Write the fitted Gaussian as an npz of (mean, chol); ``.npz`` is
        appended if missing (np.savez appends it silently on save, so load
        must see the same name)."""
        import numpy as np

        np.savez(path if path.endswith(".npz") else path + ".npz",
                 mean=np.asarray(self.mean), chol=np.asarray(self.chol))

    @classmethod
    def load(cls, path: str) -> "Posterior":
        import os

        import numpy as np

        if not path.endswith(".npz"):
            # save() always writes ``path + '.npz'`` — prefer that over an
            # unrelated extensionless file that happens to share the name.
            cand = path + ".npz"
            if os.path.exists(cand) or not os.path.exists(path):
                path = cand
        with np.load(path) as z:
            return cls(z["mean"], z["chol"])
