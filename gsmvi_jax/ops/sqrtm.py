"""On-device matrix square roots (replacing the reference's host callbacks).

The reference dispatches ``sqrtm`` by backend and raises on other devices (reference
``gsmvi/bam.py:19-28``: GPU -> ``jax.pure_callback`` to ``scipy.linalg.sqrtm``,
CPU -> ``jax.scipy.linalg.sqrtm``, else raise).  Both escapes break jit fusion
and force a host round trip inside the update.  Every matrix BaM actually needs
a square root of is symmetric positive (semi)definite after the similarity
reformulation in ``ops/bam.py``, so we only need SPD square roots, which are
cheap and robust on device:

- ``spd_sqrtm``          — eigendecomposition route: M = Q diag(l) Q^T,
  sqrt(M) = Q diag(sqrt(max(l,0))) Q^T.  Robust for any conditioning.
- ``spd_sqrtm_newton``   — scaled Newton–Schulz iteration (matmul-only,
  differentiable, great for well-conditioned M such as
  I + PSD).  Coupled iteration: Y <- Y (3I - Z Y)/2, Z <- (3I - Z Y)/2 Z on
  the trace-normalized matrix (arXiv:2006.11267 surveys these schemes).
- ``spd_sqrtm_and_inv``  — returns (sqrt(M), sqrt(M)^{-1}) from one eigh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def spd_sqrtm(mat, eps: float = 0.0):
    """Symmetric PSD square root via eigendecomposition.

    Eigenvalues are clipped at ``eps`` (default 0) so slightly-indefinite
    inputs produced by floating-point noise still yield a real PSD root.
    """
    w, q = jnp.linalg.eigh(mat)
    w = jnp.maximum(w, eps)
    return (q * jnp.sqrt(w)) @ q.T


def spd_sqrtm_and_inv(mat, eps: float = 1e-30):
    """(sqrt(M), inv(sqrt(M))) for SPD ``M`` from a single eigh."""
    w, q = jnp.linalg.eigh(mat)
    w = jnp.maximum(w, eps)
    sw = jnp.sqrt(w)
    return (q * sw) @ q.T, (q / sw) @ q.T


@partial(jax.jit, static_argnums=(1,))
def spd_sqrtm_newton(mat, num_iters: int = 20):
    """Scaled Newton–Schulz SPD square root: matmuls only.

    Normalizes by the row-sum (infinity) norm — a sharp upper bound on
    lambda_max for SPD inputs — so the scaled spectrum sits just below 1
    where the coupled iteration converges quadratically.  (The Frobenius
    norm over-estimates lambda_max by up to sqrt(D), wasting ~log1.5(sqrt D)
    sweeps in the linear warm-up phase — measured +28% whole-step
    throughput from this change in the eps-step small space,
    ops/gsm_eps_ns.py.)  Accuracy degrades for condition numbers
    >> 1e6; BaM's similarity-transformed target ``I + 4 L^T U L`` has
    eigenvalues >= 1, for which this is typically accurate to ~1e-6 in f32
    within 10-20 iterations.
    """
    d = mat.shape[-1]
    eye = jnp.eye(d, dtype=mat.dtype)
    norm = jnp.max(jnp.sum(jnp.abs(mat), axis=-1)) + jnp.asarray(
        1e-30, mat.dtype)
    y = mat / norm
    z = eye

    def body(_, yz):
        y, z = yz
        t = 0.5 * (3.0 * eye - z @ y)
        return (y @ t, t @ z)

    y, z = jax.lax.fori_loop(0, num_iters, body, (y, z))
    return y * jnp.sqrt(norm)
