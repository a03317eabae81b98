"""Batch-and-Match (BaM) update kernels, fully on-device (arXiv:2402.14758).

The reference update (``gsmvi/bam.py:31-69``) solves

    S = 2 (I + sqrtm(I + 4 V U))^{-1} V

with a *nonsymmetric* ``sqrtm`` that needs a scipy host callback on GPU
(``gsmvi/bam.py:19-28``).  We use the similarity
reformulation (also used in the BaM paper's exact solver): with the Cholesky
factor ``L`` of the SPD matrix ``V``,

    I + 4 V U = L (I + 4 L^T U L) L^{-1}
    => S = 2 L (I + sqrtm(I + 4 L^T U L))^{-1} L^T

where ``M = I + 4 L^T U L`` is symmetric with eigenvalues >= 1, so its root is
an SPD ``eigh`` (or matmul-only Newton–Schulz) — no host escape, and computing
``S = 2 Y^T Y`` with ``Y = K^{-1} L^T``, ``K = chol(I + sqrt(M))`` makes the
result *exactly* symmetric PSD by construction.  The reference instead jitters
and symmetrizes after the fact on the host (``gsmvi/bam.py:198-199``); here the
jitter is folded into the kernel.

The low-rank variant (``gsmvi/bam.py:72-114``) calls a host
``scipy.sparse.linalg.svds`` to factor U (``gsmvi/bam.py:10-17``).  But U is
*by construction* PSD with rank <= B+1:

    U = reg * G + reg/(1+reg) gbar gbar^T,   G = Gd^T Gd / B

so an exact factor is available with zero factorization work:

    F = [ sqrt(reg/B) * Gd^T | sqrt(reg/(1+reg)) * gbar ]   (D x (B+1))

The downstream Woodbury-style solve is invariant to the choice of factor of U
(verified in tests against the full-rank path), so the svds callback is
eliminated entirely.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from .sqrtm import spd_sqrtm, spd_sqrtm_newton


def bam_batch_stats(samples, vs):
    """Batch moments used by both BaM variants.

    Returns (xbar, C, gbar, G) where C and G are the *centered* second moments
    of the samples and scores — computed as Gram matrices (one matmul each,
    exactly symmetric) instead of the reference's vmap of rank-one outers
    (``gsmvi/bam.py:50-57``).
    """
    b = samples.shape[0]
    xbar = jnp.mean(samples, axis=0)
    gbar = jnp.mean(vs, axis=0)
    xd = samples - xbar
    gd = vs - gbar
    c = jnp.matmul(xd.T, xd, preferred_element_type=samples.dtype) / b
    g = jnp.matmul(gd.T, gd, preferred_element_type=vs.dtype) / b
    return xbar, c, gbar, g


def _bam_uv(samples, vs, mu0, S0, reg):
    xbar, c, gbar, g = bam_batch_stats(samples, vs)
    r1 = reg / (1.0 + reg)
    u = reg * g + r1 * jnp.outer(gbar, gbar)
    v = S0 + reg * c + r1 * jnp.outer(mu0 - xbar, mu0 - xbar)
    return xbar, gbar, u, v


def _bam_mu(mu0, xbar, gbar, s, reg):
    r1 = reg / (1.0 + reg)
    return mu0 / (1.0 + reg) + r1 * (s @ gbar + xbar)


def _robust_sqrt(m, sqrt_method, newton_iters, rtol=1e-3):
    """SPD sqrt of ``m``: Newton-Schulz fast path with an eigh fallback.

    Newton-Schulz is matmul-only, but its
    convergence degrades for ill-conditioned inputs (e.g. BaM's
    M = I + 4 L^T U L early in an aggressive reg schedule).  The residual
    ||YY - M||_F / ||M||_F gates a ``lax.cond`` to the eigh branch, so the
    slow-but-robust path only executes on the hard steps.
    """
    if sqrt_method != "newton":
        return spd_sqrtm(m)
    root = spd_sqrtm_newton(m, newton_iters)
    root = 0.5 * (root + root.T)
    res = jnp.linalg.norm(root @ root - m) / jnp.maximum(
        jnp.linalg.norm(m), 1e-30)
    return jax.lax.cond(res < rtol, lambda _: root, spd_sqrtm, m)


@partial(jax.jit, static_argnames=("jitter", "sqrt_method", "newton_iters"))
def bam_update(samples, vs, mu0, S0, reg, jitter: float = 0.0,
               sqrt_method: str = "eigh", newton_iters: int = 20):
    """Full-rank BaM update; drop-in for reference ``bam_update``.

    Inputs match ``gsmvi/bam.py:31-69``: samples/vs (B, D); mu0 (D,);
    S0 (D, D); reg scalar regularizer.  Extra knobs:
      jitter       — added to V's diagonal before factorization (the reference
                     applies ``1e-6 I`` on the host after the update,
                     ``gsmvi/bam.py:198``; here it stabilizes the chol of V and
                     the returned S inherits PD-ness structurally).
      sqrt_method  — "eigh" (robust default) or "newton" (matmul-only
                     Newton–Schulz, for well-conditioned M).
    Returns (mu, S) with S exactly symmetric PSD.
    """
    if samples.ndim != 2 or vs.ndim != 2:
        raise ValueError("samples and vs must be (batch, dim) arrays")
    with jax.default_matmul_precision("float32"):
        return _bam_update_impl(samples, vs, mu0, S0, reg, jitter,
                                sqrt_method, newton_iters)


def _bam_update_impl(samples, vs, mu0, S0, reg, jitter, sqrt_method,
                     newton_iters):
    d = mu0.shape[-1]
    dtype = S0.dtype
    eye = jnp.eye(d, dtype=dtype)
    xbar, gbar, u, v = _bam_uv(samples, vs, mu0, S0, reg)
    if jitter:
        v = v + jitter * eye
    l = jnp.linalg.cholesky(v)
    m = eye + 4.0 * (l.T @ u @ l)
    m = 0.5 * (m + m.T)  # kill matmul round-off asymmetry before eigh
    sqrt_m = _robust_sqrt(m, sqrt_method, newton_iters)
    k = jnp.linalg.cholesky(eye + sqrt_m)
    y = solve_triangular(k, l.T, lower=True)
    s = y.T @ y
    s = s + s.T  # = 2 Y^T Y, exactly symmetric under any gemm schedule
    mu = _bam_mu(mu0, xbar, gbar, s, reg)
    return mu, s


@partial(jax.jit, static_argnames=("jitter", "sqrt_method", "newton_iters"))
def bam_lowrank_update(samples, vs, mu0, S0, reg, jitter: float = 0.0,
                       sqrt_method: str = "eigh", newton_iters: int = 20):
    """Low-rank BaM update; drop-in for reference ``bam_lowrank_update``.

    Replaces the reference's host svds factorization (``gsmvi/bam.py:104``)
    with the exact D x (B+1) factor of U (see module docstring), then solves
    the (B+1)x(B+1) inner system on device:

        A  = V F
        Mk = F^T A                    (symmetric PSD, (B+1)^2)
        R  = 0.5 I + sqrt(Mk + 0.25 I)   (eigh of a tiny matrix)
        S  = V - A R^{-2} A^T  =  V - Z Z^T,  Z = A (chol(R^2))^{-T}

    matching ``gsmvi/bam.py:107-111`` exactly when U = F F^T, while keeping S
    exactly symmetric.  All O(D^2) work is matmuls.
    """
    if samples.ndim != 2 or vs.ndim != 2:
        raise ValueError("samples and vs must be (batch, dim) arrays")
    with jax.default_matmul_precision("float32"):
        return _bam_lowrank_update_impl(samples, vs, mu0, S0, reg, jitter,
                                        sqrt_method, newton_iters)


def _bam_lowrank_update_impl(samples, vs, mu0, S0, reg, jitter, sqrt_method,
                             newton_iters):
    b = samples.shape[0]
    dtype = S0.dtype
    xbar = jnp.mean(samples, axis=0)
    gbar = jnp.mean(vs, axis=0)
    gd = vs - gbar
    xd = samples - xbar
    r1 = reg / (1.0 + reg)
    v = S0 + reg * (jnp.matmul(xd.T, xd, preferred_element_type=dtype) / b) \
        + r1 * jnp.outer(mu0 - xbar, mu0 - xbar)
    if jitter:
        v = v + jitter * jnp.eye(v.shape[-1], dtype=dtype)
    # Exact factor of U = reg*G + r1*gbar gbar^T, shape (D, B+1).
    f = jnp.concatenate(
        [jnp.sqrt(reg / b) * gd.T, jnp.sqrt(r1) * gbar[:, None]], axis=1
    )
    a = v @ f                                            # (D, B+1)
    mk = f.T @ a                                         # (B+1, B+1)
    k1 = mk.shape[-1]
    eye_k = jnp.eye(k1, dtype=dtype)
    inner = 0.5 * (mk + mk.T) + 0.25 * eye_k
    rt = 0.5 * eye_k + _robust_sqrt(inner, sqrt_method, newton_iters)
    bb = rt @ rt
    kc = jnp.linalg.cholesky(0.5 * (bb + bb.T))
    z = solve_triangular(kc, a.T, lower=True)            # (B+1, D)
    s = v - z.T @ z
    s = 0.5 * (s + s.T)  # exact symmetry under any gemm schedule
    mu = _bam_mu(mu0, xbar, gbar, s, reg)
    return mu, s


class Regularizers:
    """Regularization schedules for BaM; API parity with ``gsmvi/bam.py:237-274``.

    The reference's closures mutate ``self.counter`` per call and ignore the
    iteration argument; inside a compiled loop the schedule must instead be a
    pure function of the iteration index.  Since the reference calls ``regf``
    exactly once per iteration starting at i=0, its counter equals ``i + 1``,
    so the pure equivalents are:

        constant(reg0): i -> reg0
        linear(reg0):   i -> reg0 / (i + 1)
        custom(func):   i -> func(i + 1)

    ``counter``/``reset`` are kept for API compatibility; they track eager
    (uncompiled) invocations only.
    """

    def __init__(self):
        self.counter = 0

    def reset(self):
        self.counter = 0

    def constant(self, reg0):
        def reg_iter(iteration):
            self.counter += 1
            return reg0
        return reg_iter

    def linear(self, reg0):
        def reg_iter(iteration):
            self.counter += 1
            return reg0 / (iteration + 1.0)
        return reg_iter

    def custom(self, func):
        def reg_iter(iteration):
            self.counter += 1
            return func(iteration + 1)
        return reg_iter
