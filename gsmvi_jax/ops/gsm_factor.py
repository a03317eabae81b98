"""Factorized GSM: covariance tracked as S = F F^T, no Cholesky in the hot loop.

Motivation.  The dense GSM step (ops/gsm.py + state.accept_or_revert) pays an
O(D^3) Cholesky every iteration — needed both for sampling and for the
validity check.  The Cholesky is a panel-sequential algorithm, while
everything else in GSM is matmuls.  This module reformulates the iteration so the hot loop is
*matmul-only*:

State: a (non-triangular) factor ``F`` with ``S = F F^T`` and its maintained
inverse ``Finv``.  Sampling needs only ``x = mu + eps @ F.T`` (any square
factor works — triangularity is a Cholesky artifact).  The GSM covariance
delta is rank-2B:

    S' = S + U U^T - V V^T,     U = A^T/sqrt(B),  V = Bm^T/sqrt(B)

which conjugates into the factor as

    S' = F (I + P J P^T) F^T,   P = Finv [U, V]  (D x 2B), J = diag(I, -I)

and the middle term admits an exact square factor via an orthogonal
reduction: with the thin QR ``P = Q R`` (Q: D x k orthonormal, k = min(D, 2B))
and ``W = R J R^T``,

    I + P J P^T = I + Q W Q^T = (I + Q C Q^T)(I + Q C Q^T)^T

where, because Q^T Q = I, C must solve (I + C)^2 = I + W:

    C  = (I + W)^{1/2} - I,      Ct = (I + W)^{-1/2} - I

— one (k x k) symmetric eigendecomposition gives both C and the inverse
correction.  The update and its inverse are rank-k corrections:

    F'    = F + (F Q) C Q^T
    Finv' = Finv + Q Ct (Q^T Finv)

Cost per step: a handful of (D x 2B)-shaped matmuls + a thin QR — O(B D^2) —
plus O(B^3) small-matrix work.  No D x D factorization anywhere.  (An earlier
formulation used G^{+-1/2} with G = P^T P; that inverse square root amplifies
f32 noise catastrophically when P is rank-deficient — e.g. whenever 2B > D —
which the QR route avoids entirely.)

Validity check, exactly: S' is PD  <=>  I + W is PD (congruent via the
orthogonal completion of Q), so the goodness test is ``min eig(I + W) > tol``
— a byproduct of the eigh we already compute, replacing the reference's host
Cholesky-and-NaN probe (``gsmvi/gsm.py:136-150``) with a *sharper* on-device
criterion.

Drift: Finv is corrected by exact Woodbury algebra each step; consistency
error (||Finv F - I||) grows only in accumulated rounding.  ``refresh``
re-orthogonalizes both from the dense covariance at a configurable cadence
(default: every 1000 steps) for long runs.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..distributions import full_f32


def factor_gsm_step_stats(samples, vs, mu0, F, Finv):
    """One factorized GSM update.

    Inputs: samples/vs (B, D); mu0 (D,); F, Finv (D, D) with S = F F^T.
    Returns (dmu, F_new, Finv_new, good) — ``good`` is the exact PD check of
    the proposed covariance; callers select old/new state on it.
    """
    b, d = samples.shape
    with jax.default_matmul_precision("float32"):
        return _factor_step_impl(samples, vs, mu0, F, Finv, b)


def _factor_step_impl(samples, vs, mu0, F, Finv, b):
    dtype = F.dtype

    # --- GSM mean update (identical math to ops/gsm.py, S applied as F F^T) ---
    a = mu0 - samples                                    # (B, D)
    t = (vs @ F) @ F.T                                   # rows S0 @ v_b
    vsv = jnp.sum(vs * t, axis=-1)
    mv = jnp.sum(a * vs, axis=-1)
    rho = 0.5 * (jnp.sqrt(1.0 + 4.0 * (vsv + mv * mv)) - 1.0)
    eps0 = t - a
    w = jnp.sum(vs * eps0, axis=-1)
    dmu_b = (eps0 - a * (w / (1.0 + rho + mv))[:, None]) / (1.0 + rho)[:, None]
    bm = a + dmu_b
    dmu = jnp.mean(dmu_b, axis=0)

    # --- rank-2B factor update via orthogonal (QR) reduction ---
    # I + P J P^T = I + Q W Q^T with P = QR (Q orthonormal), W = R J R^T.
    # Because Q^T Q = I the square-factor equation collapses to
    # (I + C)^2 = I + W  =>  C = (I+W)^{1/2} - I, and the inverse correction
    # is Ct = (I+W)^{-1/2} - I — one (2B x 2B) eigh, no G^{-1/2}.  This stays
    # well-conditioned even when P is rank-deficient (e.g. 2B > D), where the
    # earlier G^{-1/2} formulation amplified f32 noise catastrophically.
    scale = 1.0 / jnp.sqrt(jnp.asarray(b, dtype))
    uv = jnp.concatenate([a.T, bm.T], axis=1) * scale    # (D, 2B): [U, V]
    p = Finv @ uv                                        # (D, 2B)
    q, r = jnp.linalg.qr(p)                              # (D, k), (k, 2B)
    k = q.shape[1]                                       # k = min(D, 2B)
    jj = jnp.concatenate([jnp.ones(b, dtype), -jnp.ones(b, dtype)])
    w = (r * jj) @ r.T                                   # R J R^T, (k, k)
    m = jnp.eye(k, dtype=dtype) + 0.5 * (w + w.T)        # I + W
    mw, mq = jnp.linalg.eigh(m)
    good = mw[0] > 1e-6                                  # exact PD criterion
    mw_safe = jnp.maximum(mw, 1e-12)
    sqrt_w = jnp.sqrt(mw_safe)
    eye_k = jnp.eye(k, dtype=dtype)
    c = (mq * sqrt_w) @ mq.T - eye_k                     # (I+W)^{1/2} - I
    ct = (mq / sqrt_w) @ mq.T - eye_k                    # (I+W)^{-1/2} - I

    # F' = F (I + Q C Q^T);  Finv' = (I + Q Ct Q^T) Finv
    f_new = F + (F @ q) @ (c @ q.T)
    finv_new = Finv + q @ (ct @ (q.T @ Finv))

    return dmu, f_new, finv_new, good


@full_f32
@partial(jax.jit, static_argnums=(2,))
def factor_refresh(F, Finv, newton_steps: int = 2):
    """Tighten Finv against F with Newton iterations (Finv <- Finv(2I - F Finv)).

    Quadratic convergence: each step squares the residual ||I - F Finv||.
    O(D^3) matmuls, intended for occasional use, not the hot loop.
    """
    d = F.shape[0]
    eye = jnp.eye(d, dtype=F.dtype)

    def body(_, inv):
        return inv @ (2.0 * eye - F @ inv)

    return jax.lax.fori_loop(0, newton_steps, body, Finv)


@full_f32
def factor_to_cov(F):
    """Materialize the dense covariance S = F F^T (checkpoints/monitors only)."""
    s = F @ F.T
    return 0.5 * (s + s.T)


def _update_corr(g, newton_iters):
    """C = (I + (I+G)^{1/2})^{-1} for the PSD-update phase.

    Solves 2C + C G C = I (the factor equation of I + P P^T) in the G-stable
    form: substituting X = G^{1/2} C G^{1/2} gives X = (I+G)^{1/2} - I, and
    because G commutes with (I+G)^{1/2},
        C = G^{-1/2} X G^{-1/2} = ((I+G)^{1/2} + I)^{-1}
    — no inverse square root of (possibly singular) G anywhere.  I+G has
    eigenvalues >= 1, ideal for Newton-Schulz.
    """
    from .sqrtm import spd_sqrtm_newton

    k = g.shape[0]
    eye = jnp.eye(k, dtype=g.dtype)
    root = spd_sqrtm_newton(eye + g, newton_iters)
    root = 0.5 * (root + root.T)
    return jnp.linalg.solve(root + eye, eye), root


def _downdate_corr(g, newton_iters):
    """C = -(I + (I-G)^{1/2})^{-1} for the PSD-downdate phase; also returns
    ``good`` = PD criterion (I - G > 0 <=> downdated matrix stays PD).

    (I-G)^{1/2} can be arbitrarily ill-conditioned near the PD boundary, so
    this uses eigh (the matrix is (B x B)-small) with eigenvalue clamping.
    """
    k = g.shape[0]
    eye = jnp.eye(k, dtype=g.dtype)
    w, q = jnp.linalg.eigh(eye - 0.5 * (g + g.T))
    good = w[0] > 1e-6
    root = (q * jnp.sqrt(jnp.maximum(w, 1e-12))) @ q.T
    return -jnp.linalg.solve(root + eye, eye), good


def factor_gsm_step_stats_v2(samples, vs, mu0, F, Finv,
                             newton_iters: int = 12):
    """Two-phase factorized GSM update: no QR, no D x D factorization.

    Splits S' = S + U U^T - V V^T into a PSD update then a PSD downdate, each
    with an exact low-rank square-factor correction of the form
    (I + P C P^T) where C is a tiny (B x B) matrix from the stable
    ``(I + (I +/- G)^{1/2})^{-1}`` formula (see _update_corr/_downdate_corr).
    The D-sized work is ~10 (D x B)-shaped matmuls per step.

    Returns (dmu, F_new, Finv_new, good) like ``factor_gsm_step_stats``.
    """
    b, d = samples.shape
    with jax.default_matmul_precision("float32"):
        dtype = F.dtype

        # GSM mean update (identical math to the v1 path).
        a = mu0 - samples
        t = (vs @ F) @ F.T
        vsv = jnp.sum(vs * t, axis=-1)
        mv = jnp.sum(a * vs, axis=-1)
        rho = 0.5 * (jnp.sqrt(1.0 + 4.0 * (vsv + mv * mv)) - 1.0)
        eps0 = t - a
        w = jnp.sum(vs * eps0, axis=-1)
        dmu_b = (eps0 - a * (w / (1.0 + rho + mv))[:, None]) \
            / (1.0 + rho)[:, None]
        bm = a + dmu_b
        dmu = jnp.mean(dmu_b, axis=0)
        scale = 1.0 / jnp.sqrt(jnp.asarray(b, dtype))
        u = a.T * scale                                  # (D, B)
        v = bm.T * scale                                 # (D, B)

        # Phase 1: S1 = S + U U^T  (always PD).
        pu = Finv @ u                                    # (D, B)
        gu = pu.T @ pu
        cu, _ = _update_corr(gu, newton_iters)
        f1 = F + (F @ pu) @ (cu @ pu.T)
        # (I + Pu Cu Pu^T)^{-1} = I - Pu Cu (I + Gu Cu)^{-1} Pu^T
        eye_b = jnp.eye(b, dtype=dtype)
        cu_inv = cu @ jnp.linalg.inv(eye_b + gu @ cu)
        f1inv = Finv - pu @ (cu_inv @ (pu.T @ Finv))

        # Phase 2: S' = S1 - V V^T  (PD iff I - Gv > 0).
        pv = f1inv @ v                                   # (D, B)
        gv = pv.T @ pv
        cv, good = _downdate_corr(gv, newton_iters)
        f_new = f1 + (f1 @ pv) @ (cv @ pv.T)
        cv_inv = cv @ jnp.linalg.inv(eye_b + gv @ cv)
        finv_new = f1inv - pv @ (cv_inv @ (pv.T @ f1inv))

        return dmu, f_new, finv_new, good
