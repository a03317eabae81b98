"""Eps-coordinate factorized GSM update: no D x D factorization, no inverse.

This is the round-2 redesign of the factorized GSM step (see ops/gsm_factor.py
for the round-1 QR/eigh route).  The crucial observation: the fitter *itself*
draws the samples from the current factor,

    x_b = mu + eps_b F^T        =>   a_b := mu - x_b = -(eps_b F^T)

so the rank-2B covariance delta of GSM (reference ``gsmvi/gsm.py:25-27,53-56``)

    S' = S + (A^T A - Bm^T Bm)/B,     S = F F^T

is *already known in F-coordinates* without ever applying F^{-1}:

    F^{-1} A^T  = -eps^T                                  (free)
    F^{-1} Bm^T = C^T,  c_b = -gamma_b eps_b + delta_b (v_b F)   (free)

because b_b = a_b + dmu_b lies in span{a_b, t_b} with t_b = v_b F F^T, and
(v_b F) is an intermediate of the t computation anyway.  Hence

    S' = F (I + Z J Z^T) F^T,   Z = [-eps^T | C^T]/sqrt(B),  J = diag(I,-I)

and an exact square factor of the middle matrix comes from two *tiny*
(2B x 2B) Cholesky factorizations instead of any D-sized decomposition:

    G  = Z^T Z + eps_j I   (jitter ~1e-6 tr/2B; exact identity degrades O(eps_j))
    Lg = chol(G)
    K  = I + Lg^T J Lg     (congruent to I + Z J Z^T on range(Z))
    Ck = chol(K)           -- succeeds  <=>  S' is PD   (the validity check)
    S2 = Lg^{-T} (Ck - I) Lg^{-1}
    F' = F + (F Z) S2 Z^T,     F Z = [A^T | Bm^T]/sqrt(B)   (free again)

Then F' F'^T = S' exactly (up to the O(eps_j) jitter term), the PD check is
exact (chol(K) finite <=> min eig(I + ZJZ^T) > 0), and the per-step D-sized
work is ~5 matmuls of shape (D,D)x(D,2B)-class.  The small solves are
(2B x 2B); ops/gsm_eps_ns.py has a matmul-only Newton-Schulz variant.

Replaces: the reference's host Cholesky probe (``gsmvi/gsm.py:125,136-150``)
and the O(D^3) on-device Cholesky of the dense path — the hot loop of this
formulation contains no factorization of anything D-sized.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular


def gsm_eps_rowwork(eps, vs, vf, f):
    """Shared row-space math of the eps-coordinate step.

    Inputs: eps (B, D) standard-normal draws; vs (B, D) scores at
    x = mu + eps F^T; vf = vs @ F (B, D); f = F (D, D).
    Returns (dmu, zt, fz_t) where
      dmu  — (D,) GSM mean update,
      zt   — (2B, D) = Z^T, rows [-eps; C]/sqrt(B),
      fz_t — (2B, D) = (F Z)^T, rows [A; Bm]/sqrt(B).
    """
    b = eps.shape[0]
    dtype = f.dtype
    a = -(eps @ f.T)                                    # (B, D) rows mu - x
    t = vf @ f.T                                        # rows S v_b
    vsv = jnp.sum(vs * t, axis=-1)
    mv = jnp.sum(a * vs, axis=-1)
    rho = 0.5 * (jnp.sqrt(1.0 + 4.0 * (vsv + mv * mv)) - 1.0)
    eps0 = t - a
    w = jnp.sum(vs * eps0, axis=-1)
    den = 1.0 + rho + mv
    inv1r = 1.0 / (1.0 + rho)
    dmu_b = (eps0 - a * (w / den)[:, None]) * inv1r[:, None]
    dmu = jnp.mean(dmu_b, axis=0)
    bm = a + dmu_b                                      # rows mu_new - x
    # b_b = gamma_b a_b + delta_b t_b  with  a_b = -eps_b F^T, t_b = (v_b F)F^T
    gamma = 1.0 - (1.0 + w / den) * inv1r               # (B,)
    delta = inv1r
    c = -eps * gamma[:, None] + vf * delta[:, None]     # rows F^{-1} b_b
    scale = 1.0 / jnp.sqrt(jnp.asarray(b, dtype))
    zt = jnp.concatenate([-eps, c], axis=0) * scale     # (2B, D)
    fz_t = jnp.concatenate([a, bm], axis=0) * scale     # (2B, D)
    return dmu, zt, fz_t


def _default_jitter(dtype) -> float:
    """G-jitter scaled to the dtype's rounding floor (the factor identity
    degrades O(jitter), so keep it near machine epsilon)."""
    return 1e-12 if jnp.finfo(dtype).bits >= 64 else 1e-6


def eps_core(zt, n_plus: int, jitter=None):
    """Small-space core: factor I + Z J Z^T from Z^T (K, D) rows.

    ``J = diag(+1 x n_plus, -1 x (K - n_plus))`` — the first ``n_plus`` rows
    of ``zt`` are update directions, the rest downdates.  Returns (s2, good):
    the (K, K) middle matrix of W = I + Z S2 Z^T with W W^T = I + Z J Z^T,
    and ``good`` — the exact positive-definiteness flag of I + Z J Z^T
    (equivalently of the proposed covariance).
    """
    dtype = zt.dtype
    if jitter is None:
        jitter = _default_jitter(dtype)
    k2 = zt.shape[0]
    g = jnp.matmul(zt, zt.T, preferred_element_type=dtype)  # (K, K)
    g = 0.5 * (g + g.T)
    eye = jnp.eye(k2, dtype=dtype)
    g = g + (jitter * (jnp.trace(g) / k2 + 1.0)) * eye
    lg = jnp.linalg.cholesky(g)
    jj = jnp.concatenate([jnp.ones(n_plus, dtype),
                          -jnp.ones(k2 - n_plus, dtype)])
    jlg = lg * jj[:, None]                         # J Lg (row-scaled)
    k = eye + lg.T @ jlg                           # I + Lg^T J Lg
    k = 0.5 * (k + k.T)
    ck, good = _chol_pd(k)
    ck_safe = jnp.where(good, ck, eye)
    # S2 = Lg^{-T} (Ck - I) Lg^{-1}: two tiny triangular solves.
    s2 = solve_triangular(lg, ck_safe - eye, lower=True, trans=1)
    s2 = solve_triangular(lg, s2.T, lower=True, trans=1).T
    return s2, good


def _chol_pd(k):
    """(chol(k), pd_flag): good iff every factor entry is finite —
    jnp.linalg.cholesky yields NaN rows from the first non-PD pivot on, so
    all-finite is exactly the PD criterion (up to fp roundoff at the
    boundary, covered by the caller's jitter)."""
    ck = jnp.linalg.cholesky(k)
    good = jnp.all(jnp.isfinite(ck))
    return ck, good


def gsm_eps_factor_update(eps, vs, mean, f, jitter=None):
    """One eps-coordinate GSM step given externally-evaluated scores.

    Inputs: eps (B, D); vs (B, D) = lp_g(mean + eps @ f.T); mean (D,);
    f (D, D) any square factor with S = f f^T.
    Returns (mean_new, f_new, good) — proposals and the exact PD flag; the
    caller selects old/new on ``good`` (or uses ``apply_eps_step``).
    """
    b = eps.shape[0]
    d = f.shape[-1]
    with jax.default_matmul_precision("float32"):
        vf = vs @ f
        dmu, zt, fz_t = gsm_eps_rowwork(eps, vs, vf, f)
        if 2 * b >= d:
            # Rank-deficient small-space regime (G singular): the middle
            # matrix I + Z J Z^T is only D x D <= 2B x 2B here, so factor it
            # directly — exact, no jitter amplification.
            dtype = f.dtype
            jj = jnp.concatenate([jnp.ones(b, dtype), -jnp.ones(b, dtype)])
            m = jnp.eye(d, dtype=dtype) + zt.T @ (zt * jj[:, None])
            w, good = _chol_pd(0.5 * (m + m.T))
            w = jnp.where(good, w, jnp.eye(d, dtype=dtype))
            return mean + dmu, f @ w, good
        s2, good = eps_core(zt, b, jitter)
        f_new = f + fz_t.T @ (s2 @ zt)
        return mean + dmu, f_new, good


def apply_eps_step(state_mean, state_f, eps, vs, jitter=None):
    """Proposal + select in one call: returns (mean, f, good) with the
    old values kept when the proposed covariance is not PD (the on-device
    equivalent of the reference's revert, ``gsmvi/gsm.py:125-129``)."""
    mean_new, f_new, good = gsm_eps_factor_update(eps, vs, state_mean,
                                                  state_f, jitter)
    mean = jnp.where(good, mean_new, state_mean)
    f = jnp.where(good, f_new, state_f)
    return mean, f, good
