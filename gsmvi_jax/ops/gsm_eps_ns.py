"""Matmul-only Newton-Schulz variant of the eps-coordinate GSM step.

Same update as ``ops/gsm_eps.py`` (see its docstring for the derivation),
but the middle factor is built in two phases — a PSD update by eps, then a
PSD downdate by the corrected rows — whose (B x B) square roots and inverses
are Newton-Schulz / Newton-Hotelling chains instead of Cholesky factorizations
and triangular solves.  The whole step is then matmuls and elementwise ops,
which batch cleanly across replicas (``FactorGSM.fit_batch``).

The chains are approximate: ``good`` combines the PD criterion (the phase-2
square root cannot converge on an indefinite ``I - Gv``) with residual gates
on both phases, so a numerically lost step is rejected rather than applied.
The gates catch catastrophic loss, not slow bias — the iteration counts are
validated against the exact Cholesky step by converged moments
(``tests/test_ns_profile.py``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST
# Newton-Schulz sweep counts (sqrt1, inv1, inv2, sqrt2, inv3) for the small
# space.  The short profile is validated for B <= 32; at B >= 64 the (B, B)
# Grams' spectra widen and it biases silently (converged cov_err 0.012 /
# 0.049 / 0.21 at B = 64 / 128 / 512 on the D=256 dense Gaussian, with zero
# rejections), while the long profile matches the exact Cholesky step there.
NS_ITERS_DEFAULT = (5, 4, 6, 7, 4)
NS_ITERS_LARGE_B = (8, 6, 9, 10, 6)


def ns_iters_for_batch(b: int, override=None):
    """Batch-aware NS profile: the short profile for B <= 32, the long one
    above (see ``NS_ITERS_DEFAULT``).  ``override`` wins when given."""
    if override is not None:
        return tuple(override)
    return NS_ITERS_DEFAULT if b <= 32 else NS_ITERS_LARGE_B


def _spd_norm_ub(a):
    """Sharp upper bound on lambda_max of small SPD ``a``: the row-sum
    (infinity) norm.  The Frobenius norm over-estimates lambda_max by up to
    sqrt(k) and parks the scaled spectrum far below 1, wasting sweeps in the
    linear warm-up phase."""
    return jnp.max(jnp.sum(jnp.abs(a), axis=-1)) + 1e-30


def _ns_sqrt(a, iters: int):
    """Newton-Schulz SPD square root (matmul-only, statically unrolled)."""
    n = a.shape[-1]
    eye = jnp.eye(n, dtype=jnp.float32)
    nrm = _spd_norm_ub(a)
    y = a / nrm
    z = eye
    for _ in range(iters):
        t = 0.5 * (3.0 * eye - jnp.dot(z, y, preferred_element_type=jnp.float32,
                                       precision=_HI))
        y = jnp.dot(y, t, preferred_element_type=jnp.float32, precision=_HI)
        z = jnp.dot(t, z, preferred_element_type=jnp.float32, precision=_HI)
    return y * jnp.sqrt(nrm)


def _newton_inv(a, iters: int):
    """Newton-Hotelling inverse of a small SPD matrix (matmul-only).

    X0 = I/c with c >= lambda_max gives ||I - A X0|| < 1 for SPD A, so the
    iteration X <- X(2I - A X) always converges; ~log2(cond)+5 iterations
    suffice.  c is the sharp row-sum bound (see _spd_norm_ub)."""
    n = a.shape[-1]
    eye = jnp.eye(n, dtype=jnp.float32)
    x = eye * (1.0 / _spd_norm_ub(a))
    for _ in range(iters):
        x = jnp.dot(x, 2.0 * eye - jnp.dot(a, x,
                                           preferred_element_type=jnp.float32,
                                           precision=_HI),
                    preferred_element_type=jnp.float32, precision=_HI)
    return x


def _eps_smallspace_ns(e, v, vf, mu, f, *, batch: int, tol: float = 3e-3,
                       iters=NS_ITERS_DEFAULT, big_prec=None, ef_t=None):
    """Two-phase (PSD update then PSD downdate) factorization of
    M = I + (eps^T eps - C^T C)/B with matmul-only small solves.

    Returns (mu_new, f_new, good).  All small-space functions are scalar
    functions of the two (B, B) Grams:
        cu  = (I + S1)^{-1},        S1 = sqrt(I + Gu)
        cui = (I + S1 + Gu)^{-1}                       (= W1^{-1} coefficient)
        cv  = -(I + S2)^{-1},       S2 = sqrt(I - Gv)

    ``big_prec`` (default HIGHEST) relaxes ONLY the O(B D^2) products; the
    (B, B) small-space numerics, whose accuracy the gates depend on, always
    run at HIGHEST.  ``ef_t`` — optional precomputed ``e @ F^T`` (B, D), the
    sampling product every caller already forms.

    F-traffic layout: the two rank-B factor corrections apply as ONE
    (D, 2B) @ (2B, D) contraction, and the (Fw1 Xi~)^T rows are formed from
    row objects already at hand,
        Xi~^T F^T = zc (C F^T - (cui Ec) (E F^T)),  C F^T = -gamma ef + r t
        (Fw1 Xi~)^T = Xi~^T F^T + (Xi~^T W1row^T) U1row,
    so a step makes 5 F-sized contractions (ef, score, vf, t, apply).
    """
    b = batch
    bp = _HI if big_prec is None else big_prec

    def mm(x, y, prec=_HI):
        return jnp.dot(x, y, preferred_element_type=jnp.float32,
                       precision=prec)

    def mm_t(x, y, prec=_HI):
        return jax.lax.dot_general(x, y, (((1,), (1,)), ((), ())),
                                   preferred_element_type=jnp.float32,
                                   precision=prec)

    def t_mm(x, y, prec=_HI):
        return jax.lax.dot_general(x, y, (((0,), (0,)), ((), ())),
                                   preferred_element_type=jnp.float32,
                                   precision=prec)

    ef = mm_t(e, f, bp) if ef_t is None else ef_t          # (B, D)
    a = -ef                                                # rows mu - x
    t = mm_t(vf, f, bp)
    vsv = jnp.sum(v * t, axis=1, keepdims=True)
    mv = jnp.sum(a * v, axis=1, keepdims=True)
    rho = 0.5 * (jnp.sqrt(1.0 + 4.0 * (vsv + mv * mv)) - 1.0)
    eps0 = t - a
    w = jnp.sum(v * eps0, axis=1, keepdims=True)
    den = 1.0 + rho + mv
    inv1r = 1.0 / (1.0 + rho)
    dmu_b = (eps0 - a * (w / den)) * inv1r
    dmu = jnp.sum(dmu_b, axis=0, keepdims=True) / b        # (1, D)
    gamma = 1.0 - (1.0 + w / den) * inv1r
    c = -e * gamma + vf * inv1r                            # (B, D) downdate rows
    scale2 = 1.0 / b
    eye_b = jnp.eye(b, dtype=jnp.float32)

    # Phase 1: W1 = I + Zu cu Zu^T factors I + Zu Zu^T, Zu = eps^T/sqrt(B).
    gu = mm_t(e, e) * scale2                               # (B, B)
    gu = 0.5 * (gu + gu.T)
    s1 = _ns_sqrt(eye_b + gu, iters[0])
    s1 = 0.5 * (s1 + s1.T)
    res1 = jnp.sum((mm(s1, s1) - (eye_b + gu)) ** 2) \
        / (jnp.sum((eye_b + gu) ** 2) + 1e-30)
    cu = _newton_inv(eye_b + s1, iters[1])
    cui = _newton_inv(eye_b + s1 + gu, iters[2])

    # Xi~ = W1^{-1} Zc with Zc = C^T/sqrt(B) and W1^{-1} = I - Zu cui Zu^T,
    # carried as its transpose on row tensors.
    ec = mm_t(e, c) * scale2                               # B Zu^T Zc (B, B)
    zc_scale = 1.0 / jnp.sqrt(jnp.float32(b))
    cuiec = mm(cui, ec)                                    # (B, B)
    xim_t = (c - t_mm(cuiec, e)) * zc_scale                # (B, D)

    # Phase 2: downdate by Xi~ Xi~^T.
    gv = mm_t(xim_t, xim_t)                                # (B, B)
    gv = 0.5 * (gv + gv.T)
    i_gv = eye_b - gv
    s2 = _ns_sqrt(i_gv, iters[3])
    s2 = 0.5 * (s2 + s2.T)
    res2 = jnp.sum((mm(s2, s2) - i_gv) ** 2) / (jnp.sum(i_gv ** 2) + 1e-30)
    cv = -_newton_inv(eye_b + s2, iters[4])
    good = (res1 < tol) & (res2 < tol)

    # F' = F W1 W2 = F + U1 W1row + (Fw1 Xi~) (cv Xi~^T)
    # with U1 = F Zu (carried transposed as rows), W1row = cu Zu^T.
    u1row = a * (-zc_scale)                                # (B, D) = (F Zu)^T
    w1row = mm(cu, e) * zc_scale                           # (B, D) = cu Zu^T
    ximf_t = (-gamma * ef + inv1r * t - t_mm(cuiec, ef)) * zc_scale
    fw1xi_t = ximf_t + mm(mm_t(xim_t, w1row), u1row)       # (B, D)
    w2row = mm(cv, xim_t)                                  # (B, D)
    stack_u = jnp.concatenate([u1row, fw1xi_t], axis=0)    # (2B, D)
    stack_w = jnp.concatenate([w1row, w2row], axis=0)      # (2B, D)
    f_new = f + t_mm(stack_u, stack_w, bp)                 # one fat update
    return mu + dmu, f_new, good


@functools.partial(jax.jit, static_argnames=("iters", "big_prec"))
def gsm_eps_update_ns_xla(eps, vs, mean, f, iters=None, big_prec=None,
                          ef_t=None):
    """Eps-coordinate GSM update with the Newton-Schulz small space.

    Drop-in for ``ops.gsm_eps.apply_eps_step``: returns (mean, f, good) with
    the old state already selected back on rejection.  f32 only.
    ``iters`` defaults to the batch-aware profile (``ns_iters_for_batch``).
    """
    b, d = eps.shape
    dtype = jnp.float32
    iters = ns_iters_for_batch(b, iters)
    eps = eps.astype(dtype)
    vs = vs.astype(dtype)
    mu0 = mean.astype(dtype)
    f = f.astype(dtype)
    bp = _HI if big_prec is None else big_prec
    vf = jnp.dot(vs, f, preferred_element_type=dtype, precision=bp)
    if ef_t is not None:
        ef_t = ef_t.astype(dtype)
    mu_new, f_new, good = _eps_smallspace_ns(
        eps, vs, vf, mu0.reshape(1, d), f, batch=b, iters=iters, big_prec=bp,
        ef_t=ef_t)
    mean_o = jnp.where(good, mu_new[0], mu0)
    f_o = jnp.where(good, f_new, f)
    return mean_o, f_o, good
