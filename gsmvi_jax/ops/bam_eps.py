"""Factor-coordinate BaM update: no D x D factorization in the hot loop.

The round-1 BaM kernels (ops/bam.py) already eliminated the reference's host
``sqrtm``/``svds`` escapes (``gsmvi/bam.py:10-28``), but their hot loop still
pays two D x D Choleskys per step (V's, and the validity/sampling one in
``state.accept_or_revert``) plus a D x D matrix root per step.

This module removes every D-sized factorization by the same eps-coordinate
observation as ops/gsm_eps.py — the fitter samples from the factor it
maintains, so the rank-structured pieces of the update are already known in
factor coordinates:

  x_b = mu0 + eps_b F^T,  S0 = F F^T
  xbar = mu0 + epsbar F^T            =>  (mu0 - xbar)       = -(epsbar F^T)
  Xd   = X - xbar = (eps - epsbar)F^T =>  F^{-1} Xd^T        = (eps-epsbar)^T

The BaM "V" matrix (reference ``gsmvi/bam.py:60``) is therefore an identity-
plus-low-rank congruence:  V = F (I + Om Om^T) F^T  with

  Om = [ sqrt(reg/B) (eps-epsbar)^T | sqrt(reg/(1+reg)) (-epsbar)^T ]  (D, B+1)

and U keeps its exact rank-(B+1) factor FU (ops/bam.py module docstring).
The low-rank Woodbury solve (reference ``gsmvi/bam.py:104-111``) — which is
EXACT here because U = FU FU^T exactly — then gives S as a congruence too:

  Q  = F^T FU                                  (one matmul; the only D^2 B op)
  Mk = Q^T (I + Om Om^T) Q                     (small, (B+1)^2)
  R  = 1/2 I + sqrt(Mk + 1/4 I)                (small SPD sqrt)
  Xi = (Q + Om (Om^T Q)) R^{-T}... (via chol(R R^T))        (D, B+1)
  S  = F [ I + Om Om^T - Xi Xi^T ] F^T

The bracket is I + Z J Z^T with Z = [Om | Xi], J = diag(+I, -I) — exactly the
structure ops/gsm_eps.py factors with two (2B+2)-sized Choleskys
(``eps_core``), yielding F' with F'F'^T = S and the EXACT PD flag for free.
The mean update mu = mu0/(1+reg) + reg/(1+reg)(S gbar + xbar) applies S
through its factors (two matvecs).

Per step: ~6 D-sized matmuls, zero D x D factorizations, and small-space work
bounded by (2B+2).  Full-rank and low-rank BaM coincide on this route (U is
always exactly rank <= B+1), so one path serves both; equivalence against
ops/bam.py is pinned in tests/test_bam_eps.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .gsm_factor import _update_corr


def bam_eps_update(eps, vs, mean, f, reg, newton_iters: int = 20,
                   solver: str = "auto"):
    """One factor-coordinate BaM step.

    ``newton_iters=20`` is REQUIRED at aggressive schedules: Om is built
    from CENTERED eps (rank-deficient, so Gu has near-zero eigenvalues) and
    cond(I+Gu) ~ reg * lmax(Gram(ed))/B reaches ~1e4 at reg ~ 1000, where
    the Newton-Schulz warm-up is cond-bound (measured: rel err 0.22 @ 10
    sweeps, 1.5e-6 @ 20 at reg=1000, B=32, D=128 — pinned by
    tests/test_bam_eps.py).  The sharp inf-norm seed only buys ~2 sweeps
    here, unlike the fused GSM small space whose UNCENTERED Grams are
    well-conditioned.

    Inputs: eps (B, D) the standard-normal draws used for sampling;
    vs (B, D) = lp_g(mean + eps @ f.T); mean (D,); f (D, D) with S0 = f f^T;
    reg — the regularizer value for this iteration.
    Returns (mean_new, f_new, good): proposals plus the exact PD flag of the
    proposed covariance; callers select/revert on ``good``.

    ``solver`` picks how the small-space spectrum of Y = W1^T Q is computed:

    - ``"auto"`` (default): per-step conditioning-gated routing — compute
      the (B+1)^2 Gram's row-sum norm (an upper bound on lmax = smax(Y)^2)
      and take the ~70 us-cheaper eigh branch only while
      ``eps(dtype) * lmax <= 1e-3`` (the spectrum near l ~ 1, where the
      contraction weights vary fastest, stays resolved to the accuracy the
      SVD delivers); above the bound, the thin-SVD branch runs.  Stiffness
      is an early-fit transient, so steady state pays eigh cost with
      SVD-grade converged moments (VERDICT r2 item #3).
    - ``"svd"``: thin SVD of Y itself.  The contraction weights
      sqrt(sigma(l)) - 1 vary fastest near l ~ 1, so they need the singular
      values resolved to ADDITIVE accuracy ~ eps_f32 * smax near s ~ 1 —
      SVD of Y delivers exactly that (backward error eps * ||Y||, i.e.
      condition kappa(Y)), and its left singular vectors are orthonormal to
      machine precision even for noise-level directions, whose weights
      vanish as l -> 0.  Measured f32 map error vs f64: 3e-5 at
      kappa(Y) ~ 1e4, 7e-4 at 1e5 (CPU study, 2026-08).
    - ``"eigh"``: eigh of the Gram Y^T Y — one 33x33 eigh instead of a thin
      SVD (cheaper per step), but the Gram SQUARES the
      condition number: above kappa(Y) ~ 1e4 (reg x score scales early in
      aggressive schedules on stiff targets) the f32 spectrum near l ~ 1 is
      unresolved and the per-direction contraction goes wrong by O(1e-1) —
      the covariance still converges in dominant directions but the MEAN
      stalls (observed in f32 at D=256 on ``dense_gaussian``).  Use only
      for moderately-conditioned targets or small regularizers.
    """
    b, d = eps.shape
    with jax.default_matmul_precision("float32"):
        dtype = f.dtype
        r1 = reg / (1.0 + reg)
        epsbar = jnp.mean(eps, axis=0)
        gbar = jnp.mean(vs, axis=0)
        gd = vs - gbar
        ed = eps - epsbar

        # V = F (I + Om Om^T) F^T in factor coordinates.
        om = jnp.concatenate(
            [jnp.sqrt(reg / b) * ed.T, -jnp.sqrt(r1) * epsbar[:, None]],
            axis=1)                                     # (D, B+1)
        # U = FU FU^T exactly (ops/bam.py:176-179).
        fu = jnp.concatenate(
            [jnp.sqrt(reg / b) * gd.T, jnp.sqrt(r1) * gbar[:, None]],
            axis=1)                                     # (D, B+1)

        # ---- middle factor via the SIMILARITY form: no subtraction --------
        # BaM's exact solution S = 2 Lv (I + sqrt(I + 4 Lv^T U Lv))^{-1} Lv^T
        # holds for ANY square factor Lv of V (ops/bam.py docstring).  With
        # Lv = F W1 where W1 is the stable PSD-update factor of I + Om Om^T,
        #     W1 = I + Om Cu Om^T,  Cu = ((I + Om^T Om)^{1/2} + I)^{-1},
        # the inner matrix is I + 4 Y Y^T with Y = W1^T Q, Q = F^T FU — an
        # identity-plus-PSD-low-rank whose "inverse-of-one-plus-sqrt" is a
        # per-eigenvalue CONTRACTION:
        #     M = W1 (I + Y T Y^T)(I + Y T Y^T)^T W1^T,  T = E tau(lmb) E^T,
        #     tau(l) = -4 / ((1+sqrt(1+4l))^2 (1+sqrt(sigma))),
        #     sigma(l) = 2/(1+sqrt(1+4l)) in (0, 1].
        # tau is regular at l=0 and bounded, so f32 noise in the small
        # eigenvalues of G~ = Y^T Y is self-damped (|Y e_i|^2 = l_i).  No
        # downdate, no cancellation; S is PD by construction, so ``good``
        # only screens non-finite arithmetic.
        q = f.T @ fu                                    # (D, B+1)
        k1 = q.shape[-1]
        eye_k = jnp.eye(k1, dtype=dtype)
        gu = om.T @ om                                  # (B+1, B+1) PSD
        cu, _ = _update_corr(gu, newton_iters)
        omq = om.T @ q
        y = q + om @ (cu @ omq)                         # W1^T Q  (D, B+1)
        def _svd_solve(_):
            # Thin SVD of Y: s resolved to ~eps*smax ADDITIVELY (kappa, not
            # kappa^2) and u orthonormal to machine precision — noise-level
            # directions get weights -> 0, so f32 damage is self-damped.
            u_y, s_y, _ = jnp.linalg.svd(y, full_matrices=False)
            return u_y, s_y * s_y, jnp.isfinite(s_y[0])

        def _eigh_solve(gy):
            # Normalized eigh + reconstruction gate: the Gram's norm scales
            # like reg^2 x score^2 (1e10+ early in aggressive schedules) and
            # an f32 eigh can lose the spectrum there (measured
            # reconstruction error 4e-3 vs ~1e-5 on CPU) — accepted-but-
            # wrong steps then wreck the MEAN while reg is still large.
            # Rejecting on the residual keeps the state until the decaying
            # schedule re-enters the computable range (the reference needs
            # x64 for exactly this regime).
            gnorm = jnp.sqrt(jnp.sum(gy * gy)) + jnp.asarray(1e-30, dtype)
            lmb_n, ev = jnp.linalg.eigh(gy / gnorm)
            lmb = lmb_n * gnorm
            recon = (ev * lmb_n) @ ev.T - gy / gnorm
            eigh_ok = jnp.sum(recon * recon) < jnp.asarray(4e-6, dtype)
            lmax = jnp.maximum(lmb[-1], 0.0)
            eps_m = jnp.asarray(jnp.finfo(dtype).eps, dtype)
            lc = jnp.maximum(lmb, eps_m * lmax + jnp.asarray(1e-30, dtype))
            # Unit columns by construction; exactly orthonormal at working
            # precision for resolved eigenvalues, and the eps*lmax clamp
            # caps the column norm of noise directions.
            ytil = (y @ ev) * jax.lax.rsqrt(lc)         # (D, B+1) unit cols
            return ytil, lmb, eigh_ok

        if solver == "svd":
            ytil, lmb, eigh_ok = _svd_solve(None)
        elif solver == "eigh":
            gy = y.T @ y                                # (B+1, B+1) PSD
            ytil, lmb, eigh_ok = _eigh_solve(0.5 * (gy + gy.T))
        elif d < k1:
            # Thin SVD yields min(D, B+1) columns; below that the cond
            # branches cannot share an output shape — SVD is also the
            # accurate choice, so take it unconditionally.
            ytil, lmb, eigh_ok = _svd_solve(None)
        else:  # "auto": conditioning-gated per-step routing
            gy = y.T @ y
            gy = 0.5 * (gy + gy.T)
            # Row-sum norm >= lmax(Gram) = smax(Y)^2; the Gram eigh keeps
            # the l ~ 1 region resolved while eps(dtype) * lmax <= ~1e-3
            # (absolute spectrum perturbation of the f32/f64 Gram) — above
            # that, route to the thin SVD of Y (kappa-accurate).
            lmax_ub = jnp.max(jnp.sum(jnp.abs(gy), axis=-1))
            thresh = jnp.asarray(1e-3 / jnp.finfo(dtype).eps, dtype)
            ytil, lmb, eigh_ok = jax.lax.cond(
                lmax_ub > thresh, _svd_solve,
                lambda _: _eigh_solve(gy), None)
        lmb = jnp.maximum(lmb, 0.0)
        sigma = 2.0 / (1.0 + jnp.sqrt(1.0 + 4.0 * lmb))
        # Contraction weights in (-1, 0] on a ~unit-column basis: the
        # correction can never inflate by the raw ||Y||^2 ~ reg^2 factor
        # that the unnormalized form exposes.
        wdiag = jnp.sqrt(sigma) - 1.0                   # in (-1, 0]
        # F' = F W1 (I + Yt diag(w) Yt^T)
        fw1 = f + (f @ om) @ (cu @ om.T)                # F W1
        fwy = fw1 @ ytil
        f_new = fw1 + (fwy * wdiag) @ ytil.T
        # Validity: exact arithmetic gives S' PD with S' <= V always, so
        # tr(S') = ||F'||_F^2 <= ||F W1||_F^2 = tr(V) is a sharp detector of
        # numerical loss (large reg x large score scales — the regime where
        # the reference itself requires x64, examples/example_bam.py:14-15).
        # Reject and let the fitter resample/keep state; decaying reg
        # schedules re-enter the computable regime.
        tr_new = jnp.sum(f_new * f_new)
        tr_v = jnp.sum(fw1 * fw1)
        good = (jnp.isfinite(tr_new) & (tr_new <= 1.05 * tr_v + 1e-6)
                & eigh_ok)

        # mu = mu0/(1+reg) + r1 (S gbar + xbar) with S = F' F'^T (the guarded
        # factor), so the mean inherits the bound the guard enforces.
        s_gbar = f_new @ (f_new.T @ gbar)
        xbar = mean + epsbar @ f.T
        mean_new = mean / (1.0 + reg) + r1 * (s_gbar + xbar)
        return mean_new, f_new, good


def apply_bam_eps_step(state_mean, state_f, eps, vs, reg,
                       newton_iters: int = 20, solver: str = "auto"):
    """Proposal + select: keeps the old (mean, F) when the proposal fails
    its exact PD check (replaces the reference's host jitter/retry loop,
    ``gsmvi/bam.py:188-206``, for the non-retry path).  No jitter parameter:
    this route's proposal is PD by construction, so there is nothing to
    regularize — the PD flag only screens numerical loss."""
    mean_new, f_new, good = bam_eps_update(eps, vs, state_mean, state_f, reg,
                                           newton_iters, solver)
    mean = jnp.where(good, mean_new, state_mean)
    f = jnp.where(good, f_new, state_f)
    return mean, f, good
