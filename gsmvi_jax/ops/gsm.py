"""Fused GSM (Gaussian Score Matching) update — the math core.

Implements the closed-form variational update of arXiv:2307.07849, matching the
behavior of the reference kernels ``_gsm_update_single`` / ``gsm_update``
(reference ``gsmvi/gsm.py:7-58``) but with a different, matmul-shaped formulation:

The reference vmaps a per-sample function that materializes two D x D outer
products per sample — O(B * D^2) *memory* — and then mean-reduces the stack.
Here the whole batch update is expressed as three (B,D)-by-(D,D)-shaped
matmuls plus rowwise vector arithmetic:

    a_b   = mu0 - x_b                       (B,D)
    t_b   = S0 v_b            -> T = V @ S0 (one matmul; S0 symmetric)
    vSv_b = <v_b, t_b>,  mv_b = <a_b, v_b>  (rowwise reductions)
    rho_b = 0.5 (sqrt(1 + 4 (vSv_b + mv_b^2)) - 1)
    eps_b = t_b - a_b
    dmu_b = (eps_b - a_b <v_b, eps_b> / (1 + rho_b + mv_b)) / (1 + rho_b)
    mu    = mu0 + mean_b dmu_b
    S     = S0 + (A^T A - Bm^T Bm) / B      with rows a_b and b_b = a_b + dmu_b

The covariance delta ``mean_b [a a^T - b b^T]`` collapses to two Gram matrices
(`A^T A`, `Bm^T Bm`) — O(D^2) memory, 4*B*D^2 FLOPs of matmul — followed by a
cheap explicit symmetrization so the returned covariance is *exactly*
symmetric under any gemm schedule, unlike the reference whose covariance
slowly loses symmetry.

The algebraic identity with the reference's per-sample form is exact; see
tests/test_gsm_kernel.py which checks agreement against an independent
straight-from-the-paper implementation to ~1e-6 (f32) / 1e-12 (f64).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def gsm_update_stats(samples, vs, mu0, S0):
    """Per-batch GSM deltas: returns (dmu, dS) with mu = mu0 + dmu, S = S0 + dS.

    samples, vs: (B, D); mu0: (D,); S0: (D, D).
    """
    b = samples.shape[0]
    # f32 matmuls may default to reduced precision (TF32 on NVIDIA GPUs);
    # the covariance recursion is sensitive to that, so pin true-f32.
    with jax.default_matmul_precision("float32"):
        return _gsm_update_stats_impl(samples, vs, mu0, S0, b)


def _gsm_update_stats_impl(samples, vs, mu0, S0, b):
    a = mu0 - samples                                   # (B, D)
    t = vs @ S0                                         # (B, D): rows S0 @ v_b
    vsv = jnp.sum(vs * t, axis=-1)                      # (B,)
    mv = jnp.sum(a * vs, axis=-1)                       # (B,)
    rho = 0.5 * (jnp.sqrt(1.0 + 4.0 * (vsv + mv * mv)) - 1.0)
    eps0 = t - a                                        # (B, D)
    w = jnp.sum(vs * eps0, axis=-1)                     # (B,)
    den = 1.0 + rho + mv
    dmu_b = (eps0 - a * (w / den)[:, None]) / (1.0 + rho)[:, None]
    bm = a + dmu_b                                      # rows mu_b - x_b
    dmu = jnp.mean(dmu_b, axis=0)
    gram_a = jnp.matmul(a.T, a, preferred_element_type=S0.dtype)
    gram_b = jnp.matmul(bm.T, bm, preferred_element_type=S0.dtype)
    ds = (gram_a - gram_b) / b
    ds = 0.5 * (ds + ds.T)  # exact symmetry under any gemm schedule
    return dmu, ds


@jax.jit
def gsm_update(samples, vs, mu0, S0):
    """Batched GSM update; drop-in for the reference ``gsm_update``.

    Inputs:
      samples: (B, D) draws from the current q = N(mu0, S0)
      vs:      (B, D) target scores grad log p at the samples
      mu0:     (D,)   current mean
      S0:      (D, D) current covariance
    Returns (mu, S): updated mean and covariance.

    API parity with reference ``gsmvi/gsm.py:31-58``; internals are the fused
    Gram-matrix formulation documented in the module docstring.
    """
    if samples.ndim != 2 or vs.ndim != 2:
        raise ValueError("samples and vs must be (batch, dim) arrays")
    dmu, ds = gsm_update_stats(samples, vs, mu0, S0)
    return mu0 + dmu, S0 + ds


@partial(jax.jit, static_argnums=(4,))
def gsm_update_lowmem(samples, vs, mu0, S0, block: int = 1024):
    """GSM update that streams the Gram reduction in sample blocks.

    For very large Monte-Carlo batches this bounds live memory for the (B, D)
    intermediates; results are identical to ``gsm_update`` up to summation
    order.  ``block`` must be static.
    """
    b = samples.shape[0]
    if b <= block:
        return gsm_update(samples, vs, mu0, S0)
    nblk = -(-b // block)
    pad = nblk * block - b
    samples_p = jnp.pad(samples, ((0, pad), (0, 0)))
    vs_p = jnp.pad(vs, ((0, pad), (0, 0)))
    mask = jnp.pad(jnp.ones((b,), samples.dtype), (0, pad))

    def body(carry, xs):
        dmu_acc, ds_acc = carry
        x_blk, v_blk, m_blk = xs
        # Mask padded rows: zero scores and samples at mu0 give zero deltas.
        x_blk = jnp.where(m_blk[:, None] > 0, x_blk, mu0)
        v_blk = v_blk * m_blk[:, None]
        dmu_i, ds_i = gsm_update_stats(x_blk, v_blk, mu0, S0)
        return (dmu_acc + dmu_i * block, ds_acc + ds_i * block), None

    init = (jnp.zeros_like(mu0), jnp.zeros_like(S0))
    (dmu_sum, ds_sum), _ = jax.lax.scan(
        body,
        init,
        (
            samples_p.reshape(nblk, block, -1),
            vs_p.reshape(nblk, block, -1),
            mask.reshape(nblk, block),
        ),
    )
    return mu0 + dmu_sum / b, S0 + ds_sum / b
