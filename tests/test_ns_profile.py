"""Batch-aware Newton-Schulz profile (round 5).

The shipped (5,4,6,7,4) profile was tuned at B=32; at B >= 64 the (B, B)
small-space Grams' spectra widen and the short chains go SILENTLY biased
(zero gate rejections — the documented failure mode).  Measured CPU study
(D=256): converged cov_err 0.012/0.049/0.21 at
B=64/128/512 with the short profile vs 2e-4/1.9e-4/3.7e-3 with the long
(8,6,9,10,6) — matching the exact Cholesky eps path.  The default NS
profile is therefore batch-resolved (``ns_iters_for_batch``).
"""

import jax
import jax.numpy as jnp
import numpy as np

from gsmvi_jax import FactorGSM
from gsmvi_jax.models import dense_gaussian
from gsmvi_jax.ops.gsm_eps import apply_eps_step
from gsmvi_jax.ops.gsm_eps_ns import (NS_ITERS_DEFAULT, NS_ITERS_LARGE_B,
                                      gsm_eps_update_ns_xla,
                                      ns_iters_for_batch)


def test_ns_iters_for_batch_resolution():
    assert ns_iters_for_batch(2) == NS_ITERS_DEFAULT
    assert ns_iters_for_batch(32) == NS_ITERS_DEFAULT
    assert ns_iters_for_batch(64) == NS_ITERS_LARGE_B
    assert ns_iters_for_batch(512) == NS_ITERS_LARGE_B
    assert ns_iters_for_batch(64, (1, 2, 3, 4, 5)) == (1, 2, 3, 4, 5)


def test_factorgsm_resolves_profile_per_batch():
    t = dense_gaussian(jax.random.PRNGKey(1), 16)
    g = FactorGSM(D=16, lp=t.lp, lp_g=t.lp_g)
    assert g._iters(8) == NS_ITERS_DEFAULT
    assert g._iters(64) == NS_ITERS_LARGE_B
    g2 = FactorGSM(D=16, lp=t.lp, lp_g=t.lp_g, ns_iters=(9, 9, 9, 9, 9))
    assert g2._iters(64) == (9, 9, 9, 9, 9)


def test_large_batch_ns_matches_chol_eps_converged():
    """D=64, B=64 (the smallest silently-biased point of the study): the
    auto (long) NS profile must land within MC noise of the exact chol eps
    path, while the short profile's bias is measurably larger."""
    d, b, niter = 64, 64, 1200
    t = dense_gaussian(jax.random.PRNGKey(3), d, scale=0.5)
    cs = float(np.abs(np.asarray(t.cov)).max())

    def fit(update):
        mu = jnp.zeros(d, jnp.float32)
        f = jnp.eye(d, dtype=jnp.float32)

        @jax.jit
        def step(carry, _):
            mu, f, k = carry
            k, ks = jax.random.split(k)
            eps = jax.random.normal(ks, (b, d), jnp.float32)
            with jax.default_matmul_precision("float32"):
                ef = eps @ f.T
                vs = t.lp_g(mu + ef).astype(jnp.float32)
                mu2, f2, _ = update(eps, vs, mu, f, ef)
            return (mu2, f2, k), None

        (mu, f, _), _ = jax.lax.scan(step, (mu, f, jax.random.PRNGKey(0)),
                                     None, length=niter)
        cov = f @ f.T
        return float(np.max(np.abs(np.asarray(cov) - np.asarray(t.cov))) / cs)

    err_chol = fit(lambda e, v, m, f, ef: apply_eps_step(m, f, e, v))
    err_auto = fit(lambda e, v, m, f, ef: gsm_eps_update_ns_xla(
        e, v, m, f, ef_t=ef, iters=ns_iters_for_batch(b)))
    err_short = fit(lambda e, v, m, f, ef: gsm_eps_update_ns_xla(
        e, v, m, f, ef_t=ef, iters=NS_ITERS_DEFAULT))
    assert err_auto < 2.0 * err_chol + 1e-3
    assert err_short > 3.0 * err_auto
