"""Eps-coordinate factorized GSM update (ops/gsm_eps.py).

The update must be *algebraically identical* to the dense GSM update
(ops/gsm.py, itself pinned to the reference kernel in
tests/test_reference_parity.py): for any square factor F with S = F F^T and
samples x = mu + eps F^T, the proposed F' must satisfy F' F'^T = S' where
(mu', S') is the dense proposal — and the ``good`` flag must equal the exact
positive-definiteness of S'.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsmvi_jax.ops.gsm import gsm_update_stats
from gsmvi_jax.ops.gsm_eps import (apply_eps_step, eps_core,
                                   gsm_eps_factor_update)


@pytest.mark.parametrize("b,d", [(2, 5), (8, 16), (32, 64), (32, 256),
                                 (40, 16)])  # includes 2B > D (rank-deficient)
def test_matches_dense_update_f64(rng, b, d):
    f = 0.3 * rng.normal(size=(d, d)) + np.eye(d)   # general square factor
    mu = rng.normal(size=d)
    eps = rng.normal(size=(b, d))
    x = mu + eps @ f.T
    v = 0.3 * rng.normal(size=(b, d))
    s0 = f @ f.T

    dmu, ds = gsm_update_stats(jnp.asarray(x), jnp.asarray(v),
                               jnp.asarray(mu), jnp.asarray(s0))
    m_e, f_e, good = gsm_eps_factor_update(jnp.asarray(eps), jnp.asarray(v),
                                           jnp.asarray(mu), jnp.asarray(f))
    assert bool(good)
    np.testing.assert_allclose(np.asarray(m_e), np.asarray(mu + dmu),
                               rtol=1e-12, atol=1e-12)
    s_dense = np.asarray(s0 + ds)
    s_eps = np.asarray(f_e @ f_e.T)
    scale = max(1.0, float(np.abs(s_dense).max()))
    np.testing.assert_allclose(s_eps, s_dense, atol=5e-11 * scale)


def test_pd_flag_flips_exactly_at_boundary(rng):
    """good must equal PD(I + Z J Z^T) — probe across the boundary with a
    scaled synthetic downdate."""
    b, d = 4, 16
    base = 0.3 * rng.normal(size=(2 * b, d))
    for scale in [0.5, 1.0, 2.0, 8.0]:
        zt = base.copy()
        zt[b:] *= scale
        m = np.eye(d) + zt[:b].T @ zt[:b] - zt[b:].T @ zt[b:]
        pd_true = bool(np.all(np.linalg.eigvalsh(0.5 * (m + m.T)) > 0))
        s2, good = eps_core(jnp.asarray(zt), b, jitter=1e-12)
        assert bool(good) == pd_true, f"scale={scale}"
        if pd_true:
            w = np.eye(d) + zt.T @ np.asarray(s2) @ zt
            np.testing.assert_allclose(w @ w.T, m, atol=1e-10)


def test_apply_eps_step_reverts_on_violation(rng):
    """A non-PD proposal must leave (mean, F) unchanged."""
    b, d = 4, 8
    f = jnp.eye(d)
    mu = jnp.zeros(d)
    eps = jnp.asarray(rng.normal(size=(b, d)))
    # Huge adversarial "scores" rarely break PD for real GSM updates, so
    # bypass the physics: call apply_eps_step with scores engineered to give
    # a big downdate by scaling. If the proposal stays PD the step must be
    # accepted and finite anyway.
    vs = jnp.asarray(300.0 * rng.normal(size=(b, d)))
    mean, f_new, good = apply_eps_step(mu, f, eps, vs)
    if bool(good):
        assert np.isfinite(np.asarray(f_new)).all()
    else:
        np.testing.assert_array_equal(np.asarray(f_new), np.asarray(f))
        np.testing.assert_array_equal(np.asarray(mean), np.asarray(mu))


def test_f32_accuracy(rng):
    """f32 path (the device dtype): proposal matches dense to f32 tolerance."""
    b, d = 32, 128
    f = (0.3 * rng.normal(size=(d, d)) + np.eye(d)).astype(np.float32)
    mu = rng.normal(size=d).astype(np.float32)
    eps = rng.normal(size=(b, d)).astype(np.float32)
    x = mu + eps @ f.T
    v = (0.3 * rng.normal(size=(b, d))).astype(np.float32)
    s0 = f @ f.T
    dmu, ds = gsm_update_stats(jnp.asarray(x), jnp.asarray(v),
                               jnp.asarray(mu), jnp.asarray(s0))
    m_e, f_e, good = gsm_eps_factor_update(jnp.asarray(eps), jnp.asarray(v),
                                           jnp.asarray(mu), jnp.asarray(f))
    assert bool(good)
    s_dense = np.asarray(s0 + np.asarray(ds))
    s_eps = np.asarray(f_e @ f_e.T)
    scale = max(1.0, float(np.abs(s_dense).max()))
    np.testing.assert_allclose(s_eps, s_dense, atol=2e-4 * scale)


def test_fitter_end_to_end_recovery():
    from gsmvi_jax import FactorGSM
    from gsmvi_jax.models import dense_gaussian

    t = dense_gaussian(jax.random.PRNGKey(3), 24)
    fg = FactorGSM(D=t.d, lp=t.lp, lp_g=t.lp_g)  # method="eps" default
    state = fg.fit(jax.random.PRNGKey(0), niter=800, batch_size=16,
                   verbose=False, return_state=True)
    assert int(state.n_accepted) == int(state.step)
    np.testing.assert_allclose(np.asarray(state.mean), np.asarray(t.mean),
                               atol=0.02)
    np.testing.assert_allclose(np.asarray(state.cov), np.asarray(t.cov),
                               atol=0.05)
