"""Factorized (Cholesky-free) GSM: exactness vs dense path, e2e recovery,
inverse-consistency over long runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsmvi_jax import FactorGSM, GSM
from gsmvi_jax.models import dense_gaussian, ill_conditioned_gaussian
from gsmvi_jax.ops.gsm import gsm_update_stats
from gsmvi_jax.ops.gsm_factor import (factor_gsm_step_stats, factor_refresh,
                                      factor_to_cov)


def test_single_step_matches_dense(rng):
    d, b = 10, 4
    mu0 = rng.normal(size=d)
    l = 0.4 * rng.normal(size=(d, d))
    s0 = l @ l.T + np.eye(d)
    f = np.linalg.cholesky(s0)
    finv = np.linalg.inv(f)
    x = rng.normal(size=(b, d))
    v = 0.3 * rng.normal(size=(b, d))
    dmu_ref, ds_ref = gsm_update_stats(x, v, mu0, s0)
    dmu, fn, finvn, good = factor_gsm_step_stats(x, v, mu0, f, finv)
    assert bool(good)
    np.testing.assert_allclose(dmu, dmu_ref, atol=1e-12)
    np.testing.assert_allclose(factor_to_cov(fn), s0 + np.asarray(ds_ref),
                               atol=1e-11)
    np.testing.assert_allclose(finvn @ fn, np.eye(d), atol=1e-11)


def test_pd_violation_detected(rng):
    """A score pushing the covariance indefinite must flag good=False."""
    d, b = 4, 1
    mu0 = np.zeros(d)
    f = np.eye(d)
    x = np.ones((b, d))
    v = 100.0 * np.ones((b, d))  # huge score -> wild update
    _, _, _, good = factor_gsm_step_stats(x, v, mu0, f, f)
    dmu, ds = gsm_update_stats(x, v, mu0, np.eye(d))
    dense_pd = np.all(np.linalg.eigvalsh(np.eye(d) + np.asarray(ds)) > 0)
    assert bool(good) == bool(dense_pd)


def test_e2e_recovery():
    t = dense_gaussian(jax.random.PRNGKey(3), 10)
    fg = FactorGSM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    mean, cov = fg.fit(jax.random.PRNGKey(99), niter=500, batch_size=8,
                       verbose=False)
    np.testing.assert_allclose(mean, t.mean, atol=1e-3)
    np.testing.assert_allclose(cov, t.cov, atol=1e-2)


def test_first_step_matches_dense_gsm():
    """With cov=I the first sampling factor coincides (chol(I)=I=factor), so
    the first update must agree exactly; afterwards the two paths use
    different (equally valid) square roots and only agree in distribution."""
    t = dense_gaussian(jax.random.PRNGKey(3), 8)
    kw = dict(niter=0, batch_size=4, verbose=False)
    m1, c1 = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g).fit(jax.random.PRNGKey(5), **kw)
    m2, c2 = FactorGSM(D=t.d, lp=t.lp, lp_g=t.lp_g).fit(
        jax.random.PRNGKey(5), **kw)
    np.testing.assert_allclose(m1, m2, atol=1e-10)
    np.testing.assert_allclose(c1, c2, atol=1e-10)


def test_distributionally_equivalent_to_dense_gsm():
    """Both fitters converge to the same target moments."""
    t = dense_gaussian(jax.random.PRNGKey(3), 8)
    kw = dict(niter=400, batch_size=16, verbose=False)
    m1, c1 = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g).fit(jax.random.PRNGKey(5), **kw)
    m2, c2 = FactorGSM(D=t.d, lp=t.lp, lp_g=t.lp_g).fit(
        jax.random.PRNGKey(5), **kw)
    np.testing.assert_allclose(m1, m2, atol=1e-2)
    np.testing.assert_allclose(c1, c2, atol=0.05)


def test_long_run_consistency_with_refresh():
    # refresh/finv semantics apply to the finv-maintaining methods; the
    # default "eps" method has no inverse to drift.
    t = ill_conditioned_gaussian(jax.random.PRNGKey(4), 12, 1e3)
    fg = FactorGSM(D=t.d, lp=t.lp, lp_g=t.lp_g, refresh_every=200,
                   method="twophase")
    state = fg.fit(jax.random.PRNGKey(0), niter=1500, batch_size=16,
                   verbose=False, return_state=True)
    finv_err = float(jnp.abs(state.finv @ state.factor
                             - jnp.eye(t.d)).max())
    assert finv_err < 1e-6
    np.testing.assert_allclose(state.mean, t.mean, atol=0.05)


def test_warm_start_from_cov():
    t = dense_gaussian(jax.random.PRNGKey(3), 6)
    fg = FactorGSM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    mean, cov = fg.fit(jax.random.PRNGKey(0), mean=t.mean, cov=t.cov,
                       niter=50, batch_size=16, verbose=False)
    np.testing.assert_allclose(mean, t.mean, atol=5e-3)


def test_rejects_numpy_lp_g():
    with pytest.raises(TypeError):
        FactorGSM(D=3, lp=None,
                  lp_g=lambda x: np.asarray(x)).fit(jax.random.PRNGKey(0),
                                                    niter=1, verbose=False)


def test_factor_refresh_tightens():
    rng = np.random.default_rng(0)
    f = np.linalg.cholesky(np.eye(5) + 0.3 * np.ones((5, 5)))
    finv_bad = np.linalg.inv(f) + 1e-4 * rng.normal(size=(5, 5))
    finv = factor_refresh(jnp.asarray(f), jnp.asarray(finv_bad), 3)
    assert float(jnp.abs(finv @ f - jnp.eye(5)).max()) < 1e-12


class TestTwoPhase:
    """v2 (two-phase update/downdate, QR-free) factor step."""

    def test_single_step_exact(self, rng):
        from gsmvi_jax.ops.gsm_factor import factor_gsm_step_stats_v2

        d, b = 10, 4
        mu0 = rng.normal(size=d)
        l = 0.4 * rng.normal(size=(d, d))
        s0 = l @ l.T + np.eye(d)
        f = np.linalg.cholesky(s0)
        finv = np.linalg.inv(f)
        x = rng.normal(size=(b, d))
        v = 0.3 * rng.normal(size=(b, d))
        dmu_ref, ds_ref = gsm_update_stats(x, v, mu0, s0)
        dmu, fn, finvn, good = factor_gsm_step_stats_v2(x, v, mu0, f, finv,
                                                        newton_iters=25)
        assert bool(good)
        np.testing.assert_allclose(dmu, dmu_ref, atol=1e-11)
        np.testing.assert_allclose(factor_to_cov(fn), s0 + np.asarray(ds_ref),
                                   atol=1e-10)
        np.testing.assert_allclose(finvn @ fn, np.eye(d), atol=1e-10)

    def test_wide_batch(self, rng):
        """2B > D regime (the one that broke the G^{-1/2} formulation)."""
        from gsmvi_jax.ops.gsm_factor import factor_gsm_step_stats_v2

        d, b = 6, 16
        mu0 = rng.normal(size=d)
        s0 = np.eye(d)
        x = rng.normal(size=(b, d))
        v = 0.2 * rng.normal(size=(b, d))
        dmu_ref, ds_ref = gsm_update_stats(x, v, mu0, s0)
        dmu, fn, _, good = factor_gsm_step_stats_v2(
            x, v, mu0, np.eye(d), np.eye(d), newton_iters=25)
        assert bool(good)
        np.testing.assert_allclose(factor_to_cov(fn), s0 + np.asarray(ds_ref),
                                   atol=1e-10)

    def test_e2e_recovery(self):
        t = dense_gaussian(jax.random.PRNGKey(3), 10)
        fg = FactorGSM(D=t.d, lp=t.lp, lp_g=t.lp_g, method="twophase")
        mean, cov = fg.fit(jax.random.PRNGKey(99), niter=500, batch_size=8,
                           verbose=False)
        np.testing.assert_allclose(mean, t.mean, atol=1e-3)
        np.testing.assert_allclose(cov, t.cov, atol=1e-2)

    def test_downdate_pd_violation_detected(self, rng):
        from gsmvi_jax.ops.gsm_factor import factor_gsm_step_stats_v2

        d, b = 4, 1
        mu0 = np.zeros(d)
        x = np.ones((b, d))
        v = 100.0 * np.ones((b, d))
        _, _, _, good = factor_gsm_step_stats_v2(
            x, v, mu0, np.eye(d), np.eye(d))
        dmu, ds = gsm_update_stats(x, v, mu0, np.eye(d))
        dense_pd = np.all(np.linalg.eigvalsh(np.eye(d) + np.asarray(ds)) > 0)
        assert bool(good) == bool(dense_pd)
