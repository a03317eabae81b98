"""GSM's factor-route delegation (mirrors BaM's): with ``use_factor=True``
and a traceable lp_g, ``GSM.fit`` runs the FactorGSM eps algebra (identical
math, no per-step D x D Cholesky) while keeping the dense VIState surface.
``use_factor="auto"`` keeps the dense path on every platform."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsmvi_jax import GSM, FactorGSM
from gsmvi_jax.models import dense_gaussian
from gsmvi_jax.state import VIState


@pytest.fixture
def target():
    return dense_gaussian(jax.random.PRNGKey(7), 6, scale=0.5)


def _factor_gsm(t, **kw):
    kw.setdefault("use_factor", True)
    return GSM(D=t.d, lp=t.lp, lp_g=t.lp_g, **kw)


def test_use_factor_true_matches_factorgsm(target):
    t = target
    g = _factor_gsm(t)
    assert g._factor_route(True, 8)
    m, c = g.fit(jax.random.PRNGKey(0), niter=400, batch_size=8,
                 verbose=False)
    fg = FactorGSM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    m2, c2 = fg.fit(jax.random.PRNGKey(0), niter=400, batch_size=8,
                    verbose=False)
    # Same key, same route underneath: trajectories coincide exactly.
    np.testing.assert_array_equal(np.asarray(m), np.asarray(m2))
    np.testing.assert_allclose(np.asarray(c), np.asarray(c2), atol=1e-6)
    # And the fit recovers the target.
    assert float(np.max(np.abs(np.asarray(m) - np.asarray(t.mean)))) < 0.05
    assert float(np.max(np.abs(np.asarray(c) - np.asarray(t.cov)))) < 0.1


def test_auto_keeps_dense_path(target):
    t = target
    g = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    assert not g._factor_route(True, 8)  # "auto": dense on every platform


def test_use_factor_true_forces_route_anywhere(target):
    t = target
    g = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g, use_factor=True)
    assert g._factor_route(True, 8)
    m, c = g.fit(jax.random.PRNGKey(0), niter=400, batch_size=8,
                 verbose=False)
    assert float(np.max(np.abs(np.asarray(m) - np.asarray(t.mean)))) < 0.05


def test_use_factor_false_keeps_dense_trajectory(target):
    t = target
    g_dense = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    m_ref, c_ref = g_dense.fit(jax.random.PRNGKey(0), niter=100,
                               batch_size=8, verbose=False)
    g = _factor_gsm(t, use_factor=False)
    assert not g._factor_route(True, 8)
    m, c = g.fit(jax.random.PRNGKey(0), niter=100, batch_size=8,
                 verbose=False)
    # Same dense step on both sides: bitwise trajectory.
    np.testing.assert_array_equal(np.asarray(m), np.asarray(m_ref))
    np.testing.assert_array_equal(np.asarray(c), np.asarray(c_ref))


def test_sharded_sigma_configs_keep_dense_path(target):
    """cov_sharding/chol_block describe a partitioned DENSE covariance; the
    factor route cannot honor them and must not engage."""
    t = target
    g = _factor_gsm(t, chol_block=2)
    with pytest.warns(UserWarning, match="cov_sharding/chol_block"):
        assert not g._factor_route(True, 8)


def test_return_state_is_vistate_with_consistent_chol(target):
    t = target
    g = _factor_gsm(t)
    st = g.fit(jax.random.PRNGKey(0), niter=60, batch_size=8,
               verbose=False, return_state=True)
    assert isinstance(st, VIState)
    assert int(st.step) == 61
    assert int(st.n_accepted) + int(st.n_rejected) == 61
    np.testing.assert_allclose(np.asarray(st.chol @ st.chol.T),
                               np.asarray(st.cov), atol=1e-6)


def test_state_resume_continues_fit(target):
    """Warm-starting from a returned VIState continues converging (the
    factor handed over is the state's Cholesky — same distribution; the
    resumed eps draws multiply a different-but-valid factor, so this is a
    distributional resume, not a bitwise one — documented)."""
    t = target
    g = _factor_gsm(t)
    st = g.fit(jax.random.PRNGKey(0), niter=200, batch_size=8,
               verbose=False, return_state=True)
    st2 = g.fit(jax.random.PRNGKey(1), niter=200, batch_size=8,
                verbose=False, state=st, return_state=True)
    assert int(st2.step) == 402
    m, c = np.asarray(st2.mean), np.asarray(st2.cov)
    assert float(np.max(np.abs(m - np.asarray(t.mean)))) < 0.05
    assert float(np.max(np.abs(c - np.asarray(t.cov)))) < 0.1


def test_numpy_lp_g_still_uses_dense_eager_path(target):
    """Non-traceable callables must keep the dense eager loop (the factor
    route requires tracing)."""
    t = target

    def lp_g_np(x):
        return np.asarray(t.lp_g(jnp.asarray(np.asarray(x))))

    g = _factor_gsm(t)
    g.lp_g = lambda x: lp_g_np(np.asarray(x))  # numpy in/out
    with pytest.warns(UserWarning, match="not jax-traceable"):
        m, c = g.fit(jax.random.PRNGKey(0), niter=60, batch_size=8,
                     verbose=False)
    assert np.all(np.isfinite(np.asarray(m)))


def test_huge_batch_keeps_dense_path(target):
    """B >= 128 with 2B > D keeps the dense route (the rank-2B eps small
    space is then no smaller than the dense problem); use_factor=True warns.
    Small-B configs are unaffected."""
    t = target
    g = _factor_gsm(t)
    assert g._factor_route(True, 8)            # small B: factor route
    with pytest.warns(UserWarning, match="2\\*batch_size > D"):
        assert not g._factor_route(True, 128)  # 2*128 > 6, B >= 128: dense
    big = _factor_gsm(t)
    big.D = 1024
    assert big._factor_route(True, 128)        # 2B=256 <= 1024: factor
