"""BaM's factor-route delegation: with ``use_factor=True`` and a traceable
lp_g, ``BaM.fit`` runs the FactorBaM eps algebra (identical math, no D x D
factorizations) while keeping the dense VIState surface.
``use_factor="auto"`` keeps the dense path on every platform."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsmvi_jax import BaM, FactorBaM, Regularizers
from gsmvi_jax.models import dense_gaussian
from gsmvi_jax.state import VIState


@pytest.fixture
def target():
    return dense_gaussian(jax.random.PRNGKey(7), 6, scale=0.5)


def _factor_bam(t, **kw):
    kw.setdefault("use_factor", True)
    return BaM(D=t.d, lp=t.lp, lp_g=t.lp_g, **kw)


def test_use_factor_true_matches_factorbam(target):
    t = target
    g = _factor_bam(t)
    assert g._factor_route(True)
    regf = Regularizers().linear(20.0)
    m, c = g.fit(jax.random.PRNGKey(0), regf=regf, niter=300, batch_size=8,
                 verbose=False, retries=2)
    fb = FactorBaM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    m2, c2 = fb.fit(jax.random.PRNGKey(0), regf=regf, niter=300,
                    batch_size=8, verbose=False, retries=2)
    # Same key, same route underneath: trajectories coincide exactly.
    np.testing.assert_array_equal(np.asarray(m), np.asarray(m2))
    np.testing.assert_allclose(np.asarray(c), np.asarray(c2), atol=1e-6)
    # And the fit recovers the target.
    assert float(np.max(np.abs(np.asarray(m) - np.asarray(t.mean)))) < 0.05
    assert float(np.max(np.abs(np.asarray(c) - np.asarray(t.cov)))) < 0.1


def test_auto_keeps_dense_path(target):
    t = target
    g = BaM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    assert not g._factor_route(True)  # "auto": dense on every platform


def test_use_factor_true_forces_route_anywhere(target):
    t = target
    g = BaM(D=t.d, lp=t.lp, lp_g=t.lp_g, use_factor=True)
    assert g._factor_route(True)
    m, c = g.fit(jax.random.PRNGKey(0), regf=Regularizers().linear(20.0),
                 niter=300, batch_size=8, verbose=False)
    assert float(np.max(np.abs(np.asarray(m) - np.asarray(t.mean)))) < 0.05


def test_use_factor_false_keeps_dense_trajectory(target):
    t = target
    regf = Regularizers().linear(20.0)
    g_dense = BaM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    m_ref, c_ref = g_dense.fit(jax.random.PRNGKey(0), regf=regf, niter=100,
                               batch_size=8, verbose=False)
    g = _factor_bam(t, use_factor=False)
    assert not g._factor_route(True)
    m, c = g.fit(jax.random.PRNGKey(0), regf=regf, niter=100, batch_size=8,
                 verbose=False)
    # Same dense step (sqrt_method "auto" is eigh everywhere): bitwise.
    np.testing.assert_array_equal(np.asarray(m), np.asarray(m_ref))


def test_return_state_is_vistate_with_consistent_chol(target):
    t = target
    g = _factor_bam(t)
    st = g.fit(jax.random.PRNGKey(0), regf=Regularizers().linear(20.0),
               niter=60, batch_size=8, verbose=False, return_state=True)
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
    regf = Regularizers().linear(20.0)
    g = _factor_bam(t)
    st = g.fit(jax.random.PRNGKey(0), regf=regf, niter=150, batch_size=8,
               verbose=False, return_state=True)
    st2 = g.fit(jax.random.PRNGKey(1), regf=regf, niter=150, batch_size=8,
                verbose=False, state=st, return_state=True)
    assert int(st2.step) == 302
    m, c = np.asarray(st2.mean), np.asarray(st2.cov)
    assert float(np.max(np.abs(m - np.asarray(t.mean)))) < 0.05
    assert float(np.max(np.abs(c - np.asarray(t.cov)))) < 0.1


def test_numpy_lp_g_still_uses_dense_eager_path(target):
    """Non-traceable callables must keep the dense eager loop (the factor
    route requires tracing)."""
    t = target

    def lp_g_np(x):
        return np.asarray(t.lp_g(jnp.asarray(np.asarray(x))))

    g = _factor_bam(t)
    g.lp_g = lambda x: lp_g_np(np.asarray(x))  # numpy in/out
    m, c = g.fit(jax.random.PRNGKey(0), regf=Regularizers().linear(20.0),
                 niter=60, batch_size=8, verbose=False)
    assert np.all(np.isfinite(np.asarray(m)))
