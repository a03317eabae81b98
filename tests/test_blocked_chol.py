"""Blocked right-looking Cholesky (parallel/chol.py): exactness vs XLA's
cholesky, NaN semantics for the goodness check, sharded execution on the
8-way virtual mesh, and the GSM ``chol_block`` fit path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsmvi_jax import GSM
from gsmvi_jax.models import dense_gaussian
from gsmvi_jax.parallel import blocked_cholesky
from gsmvi_jax.parallel.large_d import cov_sharding, make_mesh_2d


def _spd(rng, d):
    a = rng.normal(size=(d, d))
    return a @ a.T + d * np.eye(d)


@pytest.mark.parametrize("d,block", [(8, 4), (12, 5), (32, 32), (48, 16),
                                     (50, 16), (64, 8)])
def test_matches_xla_cholesky(rng, d, block):
    a = jnp.asarray(_spd(rng, d))
    l_ref = np.asarray(jnp.linalg.cholesky(a))
    l = np.asarray(blocked_cholesky(a, block))
    np.testing.assert_allclose(l, l_ref, atol=1e-10 * d)


def test_jits_with_static_unroll(rng):
    a = jnp.asarray(_spd(rng, 40))
    l = jax.jit(lambda x: blocked_cholesky(x, 16))(a)
    np.testing.assert_allclose(np.asarray(l),
                               np.asarray(jnp.linalg.cholesky(a)),
                               atol=1e-9)


def test_non_pd_propagates_nan(rng):
    """A non-PD matrix must yield NaNs (never raise) so the fitters'
    finiteness goodness check works unchanged (state.py:57-58)."""
    a = jnp.asarray(_spd(rng, 24))
    bad = a - 100.0 * jnp.eye(24)         # indefinite
    l = blocked_cholesky(bad, 8)
    assert not bool(jnp.all(jnp.isfinite(l)))
    # NaNs must reach blocks AFTER the failing one (propagation through the
    # trailing update), not just the failing panel.
    assert not bool(jnp.all(jnp.isfinite(l[-8:, -8:])))


def test_sharded_execution_matches(eight_devices, rng):
    """Under a model-sharded covariance the blocked factorization must run
    partitioned (jit under mesh) and agree with the unsharded result."""
    mesh2 = make_mesh_2d(2, 4)
    sh = cov_sharding(mesh2)
    a = jnp.asarray(_spd(rng, 64))

    @jax.jit
    def f(x):
        x = jax.lax.with_sharding_constraint(x, sh)
        return blocked_cholesky(x, 16, out_sharding=sh)

    l = f(a)
    np.testing.assert_allclose(np.asarray(l),
                               np.asarray(jnp.linalg.cholesky(a)),
                               atol=1e-9)
    assert l.sharding.is_equivalent_to(sh, l.ndim)


def test_gsm_chol_block_fit_matches(eight_devices):
    """GSM(chol_block=...) on the 2-D mesh: same trajectory as the default
    dense path (the factorization is exact, so accept/revert decisions and
    the sampling factor are identical to fp tolerance)."""
    mesh2 = make_mesh_2d(2, 4)
    t = dense_gaussian(jax.random.PRNGKey(21), 16)
    kw = dict(niter=60, batch_size=8, verbose=False)
    m1, c1 = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g).fit(jax.random.PRNGKey(9), **kw)
    gsm = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g, mesh=mesh2,
              cov_sharding=cov_sharding(mesh2), chol_block=8)
    m2, c2 = gsm.fit(jax.random.PRNGKey(9), **kw)
    np.testing.assert_allclose(np.asarray(m1), np.asarray(m2), atol=1e-8)
    np.testing.assert_allclose(np.asarray(c1), np.asarray(c2), atol=1e-8)
