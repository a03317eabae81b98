"""Vmapped replica fits: K independent fits in one compiled program."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsmvi_jax import GSM
from gsmvi_jax.models import dense_gaussian


def test_fit_batch_all_replicas_recover():
    t = dense_gaussian(jax.random.PRNGKey(3), 8)
    gsm = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    keys = jax.random.split(jax.random.PRNGKey(0), 5)
    means, covs = gsm.fit_batch(keys, niter=400, batch_size=8)
    assert means.shape == (5, 8) and covs.shape == (5, 8, 8)
    for i in range(5):
        np.testing.assert_allclose(means[i], t.mean, atol=5e-3)


def test_fit_batch_matches_sequential_fit():
    """Replica j of fit_batch equals fit() with the same key (same pure step)."""
    t = dense_gaussian(jax.random.PRNGKey(3), 6)
    gsm = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    means, covs = gsm.fit_batch(keys, niter=30, batch_size=4)
    m_ref, c_ref = gsm.fit(keys[1], niter=30, batch_size=4, verbose=False)
    np.testing.assert_allclose(means[1], m_ref, atol=1e-10)
    np.testing.assert_allclose(covs[1], c_ref, atol=1e-10)


def test_fit_batch_per_replica_warm_start():
    t = dense_gaussian(jax.random.PRNGKey(3), 6)
    gsm = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    means0 = jnp.stack([jnp.zeros(6), jnp.asarray(t.mean)])
    covs0 = jnp.stack([jnp.eye(6), jnp.asarray(t.cov)])
    means, _ = gsm.fit_batch(keys, mean=means0, cov=covs0, niter=50,
                             batch_size=8)
    np.testing.assert_allclose(means[1], t.mean, atol=5e-3)


def test_bam_fit_batch():
    from gsmvi_jax import BaM, Regularizers

    t = dense_gaussian(jax.random.PRNGKey(3), 6)
    bam = BaM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    means, covs = bam.fit_batch(keys, regf=Regularizers().linear(100.0),
                                niter=150, batch_size=8)
    assert means.shape == (3, 6)
    for i in range(3):
        np.testing.assert_allclose(means[i], t.mean, atol=1e-2)


def test_factor_gsm_fit_batch():
    from gsmvi_jax import FactorGSM

    t = dense_gaussian(jax.random.PRNGKey(3), 6)
    fg = FactorGSM(D=t.d, lp=t.lp, lp_g=t.lp_g, refresh_every=0)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    means, covs = fg.fit_batch(keys, niter=300, batch_size=8)
    assert covs.shape == (3, 6, 6)
    for i in range(3):
        np.testing.assert_allclose(means[i], t.mean, atol=1e-2)


def test_advi_fit_batch():
    import optax
    from gsmvi_jax import ADVI

    t = dense_gaussian(jax.random.PRNGKey(3), 4)
    advi = ADVI(D=4, lp=t.lp)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    means, covs, losses = advi.fit_batch(keys, optax.adam(1e-2),
                                         batch_size=16, niter=2000)
    assert means.shape == (3, 4) and covs.shape == (3, 4, 4)
    assert losses.shape == (3, 2001)
    for i in range(3):
        np.testing.assert_allclose(means[i], t.mean, atol=0.3)
        assert losses[i, -100:].mean() < losses[i, :100].mean()


def test_factor_gsm_fit_batch_ns_xla_solver():
    """The batched-replica NS-XLA step (small_solver="auto" at f32):
    converges, and its single update agrees with the exact Cholesky eps
    step (ops/gsm_eps.py) to the Newton-Schulz chains' accuracy."""
    from gsmvi_jax import FactorGSM
    from gsmvi_jax.ops.gsm_eps import apply_eps_step
    from gsmvi_jax.ops.gsm_eps_ns import gsm_eps_update_ns_xla

    t = dense_gaussian(jax.random.PRNGKey(3), 16)
    fg = FactorGSM(D=16, lp=t.lp, lp_g=t.lp_g, dtype=jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    means, covs = fg.fit_batch(keys, niter=400, batch_size=8)  # auto -> ns
    for i in range(3):
        np.testing.assert_allclose(means[i], t.mean, atol=1e-2)
        np.testing.assert_allclose(covs[i], t.cov, atol=5e-2)

    # chol solver still available and converges too
    means_c, _ = fg.fit_batch(keys, niter=400, batch_size=8,
                              small_solver="chol")
    for i in range(3):
        np.testing.assert_allclose(means_c[i], t.mean, atol=1e-2)

    # update-level agreement: NS-XLA == exact chol eps step (f32 inputs)
    rng = np.random.default_rng(0)
    b, d = 8, 32
    eps = jnp.asarray(rng.normal(size=(b, d)), jnp.float32)
    vs = jnp.asarray(rng.normal(size=(b, d)) * 0.2, jnp.float32)
    mu = jnp.asarray(rng.normal(size=(d,)), jnp.float32)
    f = (jnp.eye(d, dtype=jnp.float32)
         + 0.01 * jnp.asarray(rng.normal(size=(d, d)), jnp.float32))
    mc, fc, gc = apply_eps_step(mu, f, eps, vs)
    mx, fx, gx = gsm_eps_update_ns_xla(eps, vs, mu, f)
    assert bool(gc) and bool(gx)
    np.testing.assert_allclose(np.asarray(mx), np.asarray(mc), atol=1e-5)
    np.testing.assert_allclose(np.asarray(fx @ fx.T), np.asarray(fc @ fc.T),
                               atol=1e-4)


def test_factor_gsm_fit_batch_ns_xla_vmaps_batched():
    """The NS-XLA step under vmap stays per-replica exact: replica j of the
    batched fit equals a 1-replica batched fit with the same key."""
    from gsmvi_jax import FactorGSM

    t = dense_gaussian(jax.random.PRNGKey(3), 12)
    fg = FactorGSM(D=12, lp=t.lp, lp_g=t.lp_g, dtype=jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    means, covs = fg.fit_batch(keys, niter=40, batch_size=4)
    m1, c1 = fg.fit_batch(keys[1:2], niter=40, batch_size=4)
    np.testing.assert_allclose(means[1], m1[0], atol=1e-10)
    np.testing.assert_allclose(covs[1], c1[0], atol=1e-10)


def test_factor_bam_fit_batch():
    from gsmvi_jax import FactorBaM, Regularizers

    t = dense_gaussian(jax.random.PRNGKey(3), 8)
    bam = FactorBaM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    means, covs = bam.fit_batch(keys, regf=Regularizers().linear(50.0),
                                niter=300, batch_size=8)
    assert means.shape == (3, 8) and covs.shape == (3, 8, 8)
    for i in range(3):
        np.testing.assert_allclose(means[i], t.mean, atol=2e-2)

    # Replica j equals fit() with the same key (same pure step).
    m_ref, c_ref = bam.fit(keys[1], regf=Regularizers().linear(50.0),
                           niter=300, batch_size=8, verbose=False)
    np.testing.assert_allclose(means[1], m_ref, atol=1e-8)
    np.testing.assert_allclose(covs[1], c_ref, atol=1e-8)


def test_factor_gsm_fit_batch_chol_matches_single_fits():
    """Replica j of fit_batch(small_solver="chol") runs the same pure step
    as fit() with key j: trajectories coincide to rounding."""
    from gsmvi_jax import FactorGSM

    d, b, niter = 8, 8, 45
    t = dense_gaussian(jax.random.PRNGKey(5), d, scale=0.3)
    g = FactorGSM(D=d, lp=t.lp, lp_g=t.lp_g, dtype=jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    st = g.fit_batch(keys, niter=niter, batch_size=b, return_state=True,
                     small_solver="chol")
    assert st.mean.shape == (3, d)
    for i in range(3):
        si = g.fit(keys[i], niter=niter, batch_size=b, verbose=False,
                   return_state=True)
        np.testing.assert_allclose(np.asarray(st.mean[i]),
                                   np.asarray(si.mean), atol=1e-5)
        np.testing.assert_allclose(np.asarray(st.factor[i]),
                                   np.asarray(si.factor), atol=1e-5)
        assert int(st.n_accepted[i]) == int(si.n_accepted)
        assert int(st.step[i]) == int(si.step)


@pytest.mark.parametrize("solver", ["fused", "eigh", ""])
def test_factor_gsm_fit_batch_rejects_unknown_solver(solver):
    """Only "auto", "ns" and "chol" exist; the removed fused kernel's
    "fused" (and any typo) raises instead of silently falling back."""
    from gsmvi_jax import FactorGSM

    t = dense_gaussian(jax.random.PRNGKey(5), 4)
    g = FactorGSM(D=4, lp=t.lp, lp_g=t.lp_g, dtype=jnp.float32)
    with pytest.raises(ValueError, match="small_solver"):
        g.fit_batch(jax.random.split(jax.random.PRNGKey(0), 2), niter=2,
                    batch_size=4, small_solver=solver)


def test_gsm_class_fit_batch_routes_to_factor():
    """With use_factor=True the GSM class delegates fit_batch to
    FactorGSM.fit_batch (like fit); the dense vmapped step stays for
    use_factor=False."""
    d = 8
    t = dense_gaussian(jax.random.PRNGKey(5), d, scale=0.3)
    g = GSM(D=d, lp=t.lp, lp_g=t.lp_g, dtype=jnp.float32, use_factor=True)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    means, covs = g.fit_batch(keys, niter=300, batch_size=8)
    fg = g._get_factor_fitter()
    m_ref, c_ref = fg.fit_batch(keys, niter=300, batch_size=8)
    np.testing.assert_array_equal(np.asarray(means), np.asarray(m_ref))
    np.testing.assert_array_equal(np.asarray(covs), np.asarray(c_ref))

    st = g.fit_batch(keys, niter=10, batch_size=8, return_state=True)
    assert st.cov.shape == (3, d, d) and st.chol.shape == (3, d, d)

    g_dense = GSM(D=d, lp=t.lp, lp_g=t.lp_g, dtype=jnp.float32,
                  use_factor=False)
    m_d, c_d = g_dense.fit_batch(keys, niter=300, batch_size=8)
    np.testing.assert_allclose(np.asarray(m_d[0]), np.asarray(t.mean),
                               atol=0.05)
