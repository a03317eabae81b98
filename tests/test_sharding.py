"""Multi-device correctness on the 8-way virtual CPU mesh (SURVEY.md §4e):
sharded fits must agree with single-device fits; shard_map statistics must
equal the unsharded computation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from gsmvi_jax import ADVI, BaM, GSM, Regularizers
from gsmvi_jax.models import dense_gaussian
from gsmvi_jax.ops.bam import bam_batch_stats
from gsmvi_jax.ops.gsm import gsm_update_stats
from gsmvi_jax.parallel import make_mesh
from gsmvi_jax.parallel.sharded import (sharded_bam_stats, sharded_gsm_stats,
                                        sharded_score_eval)


@pytest.fixture(scope="module")
def mesh(eight_devices):
    return make_mesh(8)


@pytest.fixture(scope="module")
def target():
    return dense_gaussian(jax.random.PRNGKey(21), 12)


def test_sharded_gsm_fit_matches_unsharded(mesh, target):
    """Same keys + deterministic kernels => GSPMD-sharded fit must match the
    single-device fit to fp tolerance."""
    t = target
    kw = dict(niter=100, batch_size=16, verbose=False)
    m1, c1 = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g).fit(jax.random.PRNGKey(9), **kw)
    m2, c2 = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g, mesh=mesh).fit(
        jax.random.PRNGKey(9), **kw)
    np.testing.assert_allclose(m1, m2, atol=1e-8)
    np.testing.assert_allclose(c1, c2, atol=1e-8)


def test_sharded_bam_fit_matches_unsharded(mesh, target):
    t = target
    regf = Regularizers().linear(100.0)
    kw = dict(niter=60, batch_size=16, verbose=False)
    m1, c1 = BaM(D=t.d, lp=t.lp, lp_g=t.lp_g).fit(
        jax.random.PRNGKey(9), regf=regf, **kw)
    m2, c2 = BaM(D=t.d, lp=t.lp, lp_g=t.lp_g, mesh=mesh).fit(
        jax.random.PRNGKey(9), regf=Regularizers().linear(100.0), **kw)
    np.testing.assert_allclose(m1, m2, atol=1e-8)
    np.testing.assert_allclose(c1, c2, atol=1e-8)


def test_sharded_advi_fit_runs(mesh):
    import optax
    t = dense_gaussian(jax.random.PRNGKey(22), 4)
    advi = ADVI(D=t.d, lp=t.lp, mesh=mesh)
    mean, cov, losses = advi.fit(jax.random.PRNGKey(1), optax.adam(1e-2),
                                 batch_size=16, niter=500, verbose=False)
    assert np.isfinite(losses).all()
    assert np.mean(losses[-50:]) < np.mean(losses[:50])


def test_shard_map_gsm_stats_match(mesh, target, rng):
    """Explicit shard_map+psum path == direct computation (oracle for the
    GSPMD path)."""
    t = target
    b = 32
    samples = jnp.asarray(rng.normal(size=(b, t.d)))
    mu0 = jnp.asarray(rng.normal(size=t.d))
    l = rng.normal(size=(t.d, t.d))
    s0 = jnp.asarray(l @ l.T + np.eye(t.d))
    vs = t.lp_g(samples)
    dmu_ref, ds_ref = gsm_update_stats(samples, vs, mu0, s0)
    dmu, ds = sharded_gsm_stats(mesh, t.lp_g, samples, mu0, s0)
    np.testing.assert_allclose(dmu, dmu_ref, atol=1e-10)
    np.testing.assert_allclose(ds, ds_ref, atol=1e-10)


def test_shard_map_bam_stats_match(mesh, target, rng):
    t = target
    samples = jnp.asarray(rng.normal(size=(24, t.d)))
    vs = t.lp_g(samples)
    xbar_r, c_r, gbar_r, g_r = bam_batch_stats(samples, vs)
    xbar, c, gbar, g = sharded_bam_stats(mesh, t.lp_g, samples)
    np.testing.assert_allclose(xbar, xbar_r, atol=1e-12)
    np.testing.assert_allclose(c, c_r, atol=1e-10)
    np.testing.assert_allclose(gbar, gbar_r, atol=1e-12)
    np.testing.assert_allclose(g, g_r, atol=1e-10)


def test_sharded_score_eval(mesh, target, rng):
    t = target
    samples = jnp.asarray(rng.normal(size=(16, t.d)))
    out = sharded_score_eval(mesh, t.lp_g, samples)
    np.testing.assert_allclose(out, t.lp_g(samples), atol=1e-12)


def test_batch_actually_sharded(mesh):
    """The sharding constraint inside the step must propagate: check the
    layout of a constrained batch array under jit."""
    sharding = NamedSharding(mesh, P("data", None))

    @jax.jit
    def make():
        x = jnp.zeros((16, 4))
        return jax.lax.with_sharding_constraint(x, sharding)

    x = make()
    assert x.sharding.is_equivalent_to(sharding, x.ndim)


def test_2d_mesh_cov_sharded_fit_matches(eight_devices, target):
    """Stretch goal (SURVEY §2): column-sharded covariance on a 2-D
    (data x model) mesh gives the same fit as unsharded."""
    from gsmvi_jax.parallel.large_d import cov_sharding, make_mesh_2d

    mesh2 = make_mesh_2d(2, 4)
    t = target
    kw = dict(niter=60, batch_size=8, verbose=False)
    m1, c1 = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g).fit(jax.random.PRNGKey(9), **kw)
    gsm = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g, mesh=mesh2,
              cov_sharding=cov_sharding(mesh2))
    m2, c2 = gsm.fit(jax.random.PRNGKey(9), **kw)
    np.testing.assert_allclose(m1, m2, atol=1e-8)
    np.testing.assert_allclose(c1, c2, atol=1e-8)


def test_shard_map_full_fit_matches_gspmd(mesh, target):
    """VERDICT #7: FULL fit through the explicit shard_map step must equal
    the GSPMD fitter's trajectory (same keys, same sampling layout)."""
    from gsmvi_jax.parallel.sharded import sharded_gsm_fit

    t = target
    kw = dict(niter=60, batch_size=16, verbose=False)
    m1, c1 = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g, mesh=mesh).fit(
        jax.random.PRNGKey(9), **kw)
    state = sharded_gsm_fit(mesh, t.lp_g, jax.random.PRNGKey(9), t.d,
                            niter=60, batch_size=16)
    np.testing.assert_allclose(np.asarray(state.mean), np.asarray(m1),
                               atol=1e-8)
    np.testing.assert_allclose(np.asarray(state.cov), np.asarray(c1),
                               atol=1e-8)
    # and it actually converges to the target
    np.testing.assert_allclose(np.asarray(state.mean), np.asarray(t.mean),
                               atol=0.2)


def test_monitored_sharded_fit(mesh, target):
    """KLMonitor under a mesh: the KL estimate reduces over the sharded batch."""
    from gsmvi_jax.utils.monitors import KLMonitor

    t = target
    mon = KLMonitor(batch_size_kl=32, checkpoint=20)
    gsm = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g, mesh=mesh)
    gsm.fit(jax.random.PRNGKey(4), niter=60, batch_size=16, verbose=False,
            monitor=mon)
    assert len(mon.rkl) == 5  # i=0,20,40,60 + final
    assert np.isfinite(mon.rkl).all()
    assert mon.rkl[-1] < mon.rkl[0]


def test_2d_mesh_factor_gsm_cov_sharded(eight_devices, target):
    """Large-D path on factor state: 2-D (data x model) mesh with the factor
    column-sharded.  Unlike the dense path (whose D x D Cholesky XLA must
    gather), the eps step is pure matmuls — GSPMD partitions it without any
    full-gather of F.  Must match the unsharded fit trajectory."""
    from gsmvi_jax import FactorGSM
    from gsmvi_jax.parallel.large_d import cov_sharding, make_mesh_2d

    t = target
    mesh2 = make_mesh_2d(2, 4)
    kw = dict(niter=60, batch_size=16, verbose=False)
    m1, c1 = FactorGSM(D=t.d, lp=t.lp, lp_g=t.lp_g).fit(
        jax.random.PRNGKey(9), **kw)
    fg = FactorGSM(D=t.d, lp=t.lp, lp_g=t.lp_g, mesh=mesh2,
                   cov_sharding=cov_sharding(mesh2))
    m2, c2 = fg.fit(jax.random.PRNGKey(9), **kw)
    np.testing.assert_allclose(np.asarray(m2), np.asarray(m1), atol=1e-8)
    np.testing.assert_allclose(np.asarray(c2), np.asarray(c1), atol=1e-8)


def test_sharded_step_memory_stays_partitioned(eight_devices):
    """Per-device memory evidence for the large-D path: with a model-sharded
    covariance and the blocked Cholesky, the compiled step's per-device
    state is ~1/n_model of the replicated compile and NO full-matrix
    all-gather materializes (a gathered D x D f32 temp would be >= d*d*4
    bytes; the largest sharded temp must stay well under that)."""
    import jax.numpy as jnp

    from gsmvi_jax import GSM
    from gsmvi_jax.parallel import cov_sharding, make_mesh_2d
    from gsmvi_jax.state import init_state

    d, b = 1024, 16
    lp = lambda x: -0.5 * jnp.sum(x * x, axis=-1)
    lp_g = lambda x: -x
    mesh = make_mesh_2d(1, 8)
    sh = cov_sharding(mesh)

    from jax.sharding import NamedSharding, PartitionSpec as P

    from gsmvi_jax.state import VIState

    rep = NamedSharding(mesh, P())
    stats = {}
    for name, kw, cov_s in [
            ("sharded", dict(mesh=mesh, cov_sharding=sh, chol_block=128), sh),
            ("replicated", {}, rep)]:
        gsm = GSM(D=d, lp=lp, lp_g=lp_g, **kw)
        state = init_state(jax.random.PRNGKey(1), d)
        # In the fit loop the step is a scan carry: output shardings feed
        # back as input shardings, so pin both to the steady-state layout.
        state_sh = VIState(rep, cov_s, cov_s, rep, rep, rep, rep)
        c = jax.jit(gsm._make_step(b), in_shardings=(state_sh,),
                    out_shardings=state_sh).lower(state).compile()
        stats[name] = c.memory_analysis()

    # conftest enables x64, so state buffers are 8-byte under the suite.
    full_mat = d * d * init_state(jax.random.PRNGKey(0), 4).cov.dtype.itemsize
    # state (mean + cov + chol) per device: ~2 full mats replicated, ~2/8
    # sharded (mean and scalars are O(D)).
    assert stats["replicated"].argument_size_in_bytes > 2 * full_mat
    assert stats["sharded"].argument_size_in_bytes < 0.35 * full_mat
    assert stats["sharded"].output_size_in_bytes < 0.35 * full_mat
    # no gather: every sharded temp fits well under one full D x D matrix.
    assert stats["sharded"].temp_size_in_bytes < 0.8 * full_mat


def test_mesh_factor_gsm_fit_matches_unsharded(mesh, target):
    """FactorGSM(mesh=...) shards the MC batch over the data axis (GSPMD
    reduces the row contractions); the trajectory matches the unsharded
    fit with the same key up to reordered f32 sums."""
    from gsmvi_jax import FactorGSM

    t = target
    kw = dict(niter=150, batch_size=16, verbose=False, return_state=True)
    s_sh = FactorGSM(D=t.d, lp=t.lp, lp_g=t.lp_g, mesh=mesh,
                     dtype=jnp.float32).fit(jax.random.PRNGKey(4), **kw)
    s_un = FactorGSM(D=t.d, lp=t.lp, lp_g=t.lp_g,
                     dtype=jnp.float32).fit(jax.random.PRNGKey(4), **kw)
    assert int(s_sh.n_accepted) == int(s_un.n_accepted)
    np.testing.assert_allclose(np.asarray(s_sh.mean), np.asarray(s_un.mean),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        np.asarray(s_sh.factor @ s_sh.factor.T),
        np.asarray(s_un.factor @ s_un.factor.T), rtol=2e-4, atol=2e-4)
    # And the fit actually recovers the target.
    np.testing.assert_allclose(np.asarray(s_sh.mean), np.asarray(t.mean),
                               atol=0.25)


def test_mesh_factor_gsm_indivisible_batch_runs(mesh):
    """A batch that does not divide the data axis (12 over 8 devices) is
    sharded unevenly by GSPMD and still fits."""
    from gsmvi_jax import FactorGSM

    t = dense_gaussian(jax.random.PRNGKey(21), 12)
    g = FactorGSM(D=t.d, lp=t.lp, lp_g=t.lp_g, mesh=mesh, dtype=jnp.float32)
    mean, cov = g.fit(jax.random.PRNGKey(0), niter=20, batch_size=12,
                      verbose=False)
    assert np.isfinite(np.asarray(mean)).all()
    assert np.isfinite(np.asarray(cov)).all()


def test_mesh_factor_bam_fit_matches_unsharded(mesh, target):
    """FactorBaM(mesh=...) under the data mesh matches the unsharded fit
    with the same key."""
    from gsmvi_jax import FactorBaM

    t = target
    kw = dict(regf=Regularizers().linear(30.0), niter=150, batch_size=16,
              verbose=False, retries=0, return_state=True)
    s_sh = FactorBaM(D=t.d, lp=t.lp, lp_g=t.lp_g, mesh=mesh,
                     dtype=jnp.float32).fit(jax.random.PRNGKey(4), **kw)
    s_un = FactorBaM(D=t.d, lp=t.lp, lp_g=t.lp_g,
                     dtype=jnp.float32).fit(jax.random.PRNGKey(4), **kw)
    assert int(s_sh.n_accepted) == int(s_un.n_accepted)
    np.testing.assert_allclose(np.asarray(s_sh.mean), np.asarray(s_un.mean),
                               rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(
        np.asarray(s_sh.factor @ s_sh.factor.T),
        np.asarray(s_un.factor @ s_un.factor.T), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(np.asarray(s_sh.mean), np.asarray(t.mean),
                               atol=0.25)


def test_mesh_factor_gsm_odd_device_count(eight_devices):
    """An odd mesh size (3 devices, batch 6) fits on the data mesh."""
    from gsmvi_jax import FactorGSM
    from gsmvi_jax.parallel import make_mesh

    t = dense_gaussian(jax.random.PRNGKey(21), 12)
    m3 = make_mesh(3)
    g = FactorGSM(D=t.d, lp=t.lp, lp_g=t.lp_g, mesh=m3, dtype=jnp.float32)
    mean, _ = g.fit(jax.random.PRNGKey(0), niter=20, batch_size=6,
                    verbose=False)
    assert np.isfinite(np.asarray(mean)).all()
