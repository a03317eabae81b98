"""Factor-coordinate BaM (ops/bam_eps.py + bam_factor.py).

The factor route must reproduce the dense BaM update exactly: for S0 = F F^T
and samples x = mu + eps F^T, the proposed F' must satisfy F' F'^T = S' where
S' is ops/bam.py's full-rank result (itself pinned to the reference kernel in
tests/test_reference_parity.py).  Full-rank and low-rank coincide because U
is exactly rank B+1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsmvi_jax.bam_factor import FactorBaM
from gsmvi_jax.ops.bam import Regularizers, bam_update
from gsmvi_jax.ops.bam_eps import bam_eps_update


@pytest.mark.parametrize("b,d,reg", [(2, 5, 100.0), (8, 16, 0.5),
                                     (32, 64, 5.0), (32, 256, 1.0)])
def test_matches_dense_bam_f64(rng, b, d, reg):
    f = 0.3 * rng.normal(size=(d, d)) + np.eye(d)
    mu = rng.normal(size=d)
    eps = rng.normal(size=(b, d))
    x = mu + eps @ f.T
    v = 0.3 * rng.normal(size=(b, d))
    s0 = f @ f.T

    m_full, s_full = bam_update(jnp.asarray(x), jnp.asarray(v),
                                jnp.asarray(mu), jnp.asarray(s0), reg)
    m_e, f_e, good = bam_eps_update(jnp.asarray(eps), jnp.asarray(v),
                                    jnp.asarray(mu), jnp.asarray(f), reg)
    assert bool(good)
    scale = max(1.0, float(np.abs(np.asarray(s_full)).max()))
    np.testing.assert_allclose(np.asarray(m_e), np.asarray(m_full),
                               atol=1e-9 * scale)
    np.testing.assert_allclose(np.asarray(f_e @ f_e.T), np.asarray(s_full),
                               atol=1e-9 * scale)


def test_f32_accuracy(rng):
    b, d, reg = 32, 128, 2.0
    f = (0.3 * rng.normal(size=(d, d)) + np.eye(d)).astype(np.float32)
    mu = rng.normal(size=d).astype(np.float32)
    eps = rng.normal(size=(b, d)).astype(np.float32)
    x = mu + eps @ f.T
    v = (0.2 * rng.normal(size=(b, d))).astype(np.float32)
    s0 = f @ f.T
    m_full, s_full = bam_update(jnp.asarray(x), jnp.asarray(v),
                                jnp.asarray(mu), jnp.asarray(s0),
                                np.float32(reg))
    m_e, f_e, good = bam_eps_update(jnp.asarray(eps), jnp.asarray(v),
                                    jnp.asarray(mu), jnp.asarray(f),
                                    np.float32(reg))
    assert bool(good)
    scale = max(1.0, float(np.abs(np.asarray(s_full)).max()))
    np.testing.assert_allclose(np.asarray(f_e @ f_e.T), np.asarray(s_full),
                               atol=5e-4 * scale)


@pytest.mark.parametrize("solver", ["svd", "auto"])
def test_f32_svd_solver_stiff_regime(rng, solver):
    """The round-2 f32 stall: large reg x large scores make kappa(Y) ~ 1e4+,
    where the Gram-eigh route's kappa^2 exceeds f32 and the contraction
    weights go wrong by O(1e-1) (mean stalls at D=256 on dense_gaussian).
    The default SVD solver resolves the spectrum at kappa(Y) accuracy; pin
    the f32 step against the f64 ground truth in exactly that regime."""
    b, d, reg = 32, 128, 100.0
    # Stiff factor: singular values spanning ~3 decades.
    u, _ = np.linalg.qr(rng.normal(size=(d, d)))
    f = (u * np.logspace(-1.5, 1.5, d)) @ u.T + 0.0
    mu = rng.normal(size=d)
    eps = rng.normal(size=(b, d))
    v = 30.0 * rng.normal(size=(b, d))        # large scores, as early in fit

    m64, f64_, good64 = bam_eps_update(
        jnp.asarray(eps), jnp.asarray(v), jnp.asarray(mu), jnp.asarray(f),
        reg)
    assert bool(good64)
    s64 = np.asarray(f64_ @ f64_.T, np.float64)

    a32 = lambda x: jnp.asarray(x, jnp.float32)
    m32, f32_, good32 = bam_eps_update(
        a32(eps), a32(v), a32(mu), a32(f), np.float32(reg), solver=solver)
    assert bool(good32)
    s32 = np.asarray(f32_ @ f32_.T, np.float64)
    scale = max(1.0, np.abs(s64).max())
    assert np.abs(s32 - s64).max() / scale < 2e-4
    mscale = max(1.0, np.abs(np.asarray(m64)).max())
    # The mean applies S to the (large) mean score — one extra kappa factor
    # of amplification over the covariance; 2.5e-4 observed.
    assert np.abs(np.asarray(m32, np.float64) - np.asarray(m64)).max() \
        / mscale < 1e-3


def test_fitter_end_to_end_recovery():
    from gsmvi_jax.models import dense_gaussian

    t = dense_gaussian(jax.random.PRNGKey(3), 16)
    bam = FactorBaM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    state = bam.fit(jax.random.PRNGKey(0), regf=Regularizers().linear(100.0),
                    niter=400, batch_size=16, verbose=False,
                    return_state=True)
    np.testing.assert_allclose(np.asarray(state.mean), np.asarray(t.mean),
                               atol=0.05)
    np.testing.assert_allclose(np.asarray(state.cov), np.asarray(t.cov),
                               atol=0.1)


def test_fitter_matches_dense_bam_trajectory():
    """With cov=I the first factor equals chol(I); identical eps streams mean
    the FIRST step must agree with dense BaM exactly; later steps use
    different square roots and agree only in distribution."""
    from gsmvi_jax import BaM
    from gsmvi_jax.models import dense_gaussian

    t = dense_gaussian(jax.random.PRNGKey(3), 8)
    kw = dict(niter=0, batch_size=4, verbose=False, retries=0)
    m1, c1 = BaM(D=t.d, lp=t.lp, lp_g=t.lp_g).fit(
        jax.random.PRNGKey(5), regf=Regularizers().constant(10.0),
        jitter=0.0, **kw)
    m2, c2 = FactorBaM(D=t.d, lp=t.lp, lp_g=t.lp_g).fit(
        jax.random.PRNGKey(5), regf=Regularizers().constant(10.0),
        **kw)
    np.testing.assert_allclose(np.asarray(m2), np.asarray(m1), atol=1e-8)
    np.testing.assert_allclose(np.asarray(c2), np.asarray(c1), atol=1e-8)


def test_retries_and_monitoring():
    from gsmvi_jax.models import dense_gaussian
    from gsmvi_jax.utils.monitors import KLMonitor

    t = dense_gaussian(jax.random.PRNGKey(3), 8)
    mon = KLMonitor(batch_size_kl=16, checkpoint=20)
    bam = FactorBaM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    bam.fit(jax.random.PRNGKey(0), regf=Regularizers().linear(50.0),
            niter=100, batch_size=8, verbose=False, monitor=mon, retries=5)
    assert len(mon.rkl) == 7
    assert np.isfinite(mon.rkl).all()
    assert mon.rkl[-1] < mon.rkl[0]


def test_rejects_numpy_lp_g():
    bam = FactorBaM(D=4, lp=lambda x: np.sum(x), lp_g=lambda x: np.asarray(x))
    with pytest.raises(TypeError):
        bam.fit(jax.random.PRNGKey(0), regf=Regularizers().constant(1.0),
                niter=2, verbose=False)


def test_update_corr_converges_in_stiff_centered_regime():
    """Regression for the newton_iters=10 mistake: Om built from CENTERED
    eps is rank-deficient, so cond(I+Gu) ~ reg*lmax/B reaches ~1e4 at
    aggressive schedules and the Newton-Schulz warm-up is cond-bound —
    the default sweep count must hold the floor there."""
    import inspect

    from gsmvi_jax.ops.bam_eps import bam_eps_update
    from gsmvi_jax.ops.gsm_factor import _update_corr

    default_iters = inspect.signature(bam_eps_update).parameters[
        "newton_iters"].default
    rng = np.random.default_rng(0)
    b, d, reg = 32, 128, 1000.0
    eps = rng.normal(size=(b, d))
    ed = eps - eps.mean(0)
    r1 = reg / (1 + reg)
    om = np.concatenate([np.sqrt(reg / b) * ed.T,
                         -np.sqrt(r1) * eps.mean(0)[:, None]], axis=1)
    gu = (om.T @ om).astype(np.float32)
    gu = 0.5 * (gu + gu.T)
    g64 = gu.astype(np.float64)
    k = gu.shape[0]
    w, q = np.linalg.eigh(np.eye(k) + g64)
    c_true = q @ np.diag(1.0 / (1.0 + np.sqrt(w))) @ q.T
    c = np.asarray(_update_corr(jnp.asarray(gu), default_iters)[0],
                   np.float64)
    rel = np.max(np.abs(c - c_true)) / np.max(np.abs(c_true))
    assert rel < 1e-4, f"default newton_iters={default_iters} rel={rel:.2e}"


def test_auto_solver_routes_benign_to_eigh_and_stiff_to_svd(rng):
    """solver="auto" must equal the eigh branch bit-for-bit on benign steps
    (the router takes that branch) and the svd branch on stiff ones."""
    b, d = 16, 64
    a32 = lambda x: jnp.asarray(np.asarray(x), jnp.float32)
    f = a32(np.eye(d) + 0.05 * rng.normal(size=(d, d)))
    mu = a32(rng.normal(size=d))
    eps = a32(rng.normal(size=(b, d)))

    # Benign: small scores -> lmax(Gram) far below the f32 threshold; all
    # three solvers agree to f32 working accuracy there (cond traces its
    # branches, so bitwise equality with the eager branch is not expected).
    v = a32(0.5 * rng.normal(size=(b, d)))
    m_a, f_a, _ = bam_eps_update(eps, v, mu, f, 1.0, solver="auto")
    m_e, f_e, _ = bam_eps_update(eps, v, mu, f, 1.0, solver="eigh")
    np.testing.assert_allclose(np.asarray(m_a), np.asarray(m_e), atol=1e-5)
    np.testing.assert_allclose(np.asarray(f_a), np.asarray(f_e), atol=1e-5)

    # Stiff: large reg x large scores.  The router must take the SVD
    # branch: auto tracks svd to working accuracy while eigh measurably
    # disagrees (its kappa^2 exceeds f32 here).
    v = a32(100.0 * rng.normal(size=(b, d)))
    m_a, f_a, _ = bam_eps_update(eps, v, mu, f, 100.0, solver="auto")
    m_s, f_s, _ = bam_eps_update(eps, v, mu, f, 100.0, solver="svd")
    m_e, _, _ = bam_eps_update(eps, v, mu, f, 100.0, solver="eigh")
    svd_gap = np.abs(np.asarray(m_a) - np.asarray(m_s)).max()
    eigh_gap = np.abs(np.asarray(m_e) - np.asarray(m_s)).max()
    assert svd_gap < 1e-5
    assert eigh_gap > 10 * max(svd_gap, 1e-6)
    np.testing.assert_allclose(np.asarray(f_a), np.asarray(f_s), atol=1e-5)


def test_auto_solver_small_d_falls_back_to_svd(rng):
    """D < B+1 (thin-SVD column count shrinks) must not break the router."""
    b, d = 16, 8
    a32 = lambda x: jnp.asarray(np.asarray(x), jnp.float32)
    eps = a32(rng.normal(size=(b, d)))
    v = a32(0.5 * rng.normal(size=(b, d)))
    m_a, f_a, good = bam_eps_update(a32(eps), v, a32(rng.normal(size=d)),
                                    a32(np.eye(d)), 1.0, solver="auto")
    assert bool(good)
    assert np.isfinite(np.asarray(f_a)).all()
