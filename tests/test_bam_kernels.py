"""BaM update kernels vs an independent naive implementation.

Oracle: the BaM update written directly from arXiv:2402.14758 (U/V batch
statistics + the nonsymmetric-sqrtm solve) using scipy's ``sqrtm`` on host —
i.e. the formulation the reference uses on CPU (``gsmvi/bam.py:31-69``) —
re-derived here independently in numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla

from gsmvi_jax.ops.bam import (Regularizers, bam_batch_stats,
                               bam_lowrank_update, bam_update)


def oracle_bam(x, v, mu0, s0, reg):
    b, d = x.shape
    xbar, gbar = x.mean(0), v.mean(0)
    xd, gd = x - xbar, v - gbar
    c = sum(np.outer(r, r) for r in xd) / b
    g = sum(np.outer(r, r) for r in gd) / b
    r1 = reg / (1 + reg)
    u = reg * g + r1 * np.outer(gbar, gbar)
    vv = s0 + reg * c + r1 * np.outer(mu0 - xbar, mu0 - xbar)
    root = sla.sqrtm(np.eye(d) + 4 * u @ vv).real
    s = 2 * np.linalg.solve(np.eye(d) + root.T, vv.T)
    mu = mu0 / (1 + reg) + r1 * (s @ gbar + xbar)
    return mu, s, u, vv


def random_problem(rng, d, b):
    mu0 = rng.normal(size=d)
    l = rng.normal(size=(d, d))
    s0 = l @ l.T + np.eye(d)
    return rng.normal(size=(b, d)), rng.normal(size=(b, d)), mu0, s0


@pytest.mark.parametrize("d,b,reg", [(4, 2, 0.5), (9, 3, 100.0), (16, 8, 3.0)])
def test_fullrank_matches_oracle(rng, d, b, reg):
    x, v, mu0, s0 = random_problem(rng, d, b)
    mu_ref, s_ref, _, _ = oracle_bam(x, v, mu0, s0, reg)
    mu, s = bam_update(x, v, mu0, s0, reg)
    np.testing.assert_allclose(mu, mu_ref, atol=1e-8)
    np.testing.assert_allclose(s, s_ref, atol=1e-8)


def test_newton_sqrt_variant(rng):
    x, v, mu0, s0 = random_problem(rng, 8, 4)
    mu_ref, s_ref = bam_update(x, v, mu0, s0, 2.0)
    mu, s = bam_update(x, v, mu0, s0, 2.0, sqrt_method="newton",
                       newton_iters=30)
    np.testing.assert_allclose(mu, mu_ref, atol=1e-6)
    np.testing.assert_allclose(s, s_ref, atol=1e-6)


@pytest.mark.parametrize("d,b,reg", [(12, 2, 50.0), (20, 4, 1.0)])
def test_lowrank_matches_fullrank(rng, d, b, reg):
    """The exact rank-(B+1) factor must reproduce the full-rank solve — this
    is the property that lets us drop the reference's svds host callback."""
    x, v, mu0, s0 = random_problem(rng, d, b)
    mu_ref, s_ref = bam_update(x, v, mu0, s0, reg)
    mu, s = bam_lowrank_update(x, v, mu0, s0, reg)
    np.testing.assert_allclose(mu, mu_ref, atol=1e-7)
    np.testing.assert_allclose(s, s_ref, atol=1e-7)


def test_outputs_exactly_symmetric(rng):
    x, v, mu0, s0 = random_problem(rng, 10, 3)
    for s in (bam_update(x, v, mu0, s0, 5.0)[1],
              bam_lowrank_update(x, v, mu0, s0, 5.0)[1]):
        assert float(jnp.max(jnp.abs(s - s.T))) == 0.0


def test_output_positive_definite(rng):
    x, v, mu0, s0 = random_problem(rng, 10, 3)
    _, s = bam_update(x, v, mu0, s0, 10.0, jitter=1e-9)
    assert np.all(np.linalg.eigvalsh(np.asarray(s)) > 0)


def test_batch_stats_match_naive(rng):
    x, v, mu0, s0 = random_problem(rng, 6, 5)
    xbar, c, gbar, g = bam_batch_stats(jnp.asarray(x), jnp.asarray(v))
    c_ref = sum(np.outer(r, r) for r in x - x.mean(0)) / x.shape[0]
    g_ref = sum(np.outer(r, r) for r in v - v.mean(0)) / v.shape[0]
    np.testing.assert_allclose(c, c_ref, atol=1e-10)
    np.testing.assert_allclose(xbar, x.mean(0), atol=1e-12)
    np.testing.assert_allclose(g, g_ref, atol=1e-10)
    np.testing.assert_allclose(gbar, v.mean(0), atol=1e-12)


def test_reg_to_zero_keeps_prior(rng):
    """reg -> 0 must return (mu0, S0): the matching term vanishes."""
    x, v, mu0, s0 = random_problem(rng, 5, 3)
    mu, s = bam_update(x, v, mu0, s0, 1e-12)
    np.testing.assert_allclose(mu, mu0, atol=1e-8)
    np.testing.assert_allclose(s, s0, atol=1e-6)


class TestRegularizers:
    """Pure-schedule semantics mapped from the reference's call counter
    (counter == iteration + 1; see ops/bam.py docstring)."""

    def test_constant(self):
        f = Regularizers().constant(7.0)
        assert f(0) == 7.0 and f(123) == 7.0

    def test_linear(self):
        f = Regularizers().linear(10.0)
        assert f(0) == 10.0
        assert f(9) == pytest.approx(1.0)

    def test_custom_counter_offset(self):
        # Reference example: func(counter) with counter = i+1
        # (examples/example_bam.py:57-59).
        f = Regularizers().custom(lambda c: 100.0 / (1 + c))
        assert f(0) == pytest.approx(50.0)
        assert f(1) == pytest.approx(100.0 / 3)

    def test_counter_tracks_eager_calls(self):
        r = Regularizers()
        f = r.constant(1.0)
        f(0); f(1)
        assert r.counter == 2
        r.reset()
        assert r.counter == 0


def test_bam_limits_to_gsm_at_infinite_reg(rng):
    """arXiv:2402.14758 Prop.: BaM with B=1 recovers the GSM update as
    reg -> inf; convergence rate O(1/reg).  Cross-algorithm consistency
    check pinning both kernels."""
    from gsmvi_jax.ops.gsm import gsm_update

    d = 6
    mu0 = rng.normal(size=d)
    l = rng.normal(size=(d, d))
    s0 = l @ l.T + np.eye(d)
    x = rng.normal(size=(1, d))
    v = 0.5 * rng.normal(size=(1, d))
    mu_g, s_g = gsm_update(x, v, mu0, s0)
    err_prev = None
    for reg in (1e4, 1e6, 1e8):
        mu_b, s_b = bam_update(x, v, mu0, s0, reg)
        err = max(float(jnp.abs(mu_b - mu_g).max()),
                  float(jnp.abs(s_b - s_g).max()))
        if err_prev is not None:
            assert err < err_prev / 10  # O(1/reg) decay
        err_prev = err
    assert err_prev < 1e-6


def test_lowrank_newton_matches_eigh(rng):
    x, v, mu0, s0 = random_problem(rng, 12, 4)
    mu_ref, s_ref = bam_lowrank_update(x, v, mu0, s0, 5.0)
    mu, s = bam_lowrank_update(x, v, mu0, s0, 5.0, sqrt_method="newton",
                               newton_iters=30)
    np.testing.assert_allclose(mu, mu_ref, atol=1e-6)
    np.testing.assert_allclose(s, s_ref, atol=1e-6)


def test_auto_lowrank_routing_matches_forced_fullrank():
    """BaM's auto low-rank routing (B+1 << D) must reproduce the forced
    full-rank fit — the routing is an exact algebraic identity, not an
    approximation."""
    import jax

    from gsmvi_jax import BaM, Regularizers
    from gsmvi_jax.models import dense_gaussian

    t = dense_gaussian(jax.random.PRNGKey(3), 40)
    kw = dict(niter=40, batch_size=4, verbose=False, retries=0)
    bam_auto = BaM(D=40, lp=t.lp, lp_g=t.lp_g)              # routes (4*5<=40)
    bam_full = BaM(D=40, lp=t.lp, lp_g=t.lp_g, auto_lowrank=False)
    m1, c1 = bam_auto.fit(jax.random.PRNGKey(0),
                          regf=Regularizers().linear(50.0), **kw)
    m2, c2 = bam_full.fit(jax.random.PRNGKey(0),
                          regf=Regularizers().linear(50.0), **kw)
    np.testing.assert_allclose(np.asarray(m1), np.asarray(m2),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(c1), np.asarray(c2),
                               rtol=1e-6, atol=1e-7)
