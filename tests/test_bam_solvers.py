"""FactorBaM's small-space solvers against the dense BaM update.

Each solver of ``ops.bam_eps.bam_eps_update`` ("eigh": Gram eigh, "svd":
thin SVD, "auto": per-step choice by a conditioning bound) computes the same
exact update as ``ops.bam.bam_update`` — the float32 step to float32
accuracy on benign inputs, and "auto" follows "svd" on stiff ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gsmvi_jax.ops.bam import bam_lowrank_update, bam_update
from gsmvi_jax.ops.bam_eps import bam_eps_update


def _inputs(rng, b, d, score_scale=1.0):
    e = rng.normal(size=(b, d))
    f = np.eye(d) + 0.05 * rng.normal(size=(d, d))
    mu = rng.normal(size=d)
    x = mu + e @ f.T
    v = score_scale * -(x - rng.normal(size=d))
    return e, v, mu, f, x


@pytest.mark.parametrize("solver", ["eigh", "svd", "auto"])
@pytest.mark.parametrize("reg", [0.3, 1.0, 3.0])
@pytest.mark.parametrize("b,d", [(8, 32), (32, 96)])
def test_f32_solver_matches_dense_f64(rng, solver, reg, b, d):
    e, v, mu, f, x = _inputs(rng, b, d)
    m_ref, s_ref = bam_update(jnp.asarray(x), jnp.asarray(v),
                              jnp.asarray(mu), jnp.asarray(f @ f.T), reg)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    m, fn, good = bam_eps_update(f32(e), f32(v), f32(mu), f32(f),
                                 jnp.float32(reg), solver=solver)
    assert bool(good)
    s = np.asarray(fn, np.float64) @ np.asarray(fn, np.float64).T
    scale = max(1.0, float(np.abs(np.asarray(s_ref)).max()))
    np.testing.assert_allclose(s, np.asarray(s_ref), atol=3e-5 * scale)
    np.testing.assert_allclose(
        np.asarray(m), np.asarray(m_ref),
        atol=3e-5 * max(1.0, float(np.abs(np.asarray(m_ref)).max())))


@pytest.mark.parametrize("solver", ["eigh", "svd", "auto"])
def test_f64_solver_is_exact(rng, solver):
    b, d, reg = 16, 48, 2.0
    e, v, mu, f, x = _inputs(rng, b, d)
    m_ref, s_ref = bam_lowrank_update(jnp.asarray(x), jnp.asarray(v),
                                      jnp.asarray(mu), jnp.asarray(f @ f.T),
                                      reg)
    m, fn, good = bam_eps_update(jnp.asarray(e), jnp.asarray(v),
                                 jnp.asarray(mu), jnp.asarray(f), reg,
                                 solver=solver)
    assert bool(good)
    scale = max(1.0, float(np.abs(np.asarray(s_ref)).max()))
    np.testing.assert_allclose(np.asarray(fn @ fn.T), np.asarray(s_ref),
                               atol=1e-9 * scale)
    np.testing.assert_allclose(np.asarray(m), np.asarray(m_ref),
                               atol=1e-9 * scale)


def test_auto_follows_svd_on_a_stiff_step(rng):
    """Large scores and regularizer push kappa(Y) past the eigh route's
    float32 range; "auto" must then give the thin-SVD result."""
    b, d, reg = 32, 64, 20.0
    e, v, mu, f, _ = _inputs(rng, b, d, score_scale=300.0)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    args = (f32(e), f32(v), f32(mu), f32(f), jnp.float32(reg))
    m_a, f_a, g_a = bam_eps_update(*args, solver="auto")
    m_s, f_s, g_s = bam_eps_update(*args, solver="svd")
    assert bool(g_a) == bool(g_s)
    np.testing.assert_allclose(np.asarray(f_a), np.asarray(f_s), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(m_a), np.asarray(m_s), rtol=1e-5,
                               atol=1e-5)
