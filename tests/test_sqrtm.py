"""SPD matrix-square-root kernels vs scipy, across conditioning regimes."""

import numpy as np
import pytest
import scipy.linalg as sla

from gsmvi_jax.ops.sqrtm import spd_sqrtm, spd_sqrtm_and_inv, spd_sqrtm_newton


def spd(rng, d, cond):
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    evals = np.logspace(0, np.log10(cond), d)
    return (q * evals) @ q.T


@pytest.mark.parametrize("cond", [1.0, 1e2, 1e6])
def test_eigh_sqrt(rng, cond):
    m = spd(rng, 16, cond)
    root = np.asarray(spd_sqrtm(m))
    np.testing.assert_allclose(root @ root, m, rtol=1e-8, atol=1e-8 * cond)
    np.testing.assert_allclose(root, sla.sqrtm(m).real, atol=1e-6 * cond)


@pytest.mark.parametrize("cond", [1.0, 1e2, 1e4])
def test_newton_sqrt(rng, cond):
    m = spd(rng, 16, cond)
    root = np.asarray(spd_sqrtm_newton(m, 40))
    np.testing.assert_allclose(root @ root, m, rtol=1e-5, atol=1e-5 * cond)


def test_newton_bam_regime(rng):
    """The matrix BaM roots is I + PSD (eigenvalues >= 1)."""
    g = rng.normal(size=(8, 16))
    m = np.eye(16) + 4 * g.T @ g
    root = np.asarray(spd_sqrtm_newton(m, 25))
    np.testing.assert_allclose(root @ root, m, rtol=1e-6, atol=1e-4)


def test_sqrt_and_inv(rng):
    m = spd(rng, 12, 1e3)
    root, inv_root = (np.asarray(a) for a in spd_sqrtm_and_inv(m))
    np.testing.assert_allclose(root @ inv_root, np.eye(12), atol=1e-8)
    np.testing.assert_allclose(root @ root, m, atol=1e-8 * 1e3)


def test_eigh_clips_negative_noise(rng):
    """Slightly indefinite input (float noise) still yields a real PSD root."""
    m = spd(rng, 8, 10.0)
    m[0, 0] -= 2 * np.linalg.eigvalsh(m)[0]  # force one negative eigenvalue
    root = np.asarray(spd_sqrtm(m, eps=0.0))
    assert np.all(np.isfinite(root))
    assert np.all(np.linalg.eigvalsh(root @ root) >= -1e-10)
