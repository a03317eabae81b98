"""The matmul-only Newton-Schulz eps step (ops/gsm_eps_ns.py) against the
exact Cholesky eps step, and the factor fitters' trajectory contracts:
chunking, monitor cadence and resume change nothing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsmvi_jax import FactorBaM, FactorGSM, Regularizers
from gsmvi_jax.models import (banana, dense_gaussian, funnel,
                              gaussian_mixture, logistic_regression,
                              student_t)
from gsmvi_jax.ops.gsm_eps import apply_eps_step
from gsmvi_jax.ops.gsm_eps_ns import gsm_eps_update_ns_xla, ns_iters_for_batch

D = 16

TARGETS = {
    "gaussian": lambda: dense_gaussian(jax.random.PRNGKey(1), D, scale=0.3),
    "student_t": lambda: student_t(jax.random.PRNGKey(2), D, df=6.0),
    "mixture": lambda: gaussian_mixture(jax.random.PRNGKey(3), D,
                                        n_components=3),
    "funnel": lambda: funnel(D),
    "banana": lambda: banana(D),
    "logreg": lambda: logistic_regression(jax.random.PRNGKey(4), D,
                                          n_data=40),
}


def _step_inputs(t, b, seed=0):
    rng = np.random.default_rng(seed)
    eps = jnp.asarray(rng.standard_normal((b, D)), jnp.float32)
    f = jnp.asarray(0.5 * np.eye(D) + 0.02 * rng.standard_normal((D, D)),
                    jnp.float32)
    mu = jnp.asarray(0.1 * rng.standard_normal(D), jnp.float32)
    with jax.default_matmul_precision("float32"):
        vs = t.lp_g(mu + eps @ f.T).astype(jnp.float32)
    return eps, vs, mu, f


@pytest.mark.parametrize("kind", sorted(TARGETS))
def test_ns_step_matches_chol_step_on_zoo_target(kind):
    """One step on each zoo target's score: the Newton-Schulz small space
    reproduces the exact Cholesky eps step to its chains' accuracy."""
    t = TARGETS[kind]()
    eps, vs, mu, f = _step_inputs(t, 8)
    mc, fc, gc = apply_eps_step(mu, f, eps, vs)
    mn, fn, gn = gsm_eps_update_ns_xla(eps, vs, mu, f)
    assert bool(gc) and bool(gn)
    sc, sn = np.asarray(fc @ fc.T), np.asarray(fn @ fn.T)
    scale = max(1.0, float(np.abs(sc).max()))
    np.testing.assert_allclose(sn, sc, atol=2e-4 * scale)
    np.testing.assert_allclose(np.asarray(mn), np.asarray(mc),
                               atol=2e-4 * max(1.0, float(np.abs(
                                   np.asarray(mc)).max())))


def test_ns_residual_gates_reject_unconverged_sweeps():
    """Chains cut to one sweep each cannot meet the residual gates: the
    step is rejected and the old state comes back unchanged."""
    t = TARGETS["gaussian"]()
    eps, vs, mu, f = _step_inputs(t, 8)
    mn, fn, good = gsm_eps_update_ns_xla(eps, vs, mu, f,
                                         iters=(1, 1, 1, 1, 1))
    assert not bool(good)
    np.testing.assert_array_equal(np.asarray(mn), np.asarray(mu))
    np.testing.assert_array_equal(np.asarray(fn), np.asarray(f))


@pytest.mark.parametrize("b", [8, 64])
def test_ns_default_iters_follow_the_batch(b):
    """Called with no ``iters``, the op uses the batch-aware profile (the
    short one biases silently at B >= 64)."""
    t = TARGETS["gaussian"]()
    eps, vs, mu, f = _step_inputs(t, b)
    got = gsm_eps_update_ns_xla(eps, vs, mu, f)
    want = gsm_eps_update_ns_xla(eps, vs, mu, f,
                                 iters=ns_iters_for_batch(b))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _fitter(kind, t):
    if kind == "gsm":
        return FactorGSM(D=t.d, lp=t.lp, lp_g=t.lp_g), ()
    return (FactorBaM(D=t.d, lp=t.lp, lp_g=t.lp_g),
            (Regularizers().linear(20.0),))


class _Mon:
    checkpoint = 7

    def __call__(self, i, params, lp, key, nevals=1):
        return key


def _same_state(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("kind", ["gsm", "bam"])
def test_factor_trajectory_invariant_to_program_chunking(monkeypatch, kind):
    """Capping device programs at 9 steps changes no bit of the fit."""
    t = TARGETS["gaussian"]()
    g, args = _fitter(kind, t)
    kw = dict(niter=40, batch_size=8, verbose=False, return_state=True)
    ref = g.fit(jax.random.PRNGKey(0), *args, **kw)
    monkeypatch.setenv("GSMVI_MAX_STEPS_PER_CALL", "9")
    capped = g.fit(jax.random.PRNGKey(0), *args, **kw)
    _same_state(ref, capped)


@pytest.mark.parametrize("kind", ["gsm", "bam"])
def test_factor_trajectory_invariant_to_monitor_cadence(kind):
    t = TARGETS["gaussian"]()
    g, args = _fitter(kind, t)
    kw = dict(niter=40, batch_size=8, verbose=False, return_state=True)
    ref = g.fit(jax.random.PRNGKey(0), *args, **kw)
    mon = g.fit(jax.random.PRNGKey(0), *args, monitor=_Mon(), **kw)
    _same_state(ref, mon)


@pytest.mark.parametrize("kind", ["gsm", "bam"])
def test_factor_resume_is_exact(kind):
    """A 20-update fit resumed for 21 more through ``state=`` equals one
    41-update fit (``niter`` runs niter + 1 updates)."""
    t = TARGETS["gaussian"]()
    g, args = _fitter(kind, t)
    kw = dict(batch_size=8, verbose=False, return_state=True)
    full = g.fit(jax.random.PRNGKey(0), *args, niter=40, **kw)
    half = g.fit(jax.random.PRNGKey(0), *args, niter=19, **kw)
    rest = g.fit(jax.random.PRNGKey(9), *args, niter=20, state=half, **kw)
    assert int(rest.step) == int(full.step) == 41
    _same_state(full, rest)
