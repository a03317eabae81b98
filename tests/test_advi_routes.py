"""ADVI's compiled fit with both gradient estimators: the trajectory does not
depend on how the fit is cut into device programs or on the monitor cadence,
replica fits equal single fits, and STL reverts a non-finite step."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from gsmvi_jax import ADVI
from gsmvi_jax.models import dense_gaussian


@pytest.fixture(scope="module")
def target():
    return dense_gaussian(jax.random.PRNGKey(7), 4)


class _Mon:
    checkpoint = 9

    def __call__(self, i, params, lp, key, nevals=1):
        return key


def _fit(advi, **kw):
    kw.setdefault("niter", 60)
    return advi.fit(jax.random.PRNGKey(3), optax.adam(1e-2), batch_size=8,
                    verbose=False, return_state=True, **kw)


@pytest.mark.parametrize("estimator", ["analytic", "stl"])
def test_fit_invariant_to_program_chunking(target, estimator):
    advi = ADVI(D=target.d, lp=target.lp)
    st, losses = _fit(advi, estimator=estimator)
    st_c, losses_c = _fit(advi, estimator=estimator, max_steps_per_call=7)
    np.testing.assert_array_equal(losses, losses_c)
    np.testing.assert_array_equal(np.asarray(st.loc), np.asarray(st_c.loc))
    np.testing.assert_array_equal(np.asarray(st.scales),
                                  np.asarray(st_c.scales))


@pytest.mark.parametrize("estimator", ["analytic", "stl"])
def test_fit_invariant_to_monitor_cadence(target, estimator):
    advi = ADVI(D=target.d, lp=target.lp)
    st, losses = _fit(advi, estimator=estimator)
    st_m, losses_m = _fit(advi, estimator=estimator, monitor=_Mon())
    np.testing.assert_array_equal(losses, losses_m)
    np.testing.assert_array_equal(np.asarray(st.scales),
                                  np.asarray(st_m.scales))


def test_fit_takes_an_optax_schedule(target):
    sched = optax.exponential_decay(3e-2, transition_steps=200,
                                    decay_rate=0.5)
    advi = ADVI(D=target.d, lp=target.lp)
    mean, cov, losses = advi.fit(jax.random.PRNGKey(0), optax.adam(sched),
                                 batch_size=16, niter=2000, verbose=False)
    assert np.isfinite(losses).all()
    assert losses[-200:].mean() < losses[:200].mean()
    np.testing.assert_allclose(np.asarray(mean), np.asarray(target.mean),
                               atol=0.3)


def test_fit_batch_replica_matches_single_fit(target):
    advi = ADVI(D=target.d, lp=target.lp)
    opt = optax.adam(1e-2)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    means, covs, losses = advi.fit_batch(keys, opt, batch_size=8, niter=40)
    m1, c1, l1 = advi.fit(keys[1], opt, batch_size=8, niter=40,
                          verbose=False)
    np.testing.assert_allclose(np.asarray(means[1]), np.asarray(m1),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(covs[1]), np.asarray(c1),
                               atol=1e-10)
    np.testing.assert_allclose(losses[1], l1, atol=1e-8)


@pytest.mark.parametrize("estimator,reverts", [("stl", True),
                                               ("analytic", False)])
def test_nonfinite_step_revert_is_stl_only(target, estimator, reverts):
    """STL reverts a step whose update is non-finite; the analytic
    estimator keeps the reference's accept-every-step behaviour."""
    d = target.d
    lp = lambda x: jnp.sum(-0.5 * x * x, axis=-1) * jnp.nan
    advi = ADVI(D=d, lp=lp)
    st, _ = advi.fit(jax.random.PRNGKey(0), optax.adam(1e-2), batch_size=4,
                     niter=3, verbose=False, return_state=True,
                     estimator=estimator)
    finite = bool(np.isfinite(np.asarray(st.loc)).all())
    assert finite is reverts
    if reverts:
        np.testing.assert_array_equal(np.asarray(st.loc), np.zeros(d))
