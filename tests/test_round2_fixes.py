"""Regression tests for the round-2 review fixes.

Each test here pins a specific defect found by the round-1 review:
- ``save_state`` crashed on new-style typed PRNG keys (ADVICE medium).
- ``KLMonitor`` raised (instead of recording) when handed the int seed the
  numpy-compat fitter passes (ADVICE low).
- ``id()``-keyed compiled-runner caches could replay a stale closure after
  the keyed object was garbage collected and its id reused (VERDICT weak #4).
- ``FactorGSM.fit`` lacked the ``state=`` resume kwarg (VERDICT weak #8).
- ``ADVI.fit`` duplicated the driver's event loop (VERDICT weak #5) — now it
  runs on ``run_fit_loop(collect_aux=True)``; cadence semantics are asserted.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from gsmvi_jax import ADVI, BaM, GSM, FactorGSM, Regularizers
from gsmvi_jax.models import dense_gaussian
from gsmvi_jax.state import init_state
from gsmvi_jax.utils.checkpoint import load_state, save_state
from gsmvi_jax.utils.monitors import KLMonitor


@pytest.fixture(scope="module")
def target():
    return dense_gaussian(jax.random.PRNGKey(3), 8)


def test_save_state_typed_prng_key(tmp_path, target):
    """ADVICE medium: typed jax.random.key() state must round-trip."""
    state = init_state(jax.random.key(7), 8)
    path = str(tmp_path / "typed_key")
    save_state(path, state)
    restored = load_state(path)
    assert jnp.issubdtype(restored.key.dtype, jax.dtypes.prng_key)
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(restored.key)),
        np.asarray(jax.random.key_data(state.key)))
    # and a fit resumes from it
    gsm = GSM(D=8, lp=target.lp, lp_g=target.lp_g)
    mean, cov = gsm.fit(None, niter=3, batch_size=4, verbose=False,
                        state=restored)
    assert np.isfinite(np.asarray(mean)).all()


def test_monitor_accepts_int_seed(target):
    """ADVICE low: the numpy-compat fitter passes an int where JAX fitters
    pass a PRNG key; the monitor must record KL, not raise/NaN."""
    mon = KLMonitor(batch_size_kl=16, checkpoint=5)
    mon(0, [np.zeros(8), np.eye(8)], target.lp, 3, nevals=1)
    mon(5, [np.zeros(8), np.eye(8)], target.lp, np.int64(4), nevals=10)
    assert len(mon.rkl) == 2
    assert np.isfinite(mon.rkl).all()


def test_monitored_numpy_compat_fit(target):
    """End-to-end: the zero-dep numpy fitter with a monitor attached."""
    from gsmvi_jax.compat.gsm_numpy import GSM as NpGSM

    lp = lambda x: np.asarray(target.lp(x))
    lp_g = lambda x: np.asarray(target.lp_g(x))
    mon = KLMonitor(batch_size_kl=16, checkpoint=10)
    fitter = NpGSM(D=8, lp=lp, lp_g=lp_g)
    mean, cov = fitter.fit(0, niter=20, batch_size=4, verbose=False,
                           monitor=mon)
    assert len(mon.rkl) >= 2
    assert np.isfinite(mon.rkl).all()



def test_bam_runner_cache_pins_regf(target):
    """VERDICT weak #4: the cache must hold a strong ref to the schedule so
    a GC'd schedule's id can never alias a new object's id."""
    bam = BaM(D=8, lp=target.lp, lp_g=target.lp_g)
    regf = Regularizers().constant(5.0)
    ref = weakref.ref(regf)
    bam.fit(jax.random.PRNGKey(0), regf=regf, niter=2, batch_size=4,
            verbose=False)
    del regf
    gc.collect()
    assert ref() is not None, "cached schedule was garbage collected"
    assert bam._runners.holds(ref())


def test_advi_runner_cache_pins_opt(target):
    advi = ADVI(D=8, lp=target.lp)
    opt = optax.adam(1e-2)
    # optax transforms are NamedTuples (not weakref-able); track the inner
    # update fn, which stays alive iff the cache pins the transform.
    ref = weakref.ref(opt.update)
    advi.fit(jax.random.PRNGKey(0), opt, niter=2, batch_size=4, verbose=False)
    del opt
    gc.collect()
    assert ref() is not None, "cached optimizer was garbage collected"
    assert any(any(getattr(o, "update", None) is ref() for o in objs)
               for objs, _ in advi._runners._entries.values())


def test_runner_cache_distinguishes_schedules(target):
    """Two different schedules through the same fitter give different fits."""
    bam = BaM(D=8, lp=target.lp, lp_g=target.lp_g)
    m1, c1 = bam.fit(jax.random.PRNGKey(0), regf=Regularizers().constant(100.0),
                     niter=10, batch_size=8, verbose=False)
    m2, c2 = bam.fit(jax.random.PRNGKey(0), regf=Regularizers().constant(0.01),
                     niter=10, batch_size=8, verbose=False)
    assert not np.allclose(np.asarray(c1), np.asarray(c2))


def test_runner_cache_bounded():
    from gsmvi_jax.driver import RunnerCache

    cache = RunnerCache(maxsize=3)
    objs = [object() for _ in range(5)]
    for i, o in enumerate(objs):
        cache.get((i,), (o,), lambda: (lambda s, k: s))
    assert len(cache._entries) == 3
    assert not cache.holds(objs[0])  # FIFO-evicted
    assert cache.holds(objs[-1])


def test_factor_gsm_state_resume(target):
    """VERDICT weak #8: FactorGSM resume must continue the exact trajectory."""
    fg = FactorGSM(D=8, lp=target.lp, lp_g=target.lp_g)
    full = fg.fit(jax.random.PRNGKey(1), niter=20, batch_size=4,
                  verbose=False, return_state=True)
    half = fg.fit(jax.random.PRNGKey(1), niter=10, batch_size=4,
                  verbose=False, return_state=True)
    resumed = fg.fit(None, niter=9, batch_size=4, verbose=False,
                     state=half, return_state=True)
    np.testing.assert_allclose(np.asarray(resumed.mean), np.asarray(full.mean),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(resumed.factor),
                               np.asarray(full.factor), rtol=1e-10, atol=1e-12)


def test_advi_on_shared_driver_cadence(target):
    """VERDICT weak #5: ADVI now runs on run_fit_loop; monitor cadence and the
    loss trace must match the reference protocol (one call per checkpoint
    multiple plus one final, losses length niter+1)."""
    mon = KLMonitor(batch_size_kl=8, checkpoint=7)
    advi = ADVI(D=8, lp=target.lp)
    mean, cov, losses = advi.fit(jax.random.PRNGKey(0), optax.adam(1e-2),
                                 niter=20, batch_size=8, verbose=False,
                                 monitor=mon)
    assert losses.shape == (21,)
    assert np.isfinite(losses).all()
    # checkpoints at i=0,7,14 plus the final call at i=niter
    assert len(mon.rkl) == 4
    # nevals cost axis: cumulative, batch_size per iteration
    assert mon.nevals[-1] == 21 * 8 + 1


def test_advi_losses_identical_to_inline_loop(target):
    """The driver rewrite must not change the computation: two fits with the
    same key/opt agree bitwise across chunk boundaries (monitor on/off changes
    chunking but not the trajectory)."""
    advi = ADVI(D=8, lp=target.lp)
    opt = optax.adam(1e-2)
    _, _, l1 = advi.fit(jax.random.PRNGKey(5), opt, niter=20, batch_size=8,
                        verbose=False)
    mon = KLMonitor(batch_size_kl=4, checkpoint=3)
    _, _, l2 = advi.fit(jax.random.PRNGKey(5), opt, niter=20, batch_size=8,
                        verbose=False, monitor=mon)
    np.testing.assert_array_equal(l1, l2)
