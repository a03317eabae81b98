"""KLMonitor: hook protocol, nevals bookkeeping, forward-KL, NaN fallback."""

import jax
import numpy as np
import pytest

from gsmvi_jax import GSM, KLMonitor
from gsmvi_jax.models import dense_gaussian
from gsmvi_jax.utils.monitors import forward_kl, reverse_kl


@pytest.fixture(scope="module")
def target():
    return dense_gaussian(jax.random.PRNGKey(11), 8)


def test_rkl_decreases_during_fit(target):
    t = target
    mon = KLMonitor(batch_size_kl=64, checkpoint=50)
    gsm = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    gsm.fit(jax.random.PRNGKey(2), niter=400, batch_size=8, verbose=False,
            monitor=mon)
    assert len(mon.rkl) == len(mon.nevals) == 10  # i=0,50,...,400 + final
    assert mon.rkl[-1] < mon.rkl[0]
    assert mon.rkl[-1] < 0.05


def test_nevals_bookkeeping(target):
    """nevals is cumulative gradient evaluations with reference semantics:
    starts at 1, accumulates batch_size per iteration, carries offset
    (gsmvi/gsm.py:105,123 + gsmvi/monitors.py:122-123)."""
    t = target
    mon = KLMonitor(batch_size_kl=8, checkpoint=10, offset_evals=100)
    gsm = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    gsm.fit(jax.random.PRNGKey(2), niter=20, batch_size=4, verbose=False,
            monitor=mon)
    # calls at i=0 (nevals=1), i=10 (+40), i=20 (+40), final i=20 (+4)
    assert mon.nevals == [101, 141, 181, 185]


def test_forward_kl_with_ref_samples(target):
    t = target
    ref = np.asarray(t.ref_samples(jax.random.PRNGKey(3), 1000))
    mon = KLMonitor(batch_size_kl=32, checkpoint=100, ref_samples=ref)
    gsm = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    gsm.fit(jax.random.PRNGKey(2), niter=300, batch_size=8, verbose=False,
            monitor=mon)
    assert np.isfinite(mon.fkl).all()
    assert mon.fkl[-1] < mon.fkl[0]


def test_fkl_nan_without_ref_samples(target):
    t = target
    mon = KLMonitor(batch_size_kl=8, checkpoint=100)
    gsm = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    gsm.fit(jax.random.PRNGKey(2), niter=100, batch_size=2, verbose=False,
            monitor=mon)
    assert np.isnan(mon.fkl).all()
    assert np.isfinite(mon.rkl).all()


def test_exception_appends_nan(target):
    """Invalid covariance -> NaN appended, no raise (gsmvi/monitors.py:117-120)."""
    t = target
    mon = KLMonitor(batch_size_kl=8, checkpoint=1)
    bad_cov = -np.eye(t.d)
    mon(0, [np.zeros(t.d), bad_cov], t.lp, jax.random.PRNGKey(0), nevals=1)
    assert np.isnan(mon.rkl[-1]) and np.isnan(mon.fkl[-1])
    assert mon.nevals == [1]


def test_reset():
    mon = KLMonitor(batch_size_kl=8, checkpoint=10)
    mon.rkl = [1.0]
    mon.reset(batch_size_kl=16, offset_evals=5)
    assert mon.rkl == [] and mon.batch_size_kl == 16 and mon.offset_evals == 5


def test_standalone_estimators(target):
    t = target
    samples = np.asarray(t.ref_samples(jax.random.PRNGKey(4), 2000))

    def lpq(x):
        return np.asarray(t.lp(x))  # q == p here

    assert reverse_kl(samples, lpq, lpq) == pytest.approx(0.0)
    assert forward_kl(samples, lpq, lpq) == pytest.approx(0.0)


def test_monitor_returns_key(target):
    t = target
    mon = KLMonitor(batch_size_kl=4, checkpoint=1)
    key = jax.random.PRNGKey(0)
    new_key = mon(0, [np.asarray(t.mean), np.asarray(t.cov)], t.lp, key, nevals=1)
    assert not np.array_equal(np.asarray(new_key), np.asarray(key))


def test_monitor_with_advi(target):
    """ADVI honors the monitor protocol incl. the scales->cov conversion at
    checkpoints (reference gsmvi/advi.py:93-98)."""
    import optax
    from gsmvi_jax import ADVI

    t = target
    mon = KLMonitor(batch_size_kl=32, checkpoint=100)
    advi = ADVI(D=t.d, lp=t.lp)
    advi.fit(jax.random.PRNGKey(1), optax.adam(1e-2), batch_size=16,
             niter=300, verbose=False, monitor=mon)
    assert len(mon.rkl) == 5  # i=0,100,200,300 + final
    assert mon.rkl[-1] < mon.rkl[0]


def test_monitor_with_bam(target):
    from gsmvi_jax import BaM, Regularizers

    t = target
    mon = KLMonitor(batch_size_kl=32, checkpoint=50)
    bam = BaM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    bam.fit(jax.random.PRNGKey(1), regf=Regularizers().linear(100.0),
            niter=100, batch_size=8, verbose=False, monitor=mon)
    assert len(mon.rkl) == 4
    assert mon.rkl[-1] < mon.rkl[0]


def test_monitor_with_eager_numpy_path(target):
    """Monitor + eager host loop (non-traceable lp_g) work together."""
    t = target
    mean_np = np.asarray(t.mean)
    prec = np.linalg.inv(np.asarray(t.cov))

    def lp_g_np(x):
        return -(np.asarray(x) - mean_np) @ prec

    mon = KLMonitor(batch_size_kl=16, checkpoint=50)
    gsm = GSM(D=t.d, lp=t.lp, lp_g=lp_g_np)
    gsm.fit(jax.random.PRNGKey(1), niter=100, batch_size=8, verbose=False,
            monitor=mon)
    assert len(mon.rkl) == 4
    assert mon.rkl[-1] < mon.rkl[0]


def test_monitor_store_params(target):
    t = target
    mon = KLMonitor(batch_size_kl=8, checkpoint=50, store_params=True)
    gsm = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    gsm.fit(jax.random.PRNGKey(1), niter=100, batch_size=4, verbose=False,
            monitor=mon)
    assert len(mon.params_trace) == len(mon.rkl)
    m0, c0 = mon.params_trace[0]
    assert m0.shape == (t.d,) and c0.shape == (t.d, t.d)


def test_monitor_ledgers_stay_aligned_when_lp_fails_mid_checkpoint():
    """Regression: an exception AFTER rkl.append (lp raising on the
    forward-KL reference samples) must yield exactly one (NaN) entry per
    ledger, not a double rkl append that desyncs rkl/fkl/nevals."""
    import jax

    from gsmvi_jax.utils.monitors import KLMonitor

    calls = {"n": 0}

    def flaky_lp(x):
        calls["n"] += 1
        if calls["n"] > 1:          # first call (reverse KL) ok, second dies
            raise RuntimeError("boom")
        return np.zeros(x.shape[0])

    mon = KLMonitor(batch_size_kl=8, checkpoint=1,
                    ref_samples=np.random.default_rng(0).normal(size=(32, 4)))
    mon(0, [np.zeros(4), np.eye(4)], flaky_lp, jax.random.PRNGKey(0),
        nevals=1)
    assert len(mon.rkl) == 1 and len(mon.fkl) == 1 and len(mon.nevals) == 1
    assert np.isnan(mon.rkl[0]) and np.isnan(mon.fkl[0])
