"""API surface parity with the reference (import paths, signatures, defaults).

Reference users must be able to switch with their call sites unchanged:
``from gsmvi.gsm import GSM`` -> ``from gsmvi_jax.gsm import GSM`` etc.
"""

import inspect


def test_reference_style_imports():
    from gsmvi_jax.gsm import GSM            # noqa: F401
    from gsmvi_jax.bam import BaM, Regularizers  # noqa: F401
    from gsmvi_jax.advi import ADVI          # noqa: F401
    from gsmvi_jax.utils.monitors import KLMonitor  # noqa: F401
    from gsmvi_jax.utils.initializers import lbfgs_init  # noqa: F401
    from gsmvi_jax.compat.gsm_numpy import GSM as NumpyGSM  # noqa: F401


def test_gsm_fit_defaults_match_reference():
    """Reference: fit(key, mean=None, cov=None, batch_size=2, niter=5000,
    nprint=10, verbose=True, check_goodness=True, monitor=None)
    (gsmvi/gsm.py:79)."""
    from gsmvi_jax.gsm import GSM

    sig = inspect.signature(GSM.fit)
    p = sig.parameters
    assert list(p)[:10] == ["self", "key", "mean", "cov", "batch_size",
                            "niter", "nprint", "verbose", "check_goodness",
                            "monitor"]
    assert p["batch_size"].default == 2
    assert p["niter"].default == 5000
    assert p["nprint"].default == 10
    assert p["verbose"].default is True


def test_bam_fit_defaults_match_reference():
    """Reference: fit(key, regf, ..., retries=10, jitter=1e-6)
    (gsmvi/bam.py:140)."""
    from gsmvi_jax.bam import BaM

    sig = inspect.signature(BaM.fit)
    p = sig.parameters
    assert list(p)[:3] == ["self", "key", "regf"]
    assert p["retries"].default == 10
    assert p["jitter"].default == 1e-6
    assert p["batch_size"].default == 2


def test_bam_ctor_flags():
    from gsmvi_jax.bam import BaM

    p = inspect.signature(BaM.__init__).parameters
    assert p["use_lowrank"].default is False
    assert p["jit_compile"].default is True


def test_advi_signatures():
    """Reference: ADVI(D, lp); fit(key, opt, ..., batch_size=8)
    (gsmvi/advi.py:14,47 — reference default batch_size is 8)."""
    from gsmvi_jax.advi import ADVI

    ctor = inspect.signature(ADVI.__init__).parameters
    assert list(ctor)[:3] == ["self", "D", "lp"]
    fit = inspect.signature(ADVI.fit).parameters
    assert list(fit)[:3] == ["self", "key", "opt"]
    assert fit["batch_size"].default == 8


def test_monitor_attributes():
    from gsmvi_jax.utils.monitors import KLMonitor

    mon = KLMonitor()
    assert mon.batch_size_kl == 8
    assert mon.checkpoint == 20
    assert mon.offset_evals == 0
    assert mon.ref_samples is None
    assert mon.rkl == [] and mon.fkl == [] and mon.nevals == []
    assert callable(mon.reset)


def test_regularizer_api():
    from gsmvi_jax.bam import Regularizers

    r = Regularizers()
    assert hasattr(r, "counter") and r.counter == 0
    for name in ("constant", "linear", "custom", "reset"):
        assert callable(getattr(r, name))
