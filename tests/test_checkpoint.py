"""Checkpoint/resume: saved state resumes the exact trajectory."""

import jax
import pytest
import numpy as np

from gsmvi_jax import GSM
from gsmvi_jax.models import dense_gaussian
from gsmvi_jax.utils.checkpoint import load_state, save_state


def test_save_load_roundtrip(tmp_path):
    t = dense_gaussian(jax.random.PRNGKey(31), 6)
    gsm = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    state = gsm.fit(jax.random.PRNGKey(0), niter=20, batch_size=4,
                    verbose=False, return_state=True)
    path = str(tmp_path / "ckpt")
    save_state(path, state)
    restored = load_state(path)
    for a, b in zip(state, restored):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_resume_continues_trajectory(tmp_path):
    """fit(40) == fit(20) -> save -> load -> fit(19 more) (41 = 40+1 updates:
    each fit call runs niter+1 updates, so 21 + 20 == 41)."""
    t = dense_gaussian(jax.random.PRNGKey(31), 6)
    gsm = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g)

    full = gsm.fit(jax.random.PRNGKey(7), niter=40, batch_size=4,
                   verbose=False, return_state=True)

    half = gsm.fit(jax.random.PRNGKey(7), niter=20, batch_size=4,
                   verbose=False, return_state=True)
    path = str(tmp_path / "ckpt")
    save_state(path, half)
    loaded = load_state(path)
    resumed = gsm.fit(loaded.key, mean=loaded.mean, cov=loaded.cov,
                      niter=19, batch_size=4, verbose=False,
                      return_state=True)
    np.testing.assert_allclose(np.asarray(resumed.mean), np.asarray(full.mean),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(resumed.cov), np.asarray(full.cov),
                               atol=1e-12)


def test_resume_via_state_kwarg(tmp_path):
    """fit(state=loaded) continues the trajectory exactly (incl. key/counters)."""
    t = dense_gaussian(jax.random.PRNGKey(31), 6)
    gsm = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    full = gsm.fit(jax.random.PRNGKey(7), niter=40, batch_size=4,
                   verbose=False, return_state=True)
    half = gsm.fit(jax.random.PRNGKey(7), niter=20, batch_size=4,
                   verbose=False, return_state=True)
    path = str(tmp_path / "ck")
    save_state(path, half)
    resumed = gsm.fit(None, niter=19, batch_size=4, verbose=False,
                      state=load_state(path), return_state=True)
    np.testing.assert_allclose(np.asarray(resumed.mean), np.asarray(full.mean),
                               atol=1e-12)
    assert int(resumed.step) == int(full.step)


def test_factor_state_roundtrip_resumes_exactly(tmp_path):
    """save_state on a FactorVIState must persist the REAL fields
    (factor/finv) and load back a state that resumes the FactorGSM
    trajectory exactly (regression: the generic path silently saved the
    materialized cov/chol properties and load crashed resume)."""
    import jax

    from gsmvi_jax import FactorGSM
    from gsmvi_jax.gsm_factor import FactorVIState
    from gsmvi_jax.models import dense_gaussian
    from gsmvi_jax.utils.checkpoint import load_state, save_state

    t = dense_gaussian(jax.random.PRNGKey(0), 8)
    fg = FactorGSM(D=8, lp=t.lp, lp_g=t.lp_g)
    mid = fg.fit(jax.random.PRNGKey(1), niter=40, batch_size=8,
                 verbose=False, return_state=True)
    p = str(tmp_path / "factor_ckpt")
    save_state(p, mid)
    back = load_state(p)
    assert isinstance(back, FactorVIState)
    np.testing.assert_array_equal(np.asarray(back.factor),
                                  np.asarray(mid.factor))

    full = fg.fit(jax.random.PRNGKey(1), niter=80, batch_size=8,
                  verbose=False, return_state=True)
    resumed = fg.fit(jax.random.PRNGKey(99), niter=39, batch_size=8,
                     verbose=False, state=back, return_state=True)
    np.testing.assert_allclose(np.asarray(resumed.mean),
                               np.asarray(full.mean), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(np.asarray(resumed.factor),
                               np.asarray(full.factor), rtol=1e-6, atol=1e-8)


def test_orbax_roundtrip_and_resume(tmp_path):
    """Orbax backend round-trip (VERDICT r2 item #7: this path had never
    executed under test): save -> restore equals the npz-restored state
    field-for-field and resumes the exact trajectory."""
    pytest.importorskip("orbax.checkpoint")
    from gsmvi_jax.utils.checkpoint import restore_orbax, save_orbax

    t = dense_gaussian(jax.random.PRNGKey(31), 6)
    gsm = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    full = gsm.fit(jax.random.PRNGKey(7), niter=40, batch_size=4,
                   verbose=False, return_state=True)
    half = gsm.fit(jax.random.PRNGKey(7), niter=20, batch_size=4,
                   verbose=False, return_state=True)
    path = str(tmp_path / "orbax_ckpt")
    save_orbax(path, half)
    restored = restore_orbax(path)
    for a, b in zip(half, restored):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    resumed = gsm.fit(None, niter=19, batch_size=4, verbose=False,
                      state=restored, return_state=True)
    np.testing.assert_allclose(np.asarray(resumed.mean),
                               np.asarray(full.mean), atol=1e-12)
    assert int(resumed.step) == int(full.step)
