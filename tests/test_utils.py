"""Profiling helpers and orbax checkpoint backend."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsmvi_jax import GSM
from gsmvi_jax.models import dense_gaussian
from gsmvi_jax.utils.profiling import fit_throughput, nan_debug, time_fn


def test_time_fn_returns_positive():
    f = jax.jit(lambda x: x @ x)
    x = jnp.ones((64, 64))
    dt = time_fn(f, x, warmup=1, iters=3)
    assert dt > 0


def test_fit_throughput():
    t = dense_gaussian(jax.random.PRNGKey(0), 4)
    gsm = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    stats = fit_throughput(
        lambda: gsm.fit(jax.random.PRNGKey(0), niter=20, batch_size=2,
                        verbose=False),
        niter=20, batch_size=2)
    assert stats["iters_per_s"] > 0
    assert stats["score_evals_per_s"] == pytest.approx(
        2 * stats["iters_per_s"])


def test_nan_debug_toggle():
    assert not jax.config.jax_debug_nans
    with nan_debug(True):
        assert jax.config.jax_debug_nans
    assert not jax.config.jax_debug_nans


def test_orbax_checkpoint_roundtrip(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    from gsmvi_jax.utils.checkpoint import restore_orbax, save_orbax

    t = dense_gaussian(jax.random.PRNGKey(0), 4)
    gsm = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g)
    state = gsm.fit(jax.random.PRNGKey(0), niter=5, batch_size=2,
                    verbose=False, return_state=True)
    path = str(tmp_path / "orbax_ckpt")
    save_orbax(path, state)
    restored = restore_orbax(path)
    np.testing.assert_array_equal(np.asarray(state.mean),
                                  np.asarray(restored.mean))
    np.testing.assert_array_equal(np.asarray(state.cov),
                                  np.asarray(restored.cov))
