"""Loop driver: event scheduling, monitor cadence parity, nprint clamping."""

import jax
import jax.numpy as jnp

from gsmvi_jax.driver import _next_event, is_traceable, run_fit_loop
from gsmvi_jax.state import init_state


class RecordingMonitor:
    def __init__(self, checkpoint):
        self.checkpoint = checkpoint
        self.calls = []

    def __call__(self, i, params, lp, key, nevals=1):
        self.calls.append((i, nevals))


def _counting_step(state):
    return state._replace(step=state.step + 1)


def test_monitor_call_pattern_matches_reference():
    """Reference pattern (gsmvi/gsm.py:107-132): calls at i % cp == 0 within
    range(niter+1), plus one final call at i=niter."""
    mon = RecordingMonitor(checkpoint=10)
    state = init_state(jax.random.PRNGKey(0), 3)
    run_fit_loop(_counting_step, state, 25, monitor=mon, nprint=0,
                 verbose=False, batch_size=2)
    iters = [c[0] for c in mon.calls]
    assert iters == [0, 10, 20, 25]


def test_nevals_pattern():
    """nevals: 1 at first call, then batch_size * iters since last call."""
    mon = RecordingMonitor(checkpoint=10)
    state = init_state(jax.random.PRNGKey(0), 3)
    run_fit_loop(_counting_step, state, 25, monitor=mon, nprint=0,
                 verbose=False, batch_size=3)
    assert [c[1] for c in mon.calls] == [1, 30, 30, 18]


def test_total_updates_is_niter_plus_one():
    state = init_state(jax.random.PRNGKey(0), 3)
    out = run_fit_loop(_counting_step, state, 17, verbose=False)
    assert int(out.step) == 18


def test_nprint_larger_than_niter_does_not_crash(capsys):
    """Reference quirk fixed: ZeroDivisionError when nprint > niter
    (gsmvi/gsm.py:108); we clamp like BaM (gsmvi/bam.py:177)."""
    state = init_state(jax.random.PRNGKey(0), 3)
    run_fit_loop(_counting_step, state, 3, nprint=10, verbose=True)
    assert "Iteration 0 of 3" in capsys.readouterr().out


def test_misaligned_cadences():
    """checkpoint=7 with print cadence 5: all checkpoint multiples hit."""
    mon = RecordingMonitor(checkpoint=7)
    state = init_state(jax.random.PRNGKey(0), 3)
    run_fit_loop(_counting_step, state, 20, monitor=mon, nprint=4,
                 verbose=True, batch_size=1)
    assert [c[0] for c in mon.calls] == [0, 7, 14, 20]


def test_next_event():
    assert _next_event(0, 100, (10, None)) == 10
    assert _next_event(10, 100, (10, 7)) == 14
    assert _next_event(98, 100, (10, None)) == 100


def test_is_traceable():
    import numpy as np
    probe = jax.ShapeDtypeStruct((2, 3), jnp.float32)
    assert is_traceable(lambda x: x * 2, probe)
    assert not is_traceable(lambda x: np.linalg.cholesky(np.asarray(x)), probe)


def test_monitor_keys_differ_per_checkpoint_even_with_constant_state_key():
    """A state whose key stays constant (a seed base indexed by the step
    counter) must still hand each monitor checkpoint an independent key
    (regression: identical keys gave correlated KL draws)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gsmvi_jax.driver import run_fit_loop

    def step(state):  # never advances the key
        return state._replace(step=state.step + 1)

    import typing

    class S(typing.NamedTuple):
        key: jax.Array
        step: jax.Array

    seen = []

    class Mon:
        checkpoint = 5

        def __call__(self, i, params, lp, key, nevals=0):
            seen.append(np.asarray(jax.random.key_data(key)).copy()
                        if jnp.issubdtype(key.dtype, jax.dtypes.prng_key)
                        else np.asarray(key).copy())

    s0 = S(jax.random.PRNGKey(7), jnp.zeros((), jnp.int32))
    # niter IS a checkpoint multiple: the protocol's extra final call at
    # i=niter folds index niter+1, so even the collision case yields
    # distinct keys.
    run_fit_loop(step, s0, 20, monitor=Mon(), verbose=False,
                 monitor_params=lambda s: [s.step])
    assert len(seen) >= 4
    uniq = {tuple(k.ravel().tolist()) for k in seen}
    assert len(uniq) == len(seen), "monitor received duplicate PRNG keys"


def test_max_steps_per_call_caps_device_program_length():
    """Runtimes with a wall-time limit on one device program need a cap;
    the loop must bound each run_chunk call at max_steps_per_call with an
    UNCHANGED trajectory (chunking is pure control flow)."""
    state = init_state(jax.random.PRNGKey(0), 3)
    sizes = []

    def chunk(s, k):
        sizes.append(k)
        for _ in range(k):
            s = _counting_step(s)
        return s

    out = run_fit_loop(None, state, 24, verbose=False, run_chunk=chunk,
                       max_steps_per_call=10)
    assert sizes == [10, 10, 5]
    assert int(out.step) == 25

    # cadence boundaries still honored, cap interleaves with them
    mon = RecordingMonitor(checkpoint=12)
    sizes.clear()
    run_fit_loop(None, init_state(jax.random.PRNGKey(0), 3), 24,
                 verbose=False, run_chunk=chunk, monitor=mon,
                 max_steps_per_call=10)
    # (trailing duplicate 24 = the protocol's extra final call at i=niter)
    assert [c[0] for c in mon.calls] == [0, 12, 24, 24]
    assert sizes == [10, 2, 10, 2, 1]

    # 0 (or the env var set to 0) uncaps
    sizes.clear()
    run_fit_loop(None, init_state(jax.random.PRNGKey(0), 3), 24,
                 verbose=False, run_chunk=chunk, max_steps_per_call=0)
    assert sizes == [25]


def test_max_steps_per_call_default_from_env(monkeypatch):
    monkeypatch.setenv("GSMVI_MAX_STEPS_PER_CALL", "7")
    sizes = []

    def chunk(s, k):
        sizes.append(k)
        for _ in range(k):
            s = _counting_step(s)
        return s

    run_fit_loop(None, init_state(jax.random.PRNGKey(0), 3), 15,
                 verbose=False, run_chunk=chunk)
    assert sizes == [7, 7, 2]
