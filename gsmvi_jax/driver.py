"""Chunked compiled fit-loop driver shared by the GSM / BaM / ADVI fitters.

The reference drives every fitter with a Python ``for`` loop that dispatches a
jitted update per iteration and syncs to host for sampling + checks
(``gsmvi/gsm.py:107-129``).  Here the loop body is compiled once and run as a
``lax.scan`` in *chunks* whose boundaries are exactly the host-visible events
(monitor checkpoints / progress prints).  Between events there are zero host
syncs; with no monitor the entire fit is a single device computation.

Chunk lengths take at most two distinct values (the event stride and a final
remainder), so at most two XLA compilations occur per fit configuration.

An *eager* fallback is provided for user callables that are not jax-traceable
(e.g. plain-numpy ``lp_g``): detection happens up front via
``jax.eval_shape``, mirroring the reference's support for arbitrary Python
score functions while keeping the compiled path the default.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Callable, Optional

import jax


def is_traceable(fn: Callable, *args_shape_dtype) -> bool:
    """True if ``fn`` can be traced by jax on the given abstract inputs."""
    try:
        jax.eval_shape(fn, *args_shape_dtype)
        return True
    except Exception:
        return False


class RunnerCache:
    """Bounded cache of compiled chunk runners keyed partly on object identity.

    Fitters key runners on unhashable config objects (regularizer closures,
    optax optimizers) via ``id()``.  A bare id key is unsound: CPython reuses
    ids after garbage collection, so a new object could silently hit a stale
    compiled closure.  This cache therefore stores a *strong reference* to
    every keyed object alongside its runner — while an entry lives, its ids
    cannot be reused — and evicts least-recently-USED beyond ``maxsize``
    (entries refresh on hit, so a long-lived process alternating among more
    than ``maxsize`` configs keeps its hottest runners compiled; dropping an
    entry releases the object and its compiled runner together).
    """

    def __init__(self, maxsize: int = 16):
        self._entries = {}
        self._maxsize = maxsize

    def get(self, static_key, key_objs: tuple, build: Callable) -> Callable:
        key = (static_key, tuple(id(o) for o in key_objs))
        hit = self._entries.get(key)
        if hit is not None:
            self._entries.pop(key)       # refresh: move to MRU end
            self._entries[key] = hit
            return hit[1]
        runner = build()
        if len(self._entries) >= self._maxsize:
            self._entries.pop(next(iter(self._entries)))
        self._entries[key] = (key_objs, runner)
        return runner

    def holds(self, obj) -> bool:
        """True if ``obj`` is currently pinned by a cache entry (tests)."""
        return any(any(o is obj for o in objs)
                   for objs, _ in self._entries.values())


def make_chunk_runner(step: Callable, collect_aux: bool = False) -> Callable:
    """Jitted (state, k) -> state running ``k`` scanned steps; build once per
    fitter configuration and reuse so repeated fits skip re-tracing.

    With ``collect_aux`` the step must return ``(state, aux)`` and the runner
    returns ``(state, stacked_aux)`` — used by ADVI to thread its per-step
    loss trace through the shared fit loop."""

    if collect_aux:
        @partial(jax.jit, static_argnums=1)
        def run_chunk(s, k):
            return jax.lax.scan(lambda c, _: step(c), s, None, length=k)

        return run_chunk

    @partial(jax.jit, static_argnums=1)
    def run_chunk(s, k):
        return jax.lax.scan(lambda c, _: (step(c), None), s, None, length=k)[0]

    return run_chunk


def broadcast_replicas(x, default, k: int, shape, dtype):
    """fit_batch initial-state helper: broadcast one (mean/cov-shaped)
    value to k replicas, or pass through an already per-replica array."""
    import jax.numpy as jnp

    if x is None:
        x = default
    x = jnp.asarray(x, dtype)
    if x.ndim == len(shape):
        x = jnp.broadcast_to(x, (k, *shape))
    return x


def _monitor_key(key, i: int):
    """Key handed to the monitor at checkpoint ``i``: the state key remixed
    with the iteration index.  A state whose key stays constant (a stream
    base indexed by the step counter) would otherwise hand every checkpoint
    identical Monte-Carlo draws; folding in ``i`` keeps checkpoint draws
    independent on every path without touching any fit trajectory."""
    try:
        return jax.random.fold_in(key, i)
    except Exception:  # non-key (e.g. int) — monitor coerces it itself
        return key


def _next_event(i: int, total: int, cadences) -> int:
    """First iteration > i that is a multiple of any cadence (or ``total``)."""
    nxt = total
    for c in cadences:
        if c:
            nxt = min(nxt, ((i // c) + 1) * c)
    return nxt


def run_fit_loop(
    step: Optional[Callable],
    state,
    niter: int,
    *,
    monitor=None,
    monitor_params: Optional[Callable] = None,
    lp: Optional[Callable] = None,
    nprint: int = 10,
    verbose: bool = True,
    batch_size: int = 1,
    eager_step: Optional[Callable] = None,
    use_scan: bool = True,
    run_chunk: Optional[Callable] = None,
    collect_aux: bool = False,
    max_steps_per_call: Optional[int] = None,
):
    """Run ``niter + 1`` update steps (reference iterates ``range(niter + 1)``,
    ``gsmvi/gsm.py:107``) with reference-parity monitor/print semantics.

    step           — pure (state) -> state, jax-traceable; may be None when
                     ``run_chunk`` (scan path) or ``eager_step`` (host path)
                     is supplied — fitters with cached runners pass None so
                     no dead step closure is built per ``fit`` call.
    monitor        — optional callable with the reference hook protocol
                     ``monitor(i, params, lp, key, nevals=...)`` honored at
                     ``monitor.checkpoint`` cadence (``gsmvi/gsm.py:111-113``).
    monitor_params — (state) -> params list handed to the monitor
                     (default ``[state.mean, state.cov]``).
    eager_step     — host-loop fallback body used when ``use_scan`` is False.
    run_chunk      — optional prebuilt jitted (state, k)->state chunk runner;
                     passing the same callable across ``fit`` calls lets jit's
                     python-level cache skip re-tracing (fitters cache one per
                     batch size).
    collect_aux    — when True, ``step`` returns ``(state, aux)`` and the loop
                     returns ``(state, aux)`` with per-step aux leaves
                     concatenated over all ``niter + 1`` steps (scan path only).
    max_steps_per_call — cap on the number of steps issued as ONE device
                     program, for runtimes that stop device programs past a
                     wall-time limit.  Splitting a fit into bounded chunks
                     is trajectory-exact (chunking is pure control flow: the
                     scan body is unchanged and every path carries its PRNG
                     key in-state) and costs one host dispatch per
                     boundary.  Default (None) reads the
                     ``GSMVI_MAX_STEPS_PER_CALL`` env var (default
                     1_000_000; set it to 0 to uncap).

    Returns the final state (or ``(state, aux)`` with ``collect_aux``).
    """
    total = niter + 1
    if max_steps_per_call is None:
        max_steps_per_call = int(os.environ.get("GSMVI_MAX_STEPS_PER_CALL",
                                                "1000000"))
    checkpoint = getattr(monitor, "checkpoint", None) if monitor is not None else None
    if monitor_params is None:
        monitor_params = lambda s: [s.mean, s.cov]

    if use_scan:
        if run_chunk is None:
            if step is None:
                raise ValueError("run_fit_loop needs step or run_chunk")
            run_chunk = make_chunk_runner(step, collect_aux=collect_aux)
    else:
        if collect_aux:
            raise ValueError("collect_aux requires the compiled scan path")
        step_fn = eager_step if eager_step is not None else step
        if step_fn is None:
            raise ValueError("run_fit_loop needs step or eager_step")

        def run_chunk(s, k):
            for _ in range(k):
                s = step_fn(s)
            return s

    nevals = 1  # reference bookkeeping starts at 1 (``gsmvi/gsm.py:105``)
    # Reference prints every niter//nprint iters (``gsmvi/gsm.py:108``;
    # ZeroDivisionError when nprint > niter — clamped here like BaM does at
    # ``gsmvi/bam.py:177``).
    print_every = max(1, niter // min(nprint, max(niter, 1))) if (verbose and nprint) else 0
    cadences = (checkpoint, print_every)
    aux_chunks = []
    i = 0
    while i < total:
        if print_every and i % print_every == 0:
            print(f"Iteration {i} of {niter}")
        if monitor is not None and checkpoint and i % checkpoint == 0:
            monitor(i, monitor_params(state), lp, _monitor_key(state.key, i),
                    nevals=nevals)
            nevals = 0
        k = _next_event(i, total, cadences) - i
        if max_steps_per_call and k > max_steps_per_call:
            k = max_steps_per_call
        if collect_aux:
            state, aux = run_chunk(state, k)
            aux_chunks.append(aux)
        else:
            state = run_chunk(state, k)
        nevals += k * batch_size
        i += k
    if monitor is not None:
        # Reference issues one extra monitor call after the loop with i=niter
        # (``gsmvi/gsm.py:131-132``).  Fold index ``total`` (= niter+1, never
        # an in-loop index) so on constant-key paths this call's MC draws are
        # independent of a checkpoint that landed exactly on i=niter.
        monitor(niter, monitor_params(state), lp,
                _monitor_key(state.key, total), nevals=nevals)
    if collect_aux:
        aux = jax.tree_util.tree_map(
            lambda *xs: jax.numpy.concatenate(xs, axis=0), *aux_chunks)
        return state, aux
    return state


def block_state(state):
    """Block until all state leaves are materialized (for timing/benchmarks)."""
    jax.block_until_ready(jax.tree_util.tree_leaves(state))
    return state
