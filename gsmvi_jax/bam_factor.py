"""FactorBaM: Batch-and-Match with factor-coordinate state — no D x D
factorization in the hot loop (see ops/bam_eps.py for the derivation).

Same fitting semantics and ``fit`` surface as ``BaM`` (reference
``gsmvi/bam.py:117-233``): per-iteration regularizer schedule, up-to-
``retries`` resampling attempts on a failed validity check, warm starts.
Differences:

- state is (mean, F) with S = F F^T; sampling is one matmul; the validity
  check is the EXACT PD flag of the small middle factor (free) instead of a
  D x D Cholesky probe;
- full-rank and low-rank coincide (U is exactly rank B+1), so there is no
  ``use_lowrank`` switch — this path IS the exact low-rank algebra;
- no jitter is needed: the proposal is PD by construction and the exact
  PD flag only screens numerical loss (``fit`` still accepts ``jitter=``
  for BaM surface parity; it is inert on this route).

Use ``BaM`` when you need the dense-state path (e.g. cov-sharded large-D) or
eager numpy callables; use this for throughput.

Numerical route: the small-space spectrum needs kappa(Y) — NOT kappa(Y)^2 —
accuracy on stiff steps; a thin SVD of the (D, B+1) factor delivers it
(that is what makes this path work in f32 on stiff targets such as
``dense_gaussian`` at D=256, cond ~ 4e6 — the very regime where the
reference's BaM requires x64, ``examples/example_bam.py:14-15``), while the
cheaper Gram eigh stalls the MEAN there.  The default ``solver="auto"``
routes per step by a cheap conditioning bound (see ops/bam_eps.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .distributions import safe_cholesky
from .driver import RunnerCache, is_traceable, make_chunk_runner, \
    run_fit_loop
from .gsm_factor import FactorVIState
from .ops.bam_eps import bam_eps_update
from .ops.gsm_factor import factor_to_cov
from .parallel.mesh import data_sharding


class FactorBaM:
    """Fit a dense-covariance Gaussian by BaM updates on factor state."""

    def __init__(self, D, lp, lp_g, mesh=None, data_axis: str = "data",
                 dtype=None, solver: str = "auto"):
        self.D = D
        self.lp = lp
        self.lp_g = lp_g
        self.mesh = mesh
        self.data_axis = data_axis
        self.dtype = dtype or jnp.zeros(0).dtype
        # "auto" (default) routes each step by a cheap conditioning bound:
        # the cheaper Gram eigh while the f32/f64 spectrum near l ~ 1 stays
        # resolved, the kappa-accurate thin SVD on stiff steps (which are an
        # early-fit transient) — SVD-grade converged moments at near-eigh
        # steady-state cost.  "svd"/"eigh" force one branch.
        self.solver = solver
        self._runners = RunnerCache()

    def _make_step(self, batch_size: int, regf, retries: int):
        lp_g = self.lp_g
        d = self.D
        dtype = self.dtype
        solver = self.solver
        sharding = (data_sharding(self.mesh, self.data_axis)
                    if self.mesh is not None else None)

        def attempt(key, state):
            """One sample -> score -> update attempt with a fresh draw."""
            with jax.default_matmul_precision("float32"):
                key, key_sample = jax.random.split(key)
                eps = jax.random.normal(key_sample, (batch_size, d), dtype)
                if sharding is not None:
                    eps = jax.lax.with_sharding_constraint(eps, sharding)
                samples = state.mean + eps @ state.factor.T
                # Pin the score to the state dtype: a user lp_g emitting f64
                # under global x64 would otherwise promote the whole carry.
                vs = lp_g(samples).astype(dtype)
                reg = jnp.asarray(regf(state.step), dtype)
                mean_new, f_new, good = bam_eps_update(
                    eps, vs, state.mean, state.factor, reg, solver=solver)
                return (key, mean_new.astype(dtype), f_new.astype(dtype),
                        good)

        def step(state: FactorVIState) -> FactorVIState:
            key, mean_new, f_new, good = attempt(state.key, state)

            if retries > 0:
                # Reference semantics: resample within the same iteration on
                # failure, up to ``retries`` times (``gsmvi/bam.py:188-206``).
                def cond(carry):
                    _, _, _, good, tries = carry
                    return jnp.logical_and(~good, tries < retries)

                def body(carry):
                    key, _, _, _, tries = carry
                    key, mean_new, f_new, good = attempt(key, state)
                    return key, mean_new, f_new, good, tries + 1

                key, mean_new, f_new, good, _ = jax.lax.while_loop(
                    cond, body,
                    (key, mean_new, f_new, good, jnp.zeros((), jnp.int32)))

            g32 = good.astype(jnp.int32)
            mean = jnp.where(good, mean_new, state.mean)
            f = jnp.where(good, f_new, state.factor)
            return FactorVIState(mean, f, state.finv, key, state.step + 1,
                                 state.n_accepted + g32,
                                 state.n_rejected + (1 - g32))

        return step

    def fit(self, key, regf, mean=None, cov=None, batch_size=2, niter=5000,
            nprint=10, verbose=True, check_goodness=True, monitor=None,
            retries=10, jitter=None, return_state=False, state=None):
        """Signature parity with ``BaM.fit`` (reference ``gsmvi/bam.py:140``);
        ``regf`` must be a pure function of the iteration index.  ``jitter``
        is accepted for surface parity but inert: the factor route's
        proposal is PD by construction (ops/bam_eps.py)."""
        dtype = self.dtype
        if state is None:
            mean0 = (jnp.zeros(self.D, dtype) if mean is None
                     else jnp.asarray(mean, dtype))
            f0 = (jnp.eye(self.D, dtype=dtype) if cov is None
                  else safe_cholesky(jnp.asarray(cov, dtype)))
            zero = jnp.zeros((), jnp.int32)
            state = FactorVIState(mean0, f0, jnp.zeros((0, 0), dtype), key,
                                  zero, zero, zero)
        probe = jax.ShapeDtypeStruct((batch_size, self.D), dtype)
        if not is_traceable(self.lp_g, probe):
            raise TypeError("FactorBaM requires a jax-traceable lp_g; "
                            "use BaM for plain-numpy score functions")
        # The key must cover everything the compiled runner closes over:
        # hashable config inline, the unhashable ``regf`` by pinned identity
        # (RunnerCache docstring).
        run_chunk = self._runners.get(
            (batch_size, retries, self.solver), (regf,),
            lambda: make_chunk_runner(
                self._make_step(batch_size, regf, retries)))
        state = run_fit_loop(
            None,  # cached run_chunk carries the body
            state,
            niter,
            monitor=monitor,
            monitor_params=lambda s: [s.mean, factor_to_cov(s.factor)],
            lp=self.lp,
            nprint=nprint,
            verbose=verbose,
            batch_size=batch_size,
            run_chunk=run_chunk,
        )
        if return_state:
            return state
        return state.mean, factor_to_cov(state.factor)

    def fit_batch(self, keys, regf, mean=None, cov=None, batch_size=2,
                  niter=5000, retries=10, return_state=False):
        """K independent FactorBaM replicas in one compiled program.

        Same contract as ``BaM.fit_batch``; ``regf`` must be a pure
        schedule.  Replica fits vmap the step.
        """
        k = keys.shape[0]
        d = self.D
        dtype = self.dtype

        from .driver import broadcast_replicas

        def broadcast(x, default, shape):
            return broadcast_replicas(x, default, k, shape, dtype)

        means0 = broadcast(mean, jnp.zeros(d, dtype), (d,))
        covs0 = broadcast(cov, jnp.eye(d, dtype=dtype), (d, d))

        def init_one(kk, m, c):
            zero = jnp.zeros((), jnp.int32)
            return FactorVIState(m, safe_cholesky(c),
                                 jnp.zeros((0, 0), dtype), kk, zero, zero,
                                 zero)

        state = jax.vmap(init_one)(keys, means0, covs0)
        step = jax.vmap(self._make_step(batch_size, regf, retries))

        @jax.jit
        def run(s):
            return jax.lax.scan(lambda c, _: (step(c), None), s, None,
                                length=niter + 1)[0]

        state = run(state)
        if return_state:
            return state
        return state.mean, jax.vmap(factor_to_cov)(state.factor)
