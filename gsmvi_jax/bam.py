"""BaM fitter: Batch-and-Match VI (arXiv:2402.14758), compiled on device.

API parity with the reference ``gsmvi/bam.py:117-233`` (``BaM(D, lp, lp_g,
use_lowrank, jit_compile)`` + ``fit(key, regf, ...) -> (mean, cov)``), with the
internals rebuilt so the whole iteration is one compiled step:

- The matrix square root runs on device (ops/bam.py similarity reformulation
  + eigh/Newton–Schulz) instead of the reference's backend dispatch to a
  host ``sqrtm`` (``gsmvi/bam.py:19-28``).
- The low-rank path uses the exact rank-(B+1) factor of U instead of the
  ``scipy.sparse.linalg.svds`` host callback (``gsmvi/bam.py:10-17,104``).
- The reference's host-side retry loop — up to ``retries`` resamples on any
  exception (``gsmvi/bam.py:188-206``) — becomes an on-device
  ``lax.while_loop`` that re-keys, resamples and recomputes while the proposed
  covariance fails its (free) Cholesky validity check.
- Jitter and symmetrization, applied on host post-hoc by the reference
  (``gsmvi/bam.py:198-199``), are folded into the kernel: jitter lands on V's
  diagonal and the solve form S = 2 Y^T Y is exactly symmetric by
  construction.

``regf`` must be a pure function of the iteration index (the schedules from
``Regularizers`` qualify; see ops/bam.py for the counter-semantics mapping).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .distributions import safe_cholesky
from .driver import RunnerCache, is_traceable, make_chunk_runner, run_fit_loop
from .ops.bam import Regularizers, bam_lowrank_update, bam_update  # noqa: F401 (re-export)
from .parallel.mesh import data_sharding
from .state import VIState, accept_or_revert, init_state


class BaM:
    """Fit a dense-covariance Gaussian by Batch-and-Match updates.

    Parity: reference ``gsmvi/bam.py:121-138``.  ``jit_compile`` is accepted
    for API compatibility; compilation is intrinsic here (False selects the
    eager host loop, mainly useful for debugging non-traceable callables).

    Extras mirror ``GSM``: ``mesh``/``data_axis`` shard the MC batch;
    ``sqrt_method`` picks the on-device matrix root: "auto" (default, plain
    eigh — robust for any conditioning), or explicitly "eigh" / "newton"
    (matmul-only Newton–Schulz with a residual-gated eigh fallback).
    ``use_factor``: "auto" (default: the dense path), True (the FactorBaM
    eps route: the identical exact rank-(B+1) update in factor coordinates,
    ops/bam_eps.py, with no D x D factorization in the hot loop; ``jitter``
    is inert there, the proposal being PD by construction) or False.
    """

    def __init__(self, D, lp, lp_g, use_lowrank=False, jit_compile=True,
                 mesh=None, data_axis: str = "data", dtype=None,
                 sqrt_method: str = "auto", auto_lowrank: bool = True,
                 use_factor: "bool | str" = "auto"):
        self.D = D
        self.lp = lp
        self.lp_g = lp_g
        self.use_lowrank = use_lowrank
        self.jit_compile = jit_compile
        self.mesh = mesh
        self.data_axis = data_axis
        self.dtype = dtype or jnp.zeros(0).dtype
        if sqrt_method == "auto":
            sqrt_method = "eigh"
        self.sqrt_method = sqrt_method
        # Route full-rank requests through the (exact) low-rank algebra when
        # B+1 << D; disable to force the dense root regardless of shape.
        self.auto_lowrank = auto_lowrank
        # "auto" resolves to the dense path on every platform until an A/B
        # of the two routes at every D and B decides otherwise.
        self.use_factor = use_factor
        self._factor_fitter = None
        self._runners = RunnerCache()

    def _factor_route(self, traceable: bool) -> bool:
        """Whether this ``fit`` call runs on the factor-coordinate (eps)
        route: only with ``use_factor=True`` and a traceable ``lp_g``."""
        return traceable and self.use_factor is True

    def _get_factor_fitter(self):
        from .bam_factor import FactorBaM

        if self._factor_fitter is None:
            self._factor_fitter = FactorBaM(
                self.D, self.lp, self.lp_g, mesh=self.mesh,
                data_axis=self.data_axis, dtype=self.dtype)
        return self._factor_fitter

    def _fit_factor(self, key, regf, mean, cov, batch_size, niter, nprint,
                    verbose, monitor, retries, return_state, state):
        """Delegate one fit to the factor route and convert states at the
        boundary, so the BaM surface (VIState in/out, dense cov) is kept."""
        from .bam_factor import FactorVIState
        from .ops.gsm_factor import factor_to_cov

        fb = self._get_factor_fitter()
        fstate = None
        if state is not None:
            # VIState already carries the Cholesky factor of cov — a valid
            # sampling factor for the factor-coordinate state.
            fstate = FactorVIState(
                state.mean, state.chol, jnp.zeros((0, 0), self.dtype),
                state.key, state.step, state.n_accepted, state.n_rejected)
        fst = fb.fit(key, regf, mean=mean, cov=cov, batch_size=batch_size,
                     niter=niter, nprint=nprint, verbose=verbose,
                     monitor=monitor, retries=retries, return_state=True,
                     state=fstate)
        cov_out = factor_to_cov(fst.factor)
        if not return_state:
            return fst.mean, cov_out
        return VIState(fst.mean, cov_out, safe_cholesky(cov_out), fst.key,
                       fst.step, fst.n_accepted, fst.n_rejected)

    def _get_runner(self, batch_size, regf, retries, jitter):
        # ``regf`` is keyed by identity (closures are unhashable in general);
        # RunnerCache pins it so a GC'd schedule's id can never alias a new one.
        return self._runners.get(
            (batch_size, retries, jitter), (regf,),
            lambda: make_chunk_runner(
                self._make_step(batch_size, regf, retries, jitter)))

    def _update(self, samples, vs, mean, cov, reg, jitter):
        b, d = samples.shape
        # U is EXACTLY rank <= B+1 by construction (ops/bam.py docstring), so
        # the low-rank Woodbury algebra returns the identical full-rank
        # result (pinned in tests/test_bam_kernels.py) while replacing the
        # D x D matrix root with a (B+1)-sized one.  Route automatically
        # when that is a clear win: the full-rank root is a D x D eigh, the
        # low-rank one a (B+1) x (B+1) eigh.
        if self.use_lowrank or (self.auto_lowrank and 4 * (b + 1) <= d):
            return bam_lowrank_update(samples, vs, mean, cov, reg, jitter,
                                      sqrt_method=self.sqrt_method)
        return bam_update(samples, vs, mean, cov, reg, jitter,
                          sqrt_method=self.sqrt_method)

    def _make_step(self, batch_size: int, regf, retries: int, jitter: float):
        lp_g = self.lp_g
        d = self.D
        dtype = self.dtype
        sharding = (
            data_sharding(self.mesh, self.data_axis) if self.mesh is not None else None
        )

        def attempt(key, state):
            with jax.default_matmul_precision("float32"):
                return _attempt_body(key, state)

        def _attempt_body(key, state):
            key, key_sample = jax.random.split(key)
            eps = jax.random.normal(key_sample, (batch_size, d), dtype)
            if sharding is not None:
                eps = jax.lax.with_sharding_constraint(eps, sharding)
            samples = state.mean + eps @ state.chol.T
            # Pin the score to the state dtype: a user lp_g emitting f64
            # under global x64 would otherwise promote the scan carry.
            vs = lp_g(samples).astype(dtype)
            reg = jnp.asarray(regf(state.step), dtype)
            mean_new, cov_new = self._update(samples, vs, state.mean,
                                             state.cov, reg, jitter)
            chol_new = jnp.linalg.cholesky(cov_new)
            good = jnp.all(jnp.isfinite(chol_new))
            return key, mean_new, cov_new, good

        def step(state: VIState) -> VIState:
            key, mean_new, cov_new, good = attempt(state.key, state)

            if retries > 0:
                # Reference semantics: on failure, re-key + resample up to
                # ``retries`` times within the same iteration
                # (``gsmvi/bam.py:188-206``), then fall through to the
                # goodness check / revert.
                def cond(carry):
                    _, _, _, good, tries = carry
                    return jnp.logical_and(~good, tries < retries)

                def body(carry):
                    key, _, _, _, tries = carry
                    key, mean_new, cov_new, good = attempt(key, state)
                    return key, mean_new, cov_new, good, tries + 1

                key, mean_new, cov_new, good, _ = jax.lax.while_loop(
                    cond, body,
                    (key, mean_new, cov_new, good, jnp.zeros((), jnp.int32)),
                )
            return accept_or_revert(state, mean_new, cov_new, key)

        return step

    def _make_eager_step(self, batch_size: int, regf, retries: int, jitter: float):
        lp_g = self.lp_g
        d = self.D
        dtype = self.dtype

        @jax.jit
        def sample(state):
            key, key_sample = jax.random.split(state.key)
            eps = jax.random.normal(key_sample, (batch_size, d), dtype)
            return key, state.mean + eps @ state.chol.T

        def eager_step(state):
            key = state.key
            for _ in range(max(retries, 0) + 1):
                key, samples = sample(state._replace(key=key))
                vs = jnp.asarray(np.asarray(lp_g(np.asarray(samples))), dtype)
                reg = float(regf(int(state.step)))
                mean_new, cov_new = self._update(samples, vs, state.mean,
                                                 state.cov, reg, jitter)
                if bool(jnp.all(jnp.isfinite(jnp.linalg.cholesky(cov_new)))):
                    break
            return accept_or_revert(state, mean_new, cov_new, key)

        return eager_step

    def fit(self, key, regf, mean=None, cov=None, batch_size=2, niter=5000,
            nprint=10, verbose=True, check_goodness=True, monitor=None,
            retries=10, jitter=1e-6, return_state=False, state=None):
        """Run the fit; signature parity with reference ``gsmvi/bam.py:140``.

        ``regf`` — regularizer schedule, a pure function of the iteration
        index (see ``Regularizers``).  ``jitter`` is added to V's diagonal
        inside the kernel each step (reference adds it to the output cov on
        host, ``gsmvi/bam.py:198``).

        With ``use_factor=True`` and a traceable ``lp_g`` the fit runs on
        the factor-coordinate eps route — identical math, zero D x D
        factorizations per step; there ``jitter`` is inert (the proposal is
        PD by construction) and per-step numerics differ from the dense path
        at f32 rounding while converging to the same moments.
        """
        probe = jax.ShapeDtypeStruct((batch_size, self.D), self.dtype)
        traceable = self.jit_compile and is_traceable(self.lp_g, probe)
        if self._factor_route(traceable):
            return self._fit_factor(key, regf, mean, cov, batch_size, niter,
                                    nprint, verbose, monitor, retries,
                                    return_state, state)
        if state is None:
            state = init_state(key, self.D, mean, cov, self.dtype)
        if not traceable and verbose:
            print("lp_g is not jax-traceable or jit_compile=False; using the eager host loop")
        state = run_fit_loop(
            None,  # cached run_chunk / eager_step below carries the body
            state,
            niter,
            monitor=monitor,
            lp=self.lp,
            nprint=nprint,
            verbose=verbose,
            batch_size=batch_size,
            use_scan=traceable,
            eager_step=None if traceable
            else self._make_eager_step(batch_size, regf, retries, jitter),
            run_chunk=(self._get_runner(batch_size, regf, retries, jitter)
                       if traceable else None),
        )
        if return_state:
            return state
        return state.mean, state.cov

    def fit_batch(self, keys, regf, mean=None, cov=None, batch_size=2,
                  niter=5000, retries=10, jitter=1e-6, return_state=False):
        """K independent BaM replicas in one compiled program (vmapped steps).

        Same contract as ``GSM.fit_batch``; ``regf`` must be a pure schedule.
        """
        k = keys.shape[0]
        d = self.D
        dtype = self.dtype

        from .driver import broadcast_replicas

        def broadcast(x, default, shape):
            return broadcast_replicas(x, default, k, shape, dtype)

        means0 = broadcast(mean, jnp.zeros(d, dtype), (d,))
        covs0 = broadcast(cov, jnp.eye(d, dtype=dtype), (d, d))
        state = jax.vmap(lambda kk, m, c: init_state(kk, d, m, c, dtype))(
            keys, means0, covs0)
        step = jax.vmap(self._make_step(batch_size, regf, retries, jitter))

        @jax.jit
        def run(s):
            return jax.lax.scan(lambda c, _: (step(c), None), s, None,
                                length=niter + 1)[0]

        state = run(state)
        if return_state:
            return state
        return state.mean, state.cov
