"""GSM fitter: Gaussian Score Matching VI, compiled on device.

API parity with the reference ``gsmvi/gsm.py:62-150`` (``GSM(D, lp, lp_g)`` +
``fit(key, ...) -> (mean, cov)``), rebuilt as a single compiled step:

reference per-iteration structure (``gsmvi/gsm.py:107-129``)
    host numpy MVN sample  ->  device score  ->  device update
    ->  host Cholesky goodness check  ->  python revert

Compiled step (everything inside one jit, scanned in chunks):
    on-device sample from the maintained Cholesky factor
    ->  score  ->  fused Gram-matrix update (ops/gsm.py)
    ->  on-device Cholesky + ``jnp.where`` revert (state.accept_or_revert)

Multi-chip data parallelism: pass ``mesh=`` and the per-iteration Monte-Carlo
batch is sharded over the mesh's ``data`` axis (samples/scores
``P('data', None)``, (mean, cov) replicated).  XLA's GSPMD partitioner turns
the Gram-matrix contractions over the batch axis into ``psum``s —
no explicit collectives in user code (see parallel/ for the shard_map
equivalent and multi-host init).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .driver import is_traceable, make_chunk_runner, run_fit_loop
from .ops.gsm import gsm_update_stats
from .parallel.mesh import data_sharding
from .state import VIState, accept_or_revert, init_state


class GSM:
    """Fit a dense-covariance Gaussian to a target via GSM updates.

    Inputs (parity with reference ``gsmvi/gsm.py:65-77``):
      D    — dimensionality.
      lp   — target log-probability callable (used by monitors only).
      lp_g — score callable, (B, D) -> (B, D).

    Extras beyond the reference:
      mesh      — optional ``jax.sharding.Mesh``; shards the MC batch over
                  ``data_axis`` for multi-chip/multi-host fits.
      data_axis — mesh axis name for the sample batch (default "data").
      dtype     — compute dtype (default: f64 when x64 is enabled, else f32).
      use_factor — "auto" (default: the dense path), True (the FactorGSM
                  eps route: the identical rank-2B update in factor
                  coordinates, ops/gsm_eps.py, with no D x D Cholesky in the
                  hot loop) or False.
    """

    def __init__(self, D, lp, lp_g, mesh=None, data_axis: str = "data",
                 dtype=None, cov_sharding=None, chol_block=None,
                 use_factor: "bool | str" = "auto"):
        self.D = D
        self.lp = lp
        self.lp_g = lp_g
        self.mesh = mesh
        self.data_axis = data_axis
        self.dtype = dtype or jnp.zeros(0).dtype
        # "auto" resolves to the dense path on every platform until an A/B
        # of the two routes at every D and B decides otherwise.
        self.use_factor = use_factor
        self._factor_fitter = None
        # Optional NamedSharding splitting the (D, D) covariance over a model
        # axis for very large D (see parallel/large_d.py).
        self.cov_sharding = cov_sharding
        # With a sharded covariance, a monolithic XLA cholesky forces GSPMD
        # to all-gather Σ every step; ``chol_block`` switches the validity/
        # sampling factorization to the blocked right-looking form whose
        # O(D^3) trailing updates stay partitioned (parallel/chol.py).
        if chol_block is not None:
            from .parallel.chol import make_blocked_cholesky

            self.chol_fn = make_blocked_cholesky(chol_block, cov_sharding)
        else:
            self.chol_fn = None
        self._runners = {}

    def _get_runner(self, batch_size: int):
        """Cache one compiled chunk runner per batch size so repeated ``fit``
        calls hit jit's python-level cache (no re-trace; mutate fitter config
        -> create a new fitter)."""
        if batch_size not in self._runners:
            self._runners[batch_size] = make_chunk_runner(
                self._make_step(batch_size))
        return self._runners[batch_size]

    def _factor_route(self, traceable: bool, batch_size: int) -> bool:
        """Whether this ``fit`` call runs on the factor-coordinate (eps)
        route: only with ``use_factor=True`` ("auto" keeps the dense path).
        Sharded-Σ configs keep the dense path: this class's
        ``cov_sharding``/``chol_block`` describe a partitioned dense
        covariance, not a factor.

        Huge Monte-Carlo batches (B >= 128 with 2B > D) also keep the dense
        path: the eps route's rank-2B small space is then no smaller than D
        itself, and its (2B)^2 solves cost more than the dense
        O(B D^2) + Cholesky step."""
        import warnings

        if not traceable or self.use_factor is False:
            if self.use_factor is True and not traceable:
                warnings.warn(
                    "use_factor=True requested but lp_g is not "
                    "jax-traceable; falling back to the dense eager path",
                    stacklevel=3)
            return False
        if self.cov_sharding is not None or self.chol_fn is not None:
            if self.use_factor is True:
                warnings.warn(
                    "use_factor=True requested but cov_sharding/chol_block "
                    "describe a partitioned dense covariance the factor "
                    "route cannot honor; using the dense sharded path",
                    stacklevel=3)
            return False
        if batch_size >= 128 and 2 * batch_size > self.D:
            if self.use_factor is True:
                warnings.warn(
                    "use_factor=True requested but 2*batch_size > D — the "
                    "rank-2B eps small space is no smaller than the dense "
                    "problem; using the dense path",
                    stacklevel=3)
            return False
        return self.use_factor is True

    def _get_factor_fitter(self):
        from .gsm_factor import FactorGSM

        if self._factor_fitter is None:
            self._factor_fitter = FactorGSM(
                self.D, self.lp, self.lp_g, mesh=self.mesh,
                data_axis=self.data_axis, dtype=self.dtype)
        return self._factor_fitter

    def _fit_factor(self, key, mean, cov, batch_size, niter, nprint,
                    verbose, monitor, return_state, state):
        """Delegate one fit to the factor route and convert states at the
        boundary, so the GSM surface (VIState in/out, dense cov) is kept."""
        from .distributions import safe_cholesky
        from .gsm_factor import FactorVIState
        from .ops.gsm_factor import factor_to_cov

        fg = self._get_factor_fitter()
        fstate = None
        if state is not None:
            # VIState already carries the Cholesky factor of cov — a valid
            # sampling factor for the factor-coordinate state (eps method
            # maintains no inverse; carry the empty placeholder).
            fstate = FactorVIState(
                state.mean, state.chol, jnp.zeros((0, 0), self.dtype),
                state.key, state.step, state.n_accepted, state.n_rejected)
        fst = fg.fit(key, mean=mean, cov=cov, batch_size=batch_size,
                     niter=niter, nprint=nprint, verbose=verbose,
                     monitor=monitor, return_state=True, state=fstate)
        cov_out = factor_to_cov(fst.factor)
        if not return_state:
            return fst.mean, cov_out
        return VIState(fst.mean, cov_out, safe_cholesky(cov_out), fst.key,
                       fst.step, fst.n_accepted, fst.n_rejected)

    # -- compiled step ------------------------------------------------------
    def _make_step(self, batch_size: int):
        lp_g = self.lp_g
        d = self.D
        dtype = self.dtype
        sharding = (
            data_sharding(self.mesh, self.data_axis) if self.mesh is not None else None
        )
        cov_sh = self.cov_sharding

        def step(state: VIState) -> VIState:
            # Whole-step true-f32 matmuls: sampling and the user's lp_g run
            # inside this trace too, and reduced-precision products (TF32 or
            # bf16 passes) destabilize the covariance recursion.
            with jax.default_matmul_precision("float32"):
                return _step_body(state)

        def _step_body(state: VIState) -> VIState:
            key, key_sample = jax.random.split(state.key)
            eps = jax.random.normal(key_sample, (batch_size, d), dtype)
            if sharding is not None:
                eps = jax.lax.with_sharding_constraint(eps, sharding)
            samples = state.mean + eps @ state.chol.T
            # Pin the score to the state dtype: a user lp_g emitting f64
            # under global x64 would otherwise promote the scan carry.
            vs = lp_g(samples).astype(dtype)
            dmu, ds = gsm_update_stats(samples, vs, state.mean, state.cov)
            mean_new, cov_new = state.mean + dmu, state.cov + ds
            if cov_sh is not None:
                cov_new = jax.lax.with_sharding_constraint(cov_new, cov_sh)
            return accept_or_revert(state, mean_new, cov_new, key,
                                    chol_fn=self.chol_fn)

        return step

    # -- host-loop fallback for non-traceable lp_g --------------------------
    def _make_eager_step(self, batch_size: int):
        lp_g = self.lp_g
        d = self.D
        dtype = self.dtype

        @jax.jit
        def sample(state):
            key, key_sample = jax.random.split(state.key)
            eps = jax.random.normal(key_sample, (batch_size, d), dtype)
            return key, state.mean + eps @ state.chol.T

        @jax.jit
        def update(state, samples, vs, key):
            dmu, ds = gsm_update_stats(samples, vs, state.mean, state.cov)
            return accept_or_revert(state, state.mean + dmu, state.cov + ds, key)

        def eager_step(state):
            key, samples = sample(state)
            vs = jnp.asarray(np.asarray(lp_g(np.asarray(samples))), dtype)
            return update(state, samples, vs, key)

        return eager_step

    def fit(self, key, mean=None, cov=None, batch_size=2, niter=5000,
            nprint=10, verbose=True, check_goodness=True, monitor=None,
            return_state=False, state=None):
        """Run the fit; signature parity with reference ``gsmvi/gsm.py:79``.

        ``state`` — optional ``VIState`` (e.g. from ``return_state=True`` or
        ``utils.checkpoint.load_state``), ignoring ``key``/``mean``/``cov``.
        On the dense path (the default) resume is trajectory-EXACT.  On the
        factor route (``use_factor=True``) the VIState boundary conversion
        hands over the
        Cholesky of cov — a valid but different sampling factor — so
        resume there is DISTRIBUTIONAL (same law, different draws);
        resuming a ``FactorGSM`` fit with its own ``FactorVIState`` stays
        exact.

        Returns (mean, cov) — or the full ``VIState`` when ``return_state``.

        With ``use_factor=True`` and a traceable ``lp_g`` the fit runs on
        the factor-coordinate eps route — identical math, zero D x D
        Choleskys per step; sampling there uses the maintained factor
        instead of the dense state's Cholesky, so per-step numerics differ
        at f32 rounding while converging to the same moments.
        Note: ``check_goodness`` is accepted for parity; checking is always on
        (it is free — the Cholesky factor is needed for sampling anyway), which
        matches the reference's actual behavior (its kwarg is unused too,
        ``gsmvi/gsm.py:79,125``).
        """
        probe = jax.ShapeDtypeStruct((batch_size, self.D), self.dtype)
        traceable = is_traceable(self.lp_g, probe)
        if self._factor_route(traceable, batch_size):
            return self._fit_factor(key, mean, cov, batch_size, niter,
                                    nprint, verbose, monitor, return_state,
                                    state)
        if state is None:
            state = init_state(key, self.D, mean, cov, self.dtype)
        if not traceable and verbose:
            print("lp_g is not jax-traceable; using the eager host loop")
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
            eager_step=None if traceable else self._make_eager_step(batch_size),
            run_chunk=self._get_runner(batch_size) if traceable else None,
        )
        if return_state:
            return state
        return state.mean, state.cov

    def fit_batch(self, keys, mean=None, cov=None, batch_size=2, niter=5000,
                  return_state=False):
        """Fit K independent replicas in one compiled program (vmapped steps).

        ``keys``: (K,) stacked PRNG keys — one replica per key.  ``mean``/
        ``cov`` may be unbatched (broadcast to every replica) or carry a
        leading K axis (per-replica warm starts / random restarts).  Returns
        (means (K, D), covs (K, D, D)).

        No reference equivalent; the payoff is batching the small-D
        per-step matmuls of K fits into (K, ...) batched ops that fill the
        device.  Monitors are not supported here (no per-replica host hooks
        inside the batched scan); use ``fit`` for monitored runs.

        Like ``fit``, ``use_factor=True`` with a traceable ``lp_g``
        delegates to ``FactorGSM.fit_batch`` (the batched eps-coordinate
        step); otherwise the dense step is vmapped.
        """
        k = keys.shape[0]
        d = self.D
        dtype = self.dtype

        probe = jax.ShapeDtypeStruct((batch_size, d), dtype)
        if self._factor_route(is_traceable(self.lp_g, probe), batch_size):
            from .distributions import safe_cholesky

            fg = self._get_factor_fitter()
            fst = fg.fit_batch(keys, mean=mean, cov=cov,
                               batch_size=batch_size, niter=niter,
                               return_state=return_state)
            if not return_state:
                return fst
            from .ops.gsm_factor import factor_to_cov

            covs = jax.vmap(factor_to_cov)(fst.factor)
            return VIState(fst.mean, covs, jax.vmap(safe_cholesky)(covs),
                           fst.key, fst.step, fst.n_accepted,
                           fst.n_rejected)

        from .driver import broadcast_replicas

        def broadcast(x, default, shape):
            return broadcast_replicas(x, default, k, shape, dtype)

        means0 = broadcast(mean, jnp.zeros(d, dtype), (d,))
        covs0 = broadcast(cov, jnp.eye(d, dtype=dtype), (d, d))

        def init_one(key, m, c):
            return init_state(key, d, m, c, dtype)

        state = jax.vmap(init_one)(keys, means0, covs0)
        step = jax.vmap(self._make_step(batch_size))

        @jax.jit
        def run(s):
            return jax.lax.scan(lambda c, _: (step(c), None), s, None,
                                length=niter + 1)[0]

        state = run(state)
        if return_state:
            return state
        return state.mean, state.cov
