"""ADVI fitter: ELBO maximization over (mean, Cholesky factor), compiled.

API parity with the reference ``gsmvi/advi.py:8-112`` (``ADVI(D, lp)`` +
``fit(key, opt, ...) -> (mean, cov, losses)``).  The reference already has the
right single-jitted-step shape (``gsmvi/advi.py:68-73``); this rebuild goes
further:

- The per-iteration Python dispatch loop (``gsmvi/advi.py:90-103``) becomes a
  ``lax.scan`` over optimizer steps — losses come back as one device array.
- q's sampling/log-density use the native reparameterized MVN primitives
  (distributions.py) rather than numpyro; the ELBO gradient flows through
  ``x = loc + eps @ L^T`` (same estimator as numpyro's ``rsample`` path).
- The RNG key is split *before* each step (the reference evaluates the loss
  with the pre-split key and splits after, ``gsmvi/advi.py:100-101`` — a
  documented quirk, not replicated).
- With ``mesh=`` the MC batch is sharded over the data axis; XLA inserts the
  gradient ``psum``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .distributions import full_f32, mvn_logpdf
from .driver import RunnerCache, make_chunk_runner, run_fit_loop
from .parallel.mesh import data_sharding
from .state import VIState  # noqa: F401  (monitor protocol shares shapes)


class ADVIState(NamedTuple):
    loc: jax.Array       # (D,)
    scales: jax.Array    # (D*(D+1)/2,) flattened lower-triangle of L
    opt_state: object
    key: jax.Array
    step: jax.Array
    loss: jax.Array      # most recent loss value


class ADVI:
    """Fit a dense-covariance Gaussian by maximizing the ELBO with optax.

    Parity: reference ``gsmvi/advi.py:14-23``.  ``lp`` must be jax-traceable
    (its gradient is taken by autodiff, as in the reference).
    """

    def __init__(self, D, lp, mesh=None, data_axis: str = "data", dtype=None):
        self.D = D
        self.lp = lp
        self.mesh = mesh
        self.data_axis = data_axis
        self.dtype = dtype or jnp.zeros(0).dtype
        self.idx_tril = jnp.tril_indices(D)
        self._runners = RunnerCache()

    # -- parameterization ---------------------------------------------------
    def scales_to_tril(self, scales):
        """Lower-triangular factor from either parameter form.

        Internally ADVI optimizes a MASKED-DENSE (D, D) matrix — `jnp.tril`
        is a cheap mask, whereas the reference's flat-vector form needs a
        525k-element scatter/gather pair per step at D=1024.  The two give identical adam trajectories: upper entries start
        at zero and receive zero gradient.  Flat (D(D+1)/2,) vectors are
        still accepted for reference-API compatibility."""
        if scales.ndim == 2:
            return jnp.tril(scales)
        tril = jnp.zeros((self.D, self.D), scales.dtype)
        return tril.at[self.idx_tril].set(scales)

    @full_f32
    def scales_to_cov(self, scales):
        """Parity helper (reference ``gsmvi/advi.py:25-29``)."""
        l = self.scales_to_tril(scales)
        return l @ l.T

    # -- loss ---------------------------------------------------------------
    def neg_elbo(self, params, key, batch_size, estimator="analytic"):
        """Negative ELBO with reparameterized sampling.

        ``estimator="analytic"`` (default) matches the estimator of reference
        ``gsmvi/advi.py:31-45``: -(sum lp(x) - sum log q(x)) over a batch of
        q-samples, with the entropy term's parameter dependence kept analytic
        (log q(x(theta); theta) == -|eps|^2/2 - logdet L - const identically
        in theta for reparameterized samples).

        ``estimator="stl"`` is the "sticking the landing" path-derivative
        estimator (Roeder, Wu & Duvenaud, NeurIPS 2017): log q is evaluated
        at STOPPED variational parameters, so the gradient flows only through
        the sample path ``x = loc + eps @ L^T``.  The two estimators have the
        same expectation; STL's gradient VARIANCE vanishes as q -> p (the
        score term it drops is exactly the one that stays MC-noisy at the
        optimum — measured ~3.6e3x lower gradient norm at the optimum on the
        D=64 bench target).  Cost: one (D, D) x (D, B) triangular solve per
        step (the analytic form is solve-free), so STL is the accuracy mode —
        run the bulk of the fit with the analytic estimator and polish with
        STL.
        """
        # True-f32 matmuls: the reparameterized gradient is sensitive to
        # reduced-precision (TF32 / bf16-pass) products.
        import math

        with jax.default_matmul_precision("float32"):
            loc, scales = params
            l = self.scales_to_tril(scales)
            eps = jax.random.normal(key, (batch_size, self.D), loc.dtype)
            if self.mesh is not None:
                eps = jax.lax.with_sharding_constraint(
                    eps, data_sharding(self.mesh, self.data_axis))
            samples = loc + eps @ l.T
            if estimator == "stl":
                # v == eps in VALUE (so the loss value matches the analytic
                # estimator to roundoff) but the solve re-expresses it as a
                # function of (loc, L) at stopped density parameters — the
                # gradient keeps only the path derivative.
                #
                # Diagonal clamp (_safe_tril): STL drops the analytic
                # entropy gradient's -B/L_ii barrier, so MC noise can pin a
                # diagonal entry at ~0 (Adam's second moment then explodes:
                # measured f32 overflow -> NaN at D=1024 on the stiff bench
                # target by step ~860).  Clamping |L_ii| at 1e-5 of the
                # largest diagonal bounds the solve (|v| <= 1e5 |L eps|,
                # second moments ~1e16 << f32 max) while biasing nothing
                # until the factor's diagonal spread exceeds 1e5 (cov
                # condition 1e10).
                l_safe = self._safe_tril(jax.lax.stop_gradient(l))
                loc_bar = jax.lax.stop_gradient(loc)
                v = jax.scipy.linalg.solve_triangular(
                    l_safe, (samples - loc_bar).T, lower=True).T
                logdet = jnp.sum(jnp.log(jnp.abs(jnp.diagonal(l_safe))))
                ent_quad = -0.5 * jnp.sum(v * v)
            elif estimator == "analytic":
                logdet = jnp.sum(jnp.log(jnp.abs(jnp.diagonal(l))))
                ent_quad = -0.5 * jnp.sum(eps * eps)
            else:
                raise ValueError(f"unknown estimator: {estimator!r}")
            logq = (ent_quad
                    - batch_size * (logdet
                                    + 0.5 * self.D * math.log(2.0 * math.pi)))
            logl = jnp.sum(self.lp(samples))
            return -(logl - logq)

    def _make_step(self, batch_size: int, opt, estimator="analytic"):
        """One jitted ADVI step: (state) -> (state, loss) — the aux contract
        of ``run_fit_loop(collect_aux=True)``."""

        def loss_fn(params, key):
            return self.neg_elbo(params, key, batch_size, estimator)

        def step(state: ADVIState):
            key, key_step = jax.random.split(state.key)
            params = (state.loc, state.scales)
            loss, grads = jax.value_and_grad(loss_fn)(params, key_step)
            # Pin the loss to the state dtype: a user lp emitting f64 under
            # global x64 would otherwise promote the scan carry.
            loss = loss.astype(state.loss.dtype)
            updates, opt_state2 = opt.update(grads, state.opt_state, params)
            loc, scales = optax.apply_updates(params, updates)
            if estimator == "stl":
                # On-device revert of a nonfinite step (insurance behind the
                # diagonal clamp; the default estimator keeps the
                # reference's accept-every-step behavior).
                good = jnp.all(jnp.isfinite(loc)) & jnp.all(
                    jnp.isfinite(scales))
                sel = lambda a, b: jnp.where(good, a, b)
                loc = sel(loc, state.loc)
                scales = sel(scales, state.scales)
                opt_state2 = jax.tree_util.tree_map(sel, opt_state2,
                                                    state.opt_state)
            return (ADVIState(loc, scales, opt_state2, key, state.step + 1,
                              loss), loss)

        return step

    def fit(self, key, opt, mean=None, cov=None, batch_size=8, niter=1000,
            nprint=10, verbose=True, monitor=None, return_state=False,
            return_losses=True, estimator="analytic",
            max_steps_per_call=None):
        """Run the fit; signature parity with reference ``gsmvi/advi.py:47``.

        Returns (mean, cov, losses) — three values, unlike GSM/BaM, matching
        the reference (``gsmvi/advi.py:112``).  ``losses`` is a numpy array of
        length ``niter + 1``; with ``return_losses=False`` it is ``None`` and
        the per-step loss trace is neither stacked on device nor transferred
        to host — the throughput-measurement / serving mode (the transfer
        scales with niter, so it would otherwise contaminate differential
        timings).

        ``estimator="stl"`` switches the ELBO gradient to the
        sticking-the-landing path-derivative form (see :meth:`neg_elbo`) —
        same expectation, near-zero gradient variance at the optimum; use it
        to polish a warm start (``mean=``/``cov=`` from an analytic fit)
        far below the analytic estimator's variance floor.
        """
        dtype = self.dtype
        if mean is None:
            mean = jnp.zeros(self.D, dtype)
        if cov is None:
            cov = jnp.eye(self.D, dtype=dtype)

        # One jitted program for the whole init (cholesky + tril + opt.init)
        # instead of ~15 separate eager dispatches.
        def build_init():
            @jax.jit
            def init_state(mean, cov, key):
                # Optimize unconstrained Cholesky entries (reference
                # gsmvi/advi.py:80-83) in masked-dense form (scales_to_tril).
                l0 = jnp.linalg.cholesky(jnp.asarray(cov, dtype))
                params = (jnp.asarray(mean, dtype), jnp.tril(l0))
                return ADVIState(params[0], params[1], opt.init(params), key,
                                 jnp.zeros((), jnp.int32),
                                 jnp.zeros((), dtype))

            return init_state

        init_state = self._runners.get(("init",), (opt,), build_init)
        state = init_state(mean, cov, key)

        # ``opt`` is identity-keyed; RunnerCache pins it against id reuse.
        # The step closure is only built on a cache miss.
        run_chunk = self._runners.get(
            (batch_size, return_losses, estimator), (opt,),
            lambda: make_chunk_runner(
                (self._make_step(batch_size, opt, estimator)
                 if return_losses
                 else (lambda step: (lambda s: step(s)[0]))(
                     self._make_step(batch_size, opt, estimator))),
                collect_aux=return_losses))
        out = run_fit_loop(
            None,  # cached run_chunk carries the body
            state,
            niter,
            monitor=monitor,
            monitor_params=lambda s: [s.loc, self.scales_to_cov(s.scales)],
            lp=self.lp,
            nprint=nprint,
            verbose=verbose,
            batch_size=batch_size,
            run_chunk=run_chunk,
            collect_aux=return_losses,
            max_steps_per_call=max_steps_per_call,
        )
        if return_losses:
            state, losses = out
            losses = np.asarray(losses)
        else:
            state, losses = out, None
        if return_state:
            return state, losses
        return state.loc, self.scales_to_cov(state.scales), losses

    @staticmethod
    def _safe_tril(l):
        """Diagonal-clamped factor for solves (same floor as the STL loss:
        bias-free below covariance condition 1e10, bounded above f32
        overflow)."""
        diag = jnp.diagonal(l)
        floor = 1e-5 * jnp.maximum(jnp.max(jnp.abs(diag)), 1e-30)
        safe = jnp.where(jnp.abs(diag) < floor,
                         jnp.where(diag < 0, -floor, floor), diag)
        return l + jnp.diag(safe - diag)

    def fit_batch(self, keys, opt, mean=None, cov=None, batch_size=8,
                  niter=1000):
        """K independent ADVI replicas in one compiled program.

        Same contract as ``GSM.fit_batch``: ``keys`` (K,) stacked PRNG keys;
        ``mean``/``cov`` broadcast or carry a leading K axis.  Returns
        (means (K, D), covs (K, D, D), losses (K, niter+1)).
        """
        k = keys.shape[0]
        dtype = self.dtype
        d = self.D

        from .driver import broadcast_replicas

        def broadcast(x, default, shape):
            return broadcast_replicas(x, default, k, shape, dtype)

        means0 = broadcast(mean, jnp.zeros(d, dtype), (d,))
        covs0 = broadcast(cov, jnp.eye(d, dtype=dtype), (d, d))

        def init_one(kk, m, c):
            l0 = jnp.linalg.cholesky(c)
            scales = jnp.tril(l0)
            params = (m, scales)
            return ADVIState(m, scales, opt.init(params), kk,
                             jnp.zeros((), jnp.int32), jnp.zeros((), dtype))

        state = jax.vmap(init_one)(keys, means0, covs0)
        step = jax.vmap(self._make_step(batch_size, opt))

        @jax.jit
        def run(s):
            return jax.lax.scan(lambda c, _: step(c), s, None,
                                length=niter + 1)

        state, losses = run(state)
        covs = jax.vmap(self.scales_to_cov)(state.scales)
        return state.loc, covs, np.asarray(losses).T
