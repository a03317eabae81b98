"""FactorGSM: the Cholesky-free GSM fitter (see ops/gsm_factor.py).

Same fitting semantics and ``fit`` surface as ``GSM``, but the state carries a
square-root factor ``F`` (S = F F^T) and its inverse instead of (cov, chol):

- sampling is ``mu + eps @ F.T`` (any factor works — no triangularity needed);
- the covariance update is a rank-2B factor correction, O(B D^2) matmuls;
- validity is the exact PD criterion ``min eig(I + H) > 0`` from a (2B x 2B)
  eigh — sharper and far cheaper than the dense path's D x D Cholesky probe.

The hot loop contains no O(D^3) factorization (the dense step's D x D
Cholesky is panel-sequential and grows as D^3).  An optional Newton refresh
of Finv runs every ``refresh_every`` steps (O(D^3) matmuls, amortized to
noise).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .distributions import safe_cholesky
from .driver import RunnerCache, is_traceable, make_chunk_runner, \
    run_fit_loop
from .ops.gsm_eps import apply_eps_step
from .ops.gsm_eps_ns import gsm_eps_update_ns_xla, ns_iters_for_batch
from .ops.gsm_factor import (factor_gsm_step_stats, factor_gsm_step_stats_v2,
                             factor_refresh, factor_to_cov)
from .parallel.mesh import data_sharding


class FactorVIState(NamedTuple):
    mean: jax.Array     # (D,)
    factor: jax.Array   # (D, D), S = factor @ factor.T
    finv: jax.Array     # (D, D), maintained inverse of factor
    key: jax.Array
    step: jax.Array
    n_accepted: jax.Array
    n_rejected: jax.Array

    # Duck-typed accessors so monitors/checkpoint helpers written for VIState
    # largely work; cov is materialized on demand.
    @property
    def cov(self):
        return factor_to_cov(self.factor)

    @property
    def chol(self):
        return safe_cholesky(self.cov)


class FactorGSM:
    """Cholesky-free GSM fitter; ``fit`` surface matches ``GSM.fit``."""

    def __init__(self, D, lp, lp_g, mesh=None, data_axis: str = "data",
                 dtype=None, refresh_every: int = 1000,
                 method: str = "eps", cov_sharding=None,
                 pallas_precision: str = "highest", ns_iters=None):
        """``method``:
        - "eps" (default): eps-coordinate update (ops/gsm_eps.py) — the
          state is (mean, F) only; no maintained inverse, no QR, no eigh;
          the small solves are (2B x 2B) Choleskys.
        - "twophase": round-1 matmul-only rank-B update/downdate phases
          (maintains Finv).
        - "qr": thin-QR orthogonal reduction (maintains Finv).

        ``pallas_precision`` ("highest" default | "high" | "bf16") sets the
        precision of the O(B D^2) products of the Newton-Schulz eps step
        (``fit_batch``'s default solver): "highest" is full float32; "high"
        and "bf16" map to ``lax.Precision.HIGH`` and ``DEFAULT``, which on an
        NVIDIA GPU run the products on the tensor cores in reduced
        precision (TF32 on Hopper).  The (B, B) small-space numerics and
        their PD gates always run at full float32.  Measure converged
        moments before adopting a relaxed setting: the residual gates do not
        catch the slow bias of reduced-precision products.

        ``ns_iters`` — Newton-Schulz sweep counts (sqrt1, inv1, inv2, sqrt2,
        inv3) for that step's small space; None picks the batch-aware
        default (``ops.gsm_eps_ns.ns_iters_for_batch``).  CAUTION: cutting
        iters[2] below 6 biases the converged covariance with zero
        rejections — validate converged moments when changing it.
        """
        self.D = D
        self.lp = lp
        self.lp_g = lp_g
        self.mesh = mesh
        self.data_axis = data_axis
        self.dtype = dtype or jnp.zeros(0).dtype
        self.refresh_every = refresh_every
        self.method = method
        self.ns_iters = tuple(ns_iters) if ns_iters is not None else None
        self.pallas_precision = {
            "highest": jax.lax.Precision.HIGHEST,
            "high": jax.lax.Precision.HIGH,
            "bf16": jax.lax.Precision.DEFAULT,
        }[pallas_precision]
        # Optional NamedSharding splitting the (D, D) factor over a model
        # axis: the LARGE-D scaling path.  Unlike the dense fitter — whose
        # per-step D x D Cholesky XLA must gather — the eps step is pure
        # matmuls, which GSPMD partitions cleanly over a 2-D (data x model)
        # mesh; only O(B*D) row tensors and (2B)^2 scalars cross devices.
        self.cov_sharding = cov_sharding
        self._runners = RunnerCache()

    def _iters(self, batch_size: int):
        """NS profile for this batch: user override or the batch-aware
        default (``ns_iters_for_batch`` — B <= 32 short, else long)."""
        return ns_iters_for_batch(batch_size, self.ns_iters)

    def _get_runner(self, batch_size: int):
        # The key covers the hashable config the compiled runner closes over.
        return self._runners.get(
            (batch_size, self.method, self.refresh_every), (),
            lambda: make_chunk_runner(self._make_step(batch_size)))

    def _make_step(self, batch_size: int, ns: bool = False):
        """``ns``: run the eps method's small space as the matmul-only
        Newton-Schulz chains (``ops.gsm_eps_ns``; f32 only) instead of the
        exact (2B x 2B) Cholesky step."""
        lp_g = self.lp_g
        d = self.D
        dtype = self.dtype
        refresh_every = self.refresh_every
        method = self.method
        sharding = (
            data_sharding(self.mesh, self.data_axis)
            if self.mesh is not None else None
        )
        use_ns_xla = ns and method == "eps" and dtype == jnp.float32
        cov_sh = self.cov_sharding

        def step(state: FactorVIState) -> FactorVIState:
            with jax.default_matmul_precision("float32"):
                return _step_body(state)

        def _step_body(state: FactorVIState) -> FactorVIState:
            key, key_sample = jax.random.split(state.key)
            eps = jax.random.normal(key_sample, (batch_size, d), dtype)
            if sharding is not None:
                eps = jax.lax.with_sharding_constraint(eps, sharding)
            ef = eps @ state.factor.T
            samples = state.mean + ef
            # Pin the score to the state dtype: a user lp_g emitting f64
            # under global x64 would otherwise promote the whole carry.
            vs = lp_g(samples).astype(dtype)
            if method == "eps":
                if use_ns_xla:
                    # ef is shared with the update: the batched-replica step
                    # streams the (K, D, D) factor once less per step.
                    mean, f, good = gsm_eps_update_ns_xla(
                        eps, vs, state.mean, state.factor,
                        iters=self._iters(batch_size),
                        big_prec=self.pallas_precision,
                        ef_t=ef.astype(jnp.float32))
                else:
                    mean, f, good = apply_eps_step(state.mean, state.factor,
                                                   eps, vs)
                if cov_sh is not None:
                    f = jax.lax.with_sharding_constraint(f, cov_sh)
                g32 = good.astype(jnp.int32)
                return FactorVIState(mean, f, state.finv, key,
                                     state.step + 1,
                                     state.n_accepted + g32,
                                     state.n_rejected + (1 - g32))
            step_stats = (factor_gsm_step_stats_v2 if method == "twophase"
                          else factor_gsm_step_stats)
            dmu, f_new, finv_new, good = step_stats(
                samples, vs, state.mean, state.factor, state.finv)
            mean = jnp.where(good, state.mean + dmu, state.mean)
            f = jnp.where(good, f_new, state.factor)
            finv = jnp.where(good, finv_new, state.finv)
            if refresh_every:
                finv = jax.lax.cond(
                    (state.step + 1) % refresh_every == 0,
                    lambda args: factor_refresh(*args),
                    lambda args: args[1],
                    (f, finv),
                )
            g32 = good.astype(jnp.int32)
            return FactorVIState(mean, f, finv, key, state.step + 1,
                                 state.n_accepted + g32,
                                 state.n_rejected + (1 - g32))

        return step

    def fit(self, key, mean=None, cov=None, batch_size=2, niter=5000,
            nprint=10, verbose=True, check_goodness=True, monitor=None,
            return_state=False, state=None):
        """Same contract as ``GSM.fit`` (reference ``gsmvi/gsm.py:79``).

        ``state`` — optional ``FactorVIState`` (from ``return_state=True``)
        resuming the exact trajectory, ignoring ``key``/``mean``/``cov``.
        """
        dtype = self.dtype
        if state is None:
            mean0 = (jnp.zeros(self.D, dtype) if mean is None
                     else jnp.asarray(mean, dtype))
            if cov is None:
                f0 = jnp.eye(self.D, dtype=dtype)
            else:
                f0 = safe_cholesky(jnp.asarray(cov, dtype))
            if self.method == "eps":
                # The eps method never applies F^{-1}; carry an empty
                # placeholder so the scan state stays (mean, F) sized.
                finv0 = jnp.zeros((0, 0), dtype)
            else:
                finv0 = jax.scipy.linalg.solve_triangular(
                    f0, jnp.eye(self.D, dtype=dtype), lower=True)
            zero = jnp.zeros((), jnp.int32)
            state = FactorVIState(mean0, f0, finv0, key, zero, zero, zero)

        probe = jax.ShapeDtypeStruct((batch_size, self.D), dtype)
        if not is_traceable(self.lp_g, probe):
            raise TypeError(
                "FactorGSM requires a jax-traceable lp_g; use GSM for "
                "plain-numpy score functions")
        state = run_fit_loop(
            None,  # cached run_chunk / eager_step below carries the body
            state,
            niter,
            monitor=monitor,
            monitor_params=lambda s: [s.mean, factor_to_cov(s.factor)],
            lp=self.lp,
            nprint=nprint,
            verbose=verbose,
            batch_size=batch_size,
            run_chunk=self._get_runner(batch_size),
        )
        if return_state:
            return state
        return state.mean, factor_to_cov(state.factor)

    def fit_batch(self, keys, mean=None, cov=None, batch_size=2, niter=5000,
                  return_state=False, small_solver="auto"):
        """K independent FactorGSM replicas in one compiled program.

        ``small_solver`` — the batched per-replica step implementation:

        - "auto" (default) / "ns": the matmul-only Newton-Schulz small space
          (``gsm_eps_update_ns_xla``) when ``method="eps"`` and the dtype
          is f32 — the whole batched step is (K-batched) matmuls and
          elementwise ops; the step shares the sampling product and applies
          the factor correction as one (D, 2B) contraction.  Falls back to
          "chol" otherwise.
        - "chol": the exact-PD-check Cholesky eps step
          (``ops.gsm_eps.apply_eps_step``), whose batched small solves are
          sequential factorizations.
        """
        if small_solver not in ("auto", "ns", "chol"):
            raise ValueError(f"unknown small_solver: {small_solver!r}")
        k = keys.shape[0]
        d = self.D
        dtype = self.dtype

        from .driver import broadcast_replicas

        def broadcast(x, default, shape):
            return broadcast_replicas(x, default, k, shape, dtype)

        means0 = broadcast(mean, jnp.zeros(d, dtype), (d,))
        covs0 = broadcast(cov, jnp.eye(d, dtype=dtype), (d, d))

        def init_one(kk, m, c):
            f0 = safe_cholesky(c)
            if self.method == "eps":
                finv0 = jnp.zeros((0, 0), dtype)
            else:
                finv0 = jax.scipy.linalg.solve_triangular(
                    f0, jnp.eye(d, dtype=dtype), lower=True)
            zero = jnp.zeros((), jnp.int32)
            return FactorVIState(m, f0, finv0, kk, zero, zero, zero)

        state = jax.vmap(init_one)(keys, means0, covs0)
        step = jax.vmap(self._make_step(batch_size,
                                        ns=small_solver != "chol"))

        @jax.jit
        def run(s):
            return jax.lax.scan(lambda c, _: (step(c), None), s, None,
                                length=niter + 1)[0]

        state = run(state)
        if return_state:
            return state
        return state.mean, jax.vmap(factor_to_cov)(state.factor)
