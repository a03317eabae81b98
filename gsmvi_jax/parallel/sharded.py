"""Explicit ``shard_map`` score-statistics: collectives spelled out.

The fitter classes rely on GSPMD to partition the fused update (see
``gsm.py`` module docstring).  This module provides the equivalent with the
communication pattern written explicitly — per-shard Gram partials reduced
with ``psum`` over the ``data`` axis — which serves three purposes:

1. a sharding-correctness oracle for tests (must equal the GSPMD result),
2. a template for users whose ``lp_g`` has per-device semantics (e.g. device-
   local minibatches of data in a subsampled posterior),
3. guaranteed collective placement when GSPMD's choices need overriding.

Design note: only O(B*D) row tensors cross the sharded region; the O(D^2)
Gram partial sums are formed per-chip and ``psum``-reduced once — the
communication volume per iteration is 2*D^2 words regardless of batch size.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.gsm import gsm_update_stats


def sharded_gsm_stats(mesh: Mesh, lp_g, samples, mu0, S0, axis: str = "data"):
    """(dmu, dS) for a GSM step with samples sharded over ``axis``.

    ``lp_g`` is applied to the local shard on each device; the per-sample
    update deltas are averaged globally via ``psum`` of per-shard sums.
    """
    n = mesh.shape[axis]

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(), P()),
        out_specs=(P(), P()),
    )
    def stats(samples_local, mu0, S0):
        vs_local = lp_g(samples_local)
        dmu_l, ds_l = gsm_update_stats(samples_local, vs_local, mu0, S0)
        # gsm_update_stats means over the *local* batch; rescale to the global
        # mean: global_mean = psum(local_mean) / n_shards (equal shard sizes).
        dmu = jax.lax.psum(dmu_l, axis) / n
        ds = jax.lax.psum(ds_l, axis) / n
        return dmu, ds

    return stats(samples, mu0, S0)


def sharded_bam_stats(mesh: Mesh, lp_g, samples, axis: str = "data"):
    """(xbar, C, gbar, G) for a BaM step with samples sharded over ``axis``.

    Two communication rounds: first the global means (psum of per-shard sums,
    2*D words), then the Gram partials of globally-centered rows (psum of two
    D x D matrices).  Centering against the *global* mean before the Gram
    keeps the result exact — no E[xx^T] - xbar xbar^T cancellation.
    """
    b = samples.shape[0]

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis, None),),
        out_specs=(P(), P(), P(), P()),
    )
    def stats(samples_local):
        vs_local = lp_g(samples_local)
        sx = jax.lax.psum(jnp.sum(samples_local, axis=0), axis)
        sg = jax.lax.psum(jnp.sum(vs_local, axis=0), axis)
        xbar = sx / b
        gbar = sg / b
        xd = samples_local - xbar
        gd = vs_local - gbar
        c = jax.lax.psum(
            jnp.matmul(xd.T, xd, preferred_element_type=xd.dtype), axis) / b
        g = jax.lax.psum(
            jnp.matmul(gd.T, gd, preferred_element_type=gd.dtype), axis) / b
        return xbar, c, gbar, g

    return stats(samples)


def sharded_gsm_fit(mesh: Mesh, lp_g, key, d: int, niter: int,
                    batch_size: int, mean=None, cov=None, axis: str = "data",
                    dtype=None):
    """Full GSM fit driven by the explicit shard_map step.

    The whole fit is one jitted scan whose body samples on device (eps
    carries a ``P(axis, None)`` sharding constraint, identical to the GSPMD
    fitter's layout), computes the update via ``sharded_gsm_stats`` —
    per-shard Gram partials ``psum``-reduced over ``axis`` — and applies the
    on-device accept/revert.  Semantically identical to ``GSM(mesh=...).fit``;
    exists so the collective placement is explicit rather than
    GSPMD-inferred (and as the correctness oracle pinning the GSPMD path).

    Returns the final ``VIState``.
    """
    from jax.sharding import NamedSharding

    from ..state import accept_or_revert, init_state

    sharding = NamedSharding(mesh, P(axis, None))
    state = init_state(key, d, mean, cov, dtype)
    dt = state.mean.dtype

    def step(state):
        with jax.default_matmul_precision("float32"):
            key, key_sample = jax.random.split(state.key)
            eps = jax.random.normal(key_sample, (batch_size, d), dt)
            eps = jax.lax.with_sharding_constraint(eps, sharding)
            samples = state.mean + eps @ state.chol.T
            dmu, ds = sharded_gsm_stats(mesh, lp_g, samples, state.mean,
                                        state.cov, axis=axis)
            return accept_or_revert(state, state.mean + dmu, state.cov + ds,
                                    key)

    @jax.jit
    def run(s):
        return jax.lax.scan(lambda c, _: (step(c), None), s, None,
                            length=niter + 1)[0]

    return run(state)


def sharded_score_eval(mesh: Mesh, lp_g, samples, axis: str = "data"):
    """Evaluate ``lp_g`` data-parallel over the mesh; output stays sharded."""

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(axis, None),),
             out_specs=P(axis, None))
    def go(samples_local):
        return lp_g(samples_local)

    return go(samples)

