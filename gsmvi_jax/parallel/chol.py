"""Distributed-friendly blocked Cholesky for the sharded large-D path.

The dense fitters' validity check and sampling factor come from one
``jnp.linalg.cholesky`` on the (D, D) covariance (state.accept_or_revert).
XLA's cholesky is a single opaque op: under a model-sharded covariance
(``parallel/large_d.py``) GSPMD must ALL-GATHER the matrix to every chip,
factor it redundantly, and keep the O(D^2) gather in the hot loop — the one
remaining non-distributed O(D^3) step (SURVEY.md §2 "long-context analog").

This module re-expresses the factorization as the classical right-looking
blocked algorithm — the ScaLAPACK/"How to Scale Your Model" recipe mapped to
GSPMD instead of explicit MPI:

    for each diagonal block k (static Python unroll, nb = ceil(D/b) blocks):
        L_kk = chol(A_kk)                     (b x b, tiny, sequential)
        L_pk = A_pk L_kk^-T                   (triangular solve on the b side)
        A_tt = A_tt - L_pk L_pk^T             (rank-b GEMM: the O(D^3) part)

Only the (b x b) diagonal factorizations are inherently sequential
(O(nb * b^3) total work); ALL the O(D^3) flops live in the trailing rank-b
matmuls, which are ordinary dot_generals that GSPMD partitions over a
model-sharded mesh with NVLink collectives — no gather of the full matrix ever
materializes.  A sharding constraint re-pins the trailing matrix each
round so the partitioning survives the whole unroll.

NaN semantics match ``jnp.linalg.cholesky``: a non-PD diagonal block yields
NaNs that propagate through the solve and every later block, so the
fitters' ``isfinite`` goodness check (state.py:57-58) works unchanged.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular


def blocked_cholesky(a, block_size: int = 256, out_sharding=None):
    """Lower-Cholesky factor of SPD ``a`` via static right-looking blocks.

    ``block_size`` trades sequential-panel cost against trailing-GEMM size;
    ``out_sharding`` (a ``NamedSharding``, e.g. ``large_d.cov_sharding``)
    re-pins the trailing matrix after each rank-b update so the GEMMs stay
    partitioned.  Shapes are static (the Python loop unrolls nb blocks of
    decreasing size), so the whole factorization jits into one program.
    """
    d = a.shape[-1]
    if a.shape != (d, d):
        raise ValueError(f"expected square matrix, got {a.shape}")
    b = int(min(block_size, d))
    if b <= 0:
        raise ValueError("block_size must be positive")
    if b >= d:
        return jnp.linalg.cholesky(a)

    trailing = a
    cols = []
    offset = 0
    while offset < d:
        bk = min(b, d - offset)
        akk = trailing[:bk, :bk]
        lkk = jnp.linalg.cholesky(akk)
        rest = trailing.shape[0] - bk
        if rest == 0:
            cols.append(jnp.pad(lkk, ((offset, 0), (0, 0))))
            break
        apk = trailing[bk:, :bk]
        # L_pk = A_pk L_kk^{-T}: solve on the SMALL (b) side only.
        lpk = solve_triangular(lkk, apk.T, lower=True).T
        cols.append(jnp.pad(jnp.concatenate([lkk, lpk], axis=0),
                            ((offset, 0), (0, 0))))
        att = trailing[bk:, bk:] - lpk @ lpk.T
        if out_sharding is not None and rest >= b:
            att = jax.lax.with_sharding_constraint(att, out_sharding)
        trailing = att
        offset += bk
    l = jnp.concatenate(cols, axis=1)
    if out_sharding is not None:
        l = jax.lax.with_sharding_constraint(l, out_sharding)
    return l


def make_blocked_cholesky(block_size: int = 256, out_sharding=None):
    """Partial application matching the ``chol_fn`` hook of
    ``state.accept_or_revert`` / ``GSM(chol_block=...)``."""
    return lambda a: blocked_cholesky(a, block_size, out_sharding)
