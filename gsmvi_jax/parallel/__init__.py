"""Mesh/sharding layer: data-parallel score matching over several devices.

The reference has no distributed code at all (single process, host-side
sampling; survey §2 "Parallelism strategies: none").  This package supplies
the on-device equivalents:

- ``mesh``        — mesh construction + canonical shardings (batch sharded on
  a ``data`` axis, variational params replicated).
- ``sharded``     — explicit ``shard_map`` step with ``psum``-reduced batch
  statistics, for users who want collective placement spelled out (the
  jit/GSPMD path in the fitters gets the same result automatically).
- ``distributed`` — ``jax.distributed.initialize`` helpers for multi-host runs.
- ``chol``        — blocked right-looking Cholesky whose O(D^3) trailing
  GEMMs stay partitioned under a model-sharded covariance (no per-step
  all-gather of Σ).
"""

from .mesh import data_sharding, make_mesh, replicated_sharding
from .distributed import initialize_distributed
from .large_d import batch_sharding_2d, cov_sharding, make_mesh_2d
from .chol import blocked_cholesky, make_blocked_cholesky
