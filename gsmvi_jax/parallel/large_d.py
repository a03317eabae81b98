"""Large-D scaling: 2-D (data x model) meshes with column-sharded covariance.

SURVEY.md §2 marks model-dim sharding of the D x D covariance as the stretch
goal beyond replicated-Σ data parallelism (the "long-context analog" — state
is O(D²), solves O(D³)).  This module provides the GSPMD route:

- a 2-D mesh ``(data, model)``;
- sharding constraints that keep the covariance (and the (B, D) row tensors'
  feature axis) split over ``model`` chips while the MC batch splits over
  ``data``;
- a fitter hook (``GSM(..., cov_sharding=...)``) applying the constraint each
  step so XLA partitions the Gram/score matmuls into per-chip panels with
  collectives over NVLink.

With ``GSM(..., chol_block=)`` the validity/sampling factorization runs as
the blocked right-looking Cholesky (``parallel/chol.py``) whose O(D³) work is
ordinary rank-b GEMMs GSPMD keeps partitioned — no per-step all-gather of Σ.
Measured per-device memory (8-way model mesh, D=2048, f32, CPU-mesh compile):
state 32 → 4 MB, peak temps 32.3 → 9.4 MB vs the replicated compile; a
gathered Σ would show a ≥16 MB temp (pinned by
``tests/test_sharding.py::test_sharded_step_memory_stays_partitioned``).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh_2d(n_data: int, n_model: int, data_axis: str = "data",
                 model_axis: str = "model",
                 devices=None) -> Mesh:
    """(n_data x n_model) mesh; requires n_data * n_model devices."""
    if devices is None:
        devices = jax.devices()
    need = n_data * n_model
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.asarray(devices[:need]).reshape(n_data, n_model)
    return Mesh(arr, (data_axis, model_axis))


def cov_sharding(mesh: Mesh, model_axis: str = "model") -> NamedSharding:
    """Column-shard a (D, D) matrix over the model axis."""
    return NamedSharding(mesh, P(None, model_axis))


def batch_sharding_2d(mesh: Mesh, data_axis: str = "data",
                      model_axis: Optional[str] = None) -> NamedSharding:
    """(B, D) batches: rows over data, optionally features over model."""
    return NamedSharding(mesh, P(data_axis, model_axis))
