"""Device-mesh construction and canonical shardings.

Score-matching VI has exactly one batch axis — the per-iteration Monte-Carlo
sample batch (B, D) — and small replicated parameters (mean (D,), cov (D, D)).
The canonical layout is therefore a 1-D ``data`` mesh:

    samples, scores : P('data', None)   (rows split across chips)
    mean, cov, chol : replicated

Under ``jit`` the Gram-matrix contractions over the batch axis
(``A.T @ A`` in ops/gsm.py, ``Xd.T @ Xd`` in ops/bam.py) then lower to
per-device partial matmuls + a ``psum`` (NVLink on one host) inserted by
GSPMD.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over ``n_devices`` (default: all local devices)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def data_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Sharding for (B, D) sample/score batches: rows over the data axis."""
    return NamedSharding(mesh, P(axis, None))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    """Fully-replicated sharding (variational parameters)."""
    return NamedSharding(mesh, P())
