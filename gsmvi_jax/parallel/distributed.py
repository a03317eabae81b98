"""Multi-host initialization helpers.

Replaces the "NCCL/MPI communication backend" slot of a conventional
distributed framework with JAX's runtime: ``jax.distributed.initialize``
wires up all hosts of a cluster, after which ``jax.devices()`` spans every
host and the same mesh-sharded fit code runs unchanged (collectives ride
NVLink within a host and the network across hosts, placed by XLA).
"""

from __future__ import annotations

from typing import Optional

import jax


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           auto: bool = False, **init_kwargs) -> bool:
    """Initialize multi-host JAX; returns True when running distributed.

    On clusters whose environment JAX recognises (e.g. SLURM) the arguments
    are discovered automatically, so ``initialize_distributed(auto=True)`` is
    the whole multi-host setup; elsewhere pass them explicitly.  Safe to
    call when already initialized (no-op) and when single-process (returns
    False).

    Failure semantics: with EXPLICIT arguments a failed initialization
    raises (a misconfigured pod must not silently fall back to
    single-process fitting); with ``auto=True`` discovery failures return
    False, since auto mode legitimately runs single-process.

    ``init_kwargs`` pass through to ``jax.distributed.initialize`` (e.g.
    ``initialization_timeout`` for fail-fast cluster bring-up).
    """
    already = getattr(jax.distributed, "is_initialized", None)
    if callable(already) and already():
        return jax.process_count() > 1
    # Explicitness is judged by "is not None", NOT truthiness: a launcher
    # passing coordinator_address="" (missing env var) or only process_id=0
    # has explicitly asked for distributed setup and must reach initialize
    # (and raise on its failure) rather than silently fall back.
    explicit = (coordinator_address is not None
                or num_processes is not None or process_id is not None)
    if not (auto or explicit):
        return False
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            **init_kwargs,
        )
    except Exception:
        if explicit:
            raise
        return False
    return jax.process_count() > 1
