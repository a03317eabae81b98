"""Checkpoint / resume for fit state.

The reference has no checkpointing (SURVEY.md §5): ``fit`` runs to completion
and warm-starting is only possible via the ``mean=``/``cov=`` kwargs.  The
state here is tiny — (mean, cov, chol, key, counters) — so checkpoints are a
single-file save.  Two backends:

- numpy ``.npz`` (always available, human-inspectable), the default;
- orbax (when installed) for async multi-host checkpointing via
  ``save_orbax``/``restore_orbax``.

``fit(..., mean=, cov=)`` remains the warm-start path for API parity; a saved
``VIState`` additionally restores the RNG key and step/accept counters so a
resumed fit continues the exact trajectory.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from ..state import VIState

_FIELDS = ("mean", "cov", "chol", "key", "step", "n_accepted", "n_rejected")
_FACTOR_FIELDS = ("mean", "factor", "finv", "key", "step", "n_accepted",
                  "n_rejected")


def save_state(path: str, state) -> None:
    """Write a ``VIState`` or ``FactorVIState`` to ``path`` (.npz appended
    if missing).  Factor states save their REAL fields (factor/finv, not the
    materialized cov/chol properties) so ``load_state`` round-trips to a
    state that resumes a FactorGSM/FactorBaM fit exactly."""
    fields = _FACTOR_FIELDS if hasattr(state, "factor") else _FIELDS
    # The key is handled separately: new-style typed PRNG keys reject
    # np.asarray, so they must never enter the generic comprehension.
    arrays = {f: np.asarray(getattr(state, f)) for f in fields if f != "key"}
    if hasattr(state, "factor"):
        arrays["_factor_state"] = np.asarray(True)
    key = state.key
    if hasattr(key, "dtype") and jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        arrays["key"] = np.asarray(jax.random.key_data(key))
        arrays["_key_typed"] = np.asarray(True)
    else:
        arrays["key"] = np.asarray(key)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path if path.endswith(".npz") else path + ".npz", **arrays)


def load_state(path: str):
    """Load a ``VIState`` (or ``FactorVIState``) saved by ``save_state``."""
    if not path.endswith(".npz") and not os.path.exists(path):
        path = path + ".npz"
    with np.load(path) as data:
        key = jnp.asarray(data["key"])
        if "_key_typed" in data:
            key = jax.random.wrap_key_data(key)
        if "_factor_state" in data:
            from ..gsm_factor import FactorVIState

            # Checkpoints written before the NS ladder was removed also
            # carry an ``ns_stats`` array; it is ignored.
            return FactorVIState(
                mean=jnp.asarray(data["mean"]),
                factor=jnp.asarray(data["factor"]),
                finv=jnp.asarray(data["finv"]),
                key=key,
                step=jnp.asarray(data["step"]),
                n_accepted=jnp.asarray(data["n_accepted"]),
                n_rejected=jnp.asarray(data["n_rejected"]),
            )
        return VIState(
            mean=jnp.asarray(data["mean"]),
            cov=jnp.asarray(data["cov"]),
            chol=jnp.asarray(data["chol"]),
            key=key,
            step=jnp.asarray(data["step"]),
            n_accepted=jnp.asarray(data["n_accepted"]),
            n_rejected=jnp.asarray(data["n_rejected"]),
        )


def save_orbax(path: str, state: VIState) -> None:
    """Orbax checkpoint (multi-host safe); requires orbax-checkpoint."""
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    ckptr.save(os.path.abspath(path), state._asdict(), force=True)
    ckptr.wait_until_finished()


def restore_orbax(path: str) -> VIState:
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    restored = ckptr.restore(os.path.abspath(path))
    return VIState(**{f: jnp.asarray(restored[f]) for f in _FIELDS})
