"""Configuration: kwarg-first (reference parity) plus a small typed config.

The reference has no config system — everything is kwargs, with env vars and
``jax_enable_x64`` toggled by hand in examples (``examples/example_bam.py:4-15``).
This module keeps the kwarg-first API and centralizes the environment knobs:

- ``FitConfig``    — a dataclass bundling the common ``fit`` kwargs, usable as
  ``fitter.fit(key, **config.fit_kwargs())``.
- ``enable_x64``   — the x64 toggle the BaM/LBFGS examples need.
- ``xla_memory_env`` — the XLA preallocation env var the reference examples
  set manually (``examples/example_bam.py:4-7``).
- ``use_compile_cache`` — where compiled programs persist between runs.
"""

from __future__ import annotations

import os
from dataclasses import asdict, dataclass

import jax


@dataclass
class FitConfig:
    """Common fit options (defaults = reference defaults, ``gsmvi/gsm.py:79``)."""

    batch_size: int = 2
    niter: int = 5000
    nprint: int = 10
    verbose: bool = True

    def fit_kwargs(self) -> dict:
        return asdict(self)


def enable_x64(enable: bool = True) -> None:
    """Toggle 64-bit jax globally (reference examples do this inline)."""
    jax.config.update("jax_enable_x64", enable)


def xla_memory_env(preallocate: bool = False) -> None:
    """Set the XLA client preallocation env var the reference examples
    recommend.  Must run before the backend initializes to take effect.
    """
    os.environ.setdefault("XLA_PYTHON_CLIENT_PREALLOCATE",
                          "true" if preallocate else "false")


def use_compile_cache(root: str) -> str:
    """Keep JAX's persistent compilation cache across runs; returns its
    directory.  ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as is
    (JAX reads it itself); otherwise the cache goes to ``<root>/.jax_cache``
    — a fixed path, since the path is part of the cache's key."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(os.path.abspath(root), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
