"""gsmvi_jax — score-matching variational inference on JAX accelerators.

A from-scratch JAX/XLA framework with the capabilities of GSM-VI
(reference: modichirag/GSM-VI): three fitters approximating a target
distribution — given only ``lp(x)`` and ``lp_g(x) = grad log p`` — with a
dense-covariance Gaussian:

- ``GSM``  — Gaussian Score Matching, closed-form updates (arXiv:2307.07849)
- ``BaM``  — Batch-and-Match regularized score matching (arXiv:2402.14758),
  full-rank and low-rank, fully on-device (no host callbacks)
- ``ADVI`` — ELBO maximization over (mean, Cholesky) with optax

plus ``KLMonitor``, ``lbfgs_init``, ``Regularizers``, a target-model zoo
(``models``), a mesh/sharding layer (``parallel``), fused update kernels
(``ops``), and checkpointing.

Unlike the reference (whose package root is empty, ``gsmvi/__init__.py``),
the main entry points are re-exported here; reference-style submodule imports
(``from gsmvi_jax.gsm import GSM``) work identically.
"""

from .advi import ADVI
from .bam import BaM
from .bam_factor import FactorBaM
from .distributions import Gaussian, mvn_kl, mvn_logpdf, mvn_sample
from .gsm import GSM
from .gsm_factor import FactorGSM
from .posterior import Posterior
from .ops.bam import Regularizers, bam_lowrank_update, bam_update
from .ops.gsm import gsm_update
from .state import VIState, init_state
from .utils.initializers import lbfgs_init, map_init
from .utils.monitors import KLMonitor

__version__ = "0.1.0"

__all__ = [
    "ADVI", "BaM", "FactorBaM", "FactorGSM", "GSM", "Gaussian", "KLMonitor",
    "Posterior",
    "Regularizers", "VIState",
    "bam_lowrank_update", "bam_update", "gsm_update", "init_state",
    "lbfgs_init", "map_init", "mvn_kl", "mvn_logpdf", "mvn_sample",
]
