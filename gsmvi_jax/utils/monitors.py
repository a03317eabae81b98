"""KL-divergence monitor; protocol parity with reference ``gsmvi/monitors.py``.

The hook contract is identical to the reference (``gsmvi/monitors.py:83-125``):
fitters call ``monitor(i, [mean, cov], lp, key, nevals=...)`` every
``monitor.checkpoint`` iterations and the monitor appends to ``rkl`` / ``fkl``
/ ``nevals`` lists, where ``nevals`` is the cumulative-gradient-evaluation cost
axis offset by ``offset_evals`` (to account for e.g. LBFGS warmup,
``gsmvi/monitors.py:50-53,122-123``).

Differences from the reference:
- q-samples are drawn on device from the Cholesky factor (single matmul)
  instead of host ``np.random.multivariate_normal`` (``gsmvi/monitors.py:106``),
  and densities use the native MVN (no numpyro).
- The estimator is jitted once and reused; under a sharded fit the batch KL
  reduction is just a sharded sum, so the monitor works unchanged on a mesh.
- Exceptions still append NaN (parity with ``gsmvi/monitors.py:117-120``).

Standalone estimators ``reverse_kl`` / ``forward_kl`` keep the reference's
(samples, lpq, lpp) signature (``gsmvi/monitors.py:10-22``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..distributions import full_f32, mvn_logpdf, safe_cholesky


def reverse_kl(samples, lpq, lpp):
    """Monte-Carlo E_q[log q - log p] from q-samples (parity signature)."""
    logq = np.sum(np.asarray(lpq(samples)))
    logl = np.sum(np.asarray(lpp(samples)))
    return (logq - logl) / samples.shape[0]


def forward_kl(samples, lpq, lpp):
    """Monte-Carlo E_p[log p - log q] from p-samples (parity signature)."""
    logq = np.sum(np.asarray(lpq(samples)))
    logl = np.sum(np.asarray(lpp(samples)))
    return (logl - logq) / samples.shape[0]


@dataclass
class KLMonitor:
    """Track reverse (and optionally forward) KL during a fit.

    Attributes and call protocol match reference ``gsmvi/monitors.py:43-125``:
      batch_size_kl — q-samples per estimate.
      checkpoint    — fitter calls the monitor every ``checkpoint`` iterations.
      offset_evals  — starting offset for the cumulative-evals cost axis.
      ref_samples   — optional target samples enabling the forward-KL track.
    After a fit: ``rkl``, ``fkl`` (lists of floats, NaN where unavailable),
    ``nevals`` (cumulative gradient evaluations).
    """

    batch_size_kl: int = 8
    checkpoint: int = 20
    offset_evals: int = 0
    ref_samples: Optional[np.ndarray] = None
    store_params: bool = False

    def __post_init__(self):
        self.rkl = []
        self.fkl = []
        self.nevals = []
        self.params_trace = []
        self._sample_logq = jax.jit(self._sample_and_logq, static_argnums=3)

    def reset(self, batch_size_kl=None, checkpoint=None, offset_evals=None,
              ref_samples=None):
        self.rkl = []
        self.fkl = []
        self.nevals = []
        self.params_trace = []
        if batch_size_kl is not None:
            self.batch_size_kl = batch_size_kl
        if checkpoint is not None:
            self.checkpoint = checkpoint
        if offset_evals is not None:
            self.offset_evals = offset_evals
        if ref_samples is not None:
            self.ref_samples = ref_samples

    # -- estimators ---------------------------------------------------------
    @staticmethod
    @full_f32
    def _sample_and_logq(mean, chol, key, n):
        eps = jax.random.normal(key, (n, mean.shape[-1]), mean.dtype)
        qsamples = mean + eps @ chol.T
        logq = jnp.sum(mvn_logpdf(qsamples, mean, chol))
        return qsamples, logq

    def __call__(self, i, params, lp, key, nevals=1):
        """Reference hook signature (``gsmvi/monitors.py:83``); returns a fresh
        key (which, like the reference's fitters, callers may ignore).

        ``lp`` is evaluated outside jit so plain-numpy targets work too; the
        sampling + q-density side is a single jitted device computation.
        """
        mean, cov = params[0], params[1]
        # The numpy-compat fitter passes a plain int seed where the JAX
        # fitters pass a PRNG key (reference ``gsmvi/gsm_numpy.py:82,105``);
        # coerce so the split below cannot raise outside the try block.
        if isinstance(key, (int, np.integer)):
            key = jax.random.PRNGKey(int(key))
        key, key_sample, key_idx = jax.random.split(key, 3)
        # Exactly ONE (rkl, fkl) entry per checkpoint even on partial
        # failure: an exception after rkl.append (e.g. lp raising on the
        # forward-KL samples) must not double-append and desync the
        # rkl/fkl/nevals ledgers.  (The reference has this bug,
        # ``gsmvi/monitors.py:117-120``; the NaN-on-failure contract is
        # kept, the ledger corruption is not.)
        n_rkl, n_fkl = len(self.rkl), len(self.fkl)
        try:
            chol = safe_cholesky(jnp.asarray(cov))
            if bool(jnp.any(~jnp.isfinite(chol))):
                raise FloatingPointError("covariance is not positive definite")
            qsamples, logq = self._sample_logq(
                jnp.asarray(mean), chol, key_sample, self.batch_size_kl)
            logl = float(np.sum(np.asarray(lp(qsamples))))
            self.rkl.append((float(logq) - logl) / self.batch_size_kl)
            if self.ref_samples is not None:
                n_ref = self.ref_samples.shape[0]
                idx = np.asarray(
                    jax.random.choice(key_idx, n_ref,
                                      (min(self.batch_size_kl, n_ref),),
                                      replace=False))
                psamples = jnp.asarray(self.ref_samples)[idx]
                logq = float(jnp.sum(mvn_logpdf(psamples, jnp.asarray(mean), chol)))
                logl = float(np.sum(np.asarray(lp(psamples))))
                self.fkl.append((logl - logq) / psamples.shape[0])
            else:
                self.fkl.append(float("nan"))
        except Exception as e:  # parity: swallow + NaN (gsmvi/monitors.py:117-120)
            print(f"Exception occured in monitor : {e}.\nAppending NaN")
            del self.rkl[n_rkl:], self.fkl[n_fkl:]
            self.rkl.append(float("nan"))
            self.fkl.append(float("nan"))
        if self.store_params:
            self.params_trace.append((np.asarray(mean), np.asarray(cov)))
        self.nevals.append(self.offset_evals + nevals)
        self.offset_evals = self.nevals[-1]
        return key
