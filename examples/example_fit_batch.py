"""K independent fits in one compiled program (vmapped replicas).

No reference equivalent: this batches whole fits — K random-restart
replicas (or per-replica warm starts) whose small per-step matmuls batch
into ops large enough to fill the device.

``GSM(use_factor=True)`` delegates this to ``FactorGSM.fit_batch`` (the
batched eps-coordinate step, with a matmul-only Newton-Schulz small space
by default).

Run: python examples/example_fit_batch.py
"""

import jax
import numpy as np

from gsmvi_jax import GSM
from gsmvi_jax.models import dense_gaussian

if __name__ == "__main__":
    D, K = 16, 8
    target = dense_gaussian(jax.random.PRNGKey(3), D)

    gsm = GSM(D=D, lp=target.lp, lp_g=target.lp_g)
    keys = jax.random.split(jax.random.PRNGKey(99), K)
    means, covs = gsm.fit_batch(keys, niter=500, batch_size=8)

    errs = np.abs(np.asarray(means) - np.asarray(target.mean)).max(axis=1)
    print(f"{K} replicas fit in one compiled program")
    print("per-replica max |mean error|:", np.round(errs, 5))
    print("replica spread (MC noise)   :", float(errs.std()))
