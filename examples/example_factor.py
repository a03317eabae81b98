"""Factor-state fitters: no D x D factorization in the hot loop.

``FactorGSM`` (method="eps") and ``FactorBaM`` keep the variational state as
(mean, F) with S = F F^T.  Because samples are drawn from the maintained
factor, the rank-structured covariance updates are known in factor
coordinates for free — the hot loop contains no Cholesky, no eigh, no sqrtm
of anything D-sized (see ops/gsm_eps.py and ops/bam_eps.py for the math).

Run: PYTHONPATH=. JAX_PLATFORMS=cpu python examples/example_factor.py
"""

import jax
import numpy as np

from gsmvi_jax import FactorBaM, FactorGSM, Regularizers
from gsmvi_jax.models import dense_gaussian

if __name__ == "__main__":
    D = 32
    target = dense_gaussian(jax.random.PRNGKey(7), D)

    fg = FactorGSM(D=D, lp=target.lp, lp_g=target.lp_g)
    state = fg.fit(jax.random.PRNGKey(99), niter=1000, batch_size=32,
                   verbose=False, return_state=True)
    print("FactorGSM  mean err:",
          float(np.abs(np.asarray(state.mean) - np.asarray(target.mean)).max()),
          f" accepted {int(state.n_accepted)}/{int(state.step)}")

    fb = FactorBaM(D=D, lp=target.lp, lp_g=target.lp_g)
    mean, cov = fb.fit(jax.random.PRNGKey(99),
                       regf=Regularizers().linear(100.0), niter=500,
                       batch_size=32, verbose=False)
    print("FactorBaM  mean err:",
          float(np.abs(np.asarray(mean) - np.asarray(target.mean)).max()))
    print("FactorBaM  cov err :",
          float(np.abs(np.asarray(cov) - np.asarray(target.cov)).max()))
